"""Mean align wall less the time inside it that the device was busy: the
host's part of an align, its wait for the card excluded."""


def read(ctx):
    spans = ctx.trace.spans_named("pb.align")
    if not spans:
        return None
    return 1e3 * sum((b - a) - ctx.trace.busy(a, b) for _, a, b in spans) / len(spans)
