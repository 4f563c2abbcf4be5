"""Mean host wall of ``align``, from NumPy in to the NumPy T."""


def read(ctx):
    spans = ctx.trace.spans_named("pb.align")
    return 1e3 * sum(b - a for _, a, b in spans) / len(spans) if spans else None
