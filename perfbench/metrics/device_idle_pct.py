"""Share of the traced window with no kernel, copy or set on the card."""


def read(ctx):
    if not ctx.trace.spans:
        return None
    lo, hi = ctx.trace.window
    return 100.0 * (1.0 - ctx.trace.busy(lo, hi) / (hi - lo))
