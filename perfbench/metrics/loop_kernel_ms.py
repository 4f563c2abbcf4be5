"""Device time of the loop kernel (the whole Gauss-Newton loop of one
align) per align: every launch of it in the traced window, found by the
kernel's name, over the aligns. Taken by name and not by the host span
around each launch, since the trace can place the device's clock a
fraction of a millisecond off the host's."""


def read(ctx):
    aligns = len(ctx.trace.spans_named("pb.align"))
    t = sum(b - a for name, a, b in ctx.trace.device if ctx.loop_kernel in name)
    return 1e3 * t / aligns if aligns and t > 0 else None
