"""Device time of the kernels of one ``set_target``."""

from perfbench.trace import is_kernel


def read(ctx):
    spans = ctx.trace.spans_named("pb.set_target")
    if not spans:
        return None
    t = sum(d[2] - d[1] for _, a, b in spans for d in ctx.trace.ops_in(a, b) if is_kernel(d[0]))
    return 1e3 * t / len(spans)
