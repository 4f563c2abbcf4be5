"""Kernels launched per ``set_target``: a count that repeats exactly."""

from perfbench.trace import is_kernel


def read(ctx):
    spans = ctx.trace.spans_named("pb.set_target")
    if not spans:
        return None
    n = sum(1 for _, a, b in spans for d in ctx.trace.ops_in(a, b) if is_kernel(d[0]))
    return n / len(spans)
