"""The nearest-rank 95th percentile of the traced requests' latencies, from
the call with NumPy inputs in hand to the NumPy T (the profiler on, a
``set_target`` closed by a synchronize): ``reg_p95_ms`` read per layer in a
cell whose whole-window tail spreads too widely from run to run to hold an
end-to-end bound."""

from perfbench import stats


def read(ctx):
    return stats.p95(ctx.latencies_ms) if ctx.latencies_ms else None
