"""The end-to-end arithmetic and the roofline yardstick, by hand."""

from __future__ import annotations

import pytest

from perfbench import stats
from perfbench.metrics import _roofline


def test_p95_is_a_nearest_rank_percentile():
    assert stats.p95(range(1, 101)) == 95
    assert stats.p95([5.0]) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2


def test_a_stall_shows_in_the_tail_and_the_rate():
    steady = [0.001] * 95
    assert stats.p95(steady + [0.5] * 5) == 0.001  # 5 % of stalls sit beyond the p95
    assert stats.p95(steady + [0.5] * 6) == 0.5
    # the rate is over all the work and all the time, the stall included
    window = sum(steady) + 0.5
    assert stats.rate(96, window) == pytest.approx(96 / 0.595)


def test_no_latencies_is_an_error():
    with pytest.raises(ValueError):
        stats.p95([])


def test_bound_ms_by_hand():
    assert _roofline.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert _roofline.bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")
    # 1e6 distances and 1e5 plane rows: 8e6 + 9.2e6 flops, 2.567e-4 ms;
    # 1 MB read once: 2.985e-4 ms, so the bytes bind
    counts = {"distances": 1_000_000, "linearizations": 100_000, "bytes": 1_000_000}
    assert _roofline.loop_bound_ms(counts) == pytest.approx(1e3 * 1e6 / 3.35e12)
    counts["distances"] = 10_000_000
    assert _roofline.loop_bound_ms(counts) == pytest.approx(1e3 * (8e7 + 9.2e6) / 67e12)


def test_loop_kernel_is_read_by_name_whatever_the_clocks():
    """The loop kernel's device time per align, from every launch in the
    trace, also where the device's clock places it outside its align."""
    from perfbench import trace as tr
    from perfbench.metrics import loop_kernel_ms, loop_roofline_pct

    spans = [("pb.align", 0.0, 1.0), ("pb.align", 2.0, 3.0)]
    device = [("void pcr::gn_loop_kernel<Fused>", 1.05, 1.15), ("Memcpy HtoD", 0.1, 0.2),
              ("void pcr::gn_loop_kernel<Fused>", 2.5, 2.6)]
    ctx = tr.Context(trace=tr.Trace(spans=spans, device=device), iterations=[4, 5],
                     loop_kernel="gn_loop_kernel", bound_ms=1.0)
    assert loop_kernel_ms.read(ctx) == pytest.approx(100.0)
    assert loop_roofline_pct.read(ctx) == pytest.approx(1.0)
    ctx.loop_kernel = "no such kernel"
    assert loop_kernel_ms.read(ctx) is None and loop_roofline_pct.read(ctx) is None


def test_traced_p95_reads_the_traced_requests_tail():
    """``reg_p95_traced_ms``: the nearest-rank p95 of the traced requests'
    latencies; nothing to read, no number."""
    from perfbench import trace as tr
    from perfbench.metrics import reg_p95_traced_ms

    ctx = tr.Context(trace=tr.Trace(spans=[], device=[]), iterations=[],
                     loop_kernel="gn_loop_kernel", latencies_ms=[30.0] * 23 + [90.0])
    assert reg_p95_traced_ms.read(ctx) == 30.0
    ctx.latencies_ms = [30.0] * 22 + [90.0] * 2
    assert reg_p95_traced_ms.read(ctx) == 90.0
    ctx.latencies_ms = []
    assert reg_p95_traced_ms.read(ctx) is None
