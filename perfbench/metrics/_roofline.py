"""The yardstick of a kernel's roofline share: the published peaks of one
NVIDIA H100 SXM (dense float32 outside the tensor cores; HBM3), and the
least time the card could take for a piece of work, the larger of its
bytes over the bandwidth and its operations over the peak rate.

The counts come from the benchmark's plain reference (``counts`` of its
``register``): each input byte read once, and at each iteration's pose the
distances the correspondence search needs and one linearization per inlier.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Operations per distance (3 differences, 3 products, 2 sums) and per
# point-to-plane row (residual 5, R^T n and the cross product 24, the
# weighted 21 + 6 + 1 outer-product terms 2 each and their weights 7).
FLOPS_DIST = 8
FLOPS_PLANE_ROW = 92


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and what binds."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def loop_bound_ms(counts: dict) -> float:
    """The least time of one align's loop from the reference's counts."""
    flops = counts["distances"] * FLOPS_DIST + counts["linearizations"] * FLOPS_PLANE_ROW
    return bound_ms(counts["bytes"], flops)[0]
