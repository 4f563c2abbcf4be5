"""The loop kernel's share of its roofline: the least time the card could
take for the loop's work (``metrics/_roofline.py``, from the reference's
counts) over the loop kernel's device time, in percent."""

from perfbench.metrics import loop_kernel_ms


def read(ctx):
    t = loop_kernel_ms.read(ctx)
    if t is None or ctx.bound_ms is None:
        return None
    return 100.0 * ctx.bound_ms / t
