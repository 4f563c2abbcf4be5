"""One Gauss-Newton update of B problems, in plain PyTorch (the loop body of
``point_cloud_registration_tpu/core/gn.py::gauss_newton`` and of
``models/_fused.py::batched_gauss_newton``, which XLA compiles; no Pallas
kernel stands behind them).

:func:`gn_step_reference` is the plain version of ``csrc/gn_step.cuh``'s
``gn_update``, which every loop kernel (``ops/kernels/gn_loop``) runs after
each iteration's stats: it solves the 6x6 normal equations, tests the step,
updates the pose and writes the histories of every problem of a
:class:`~point_cloud_registration_tpu_torch.core.gn.GNState` that is not
done; a problem that is done is left as it is. The loop kernels' plain
versions call it, and the tests and ``chip_smoke.py`` also call it directly.

``csrc/gn_step.cu`` builds the same update alone as a kernel. The package
launches none: ``chip_smoke.py`` steps its two-launch card reference with it
(phases 13-15): on the card a step can differ from the host loop's in its
last bit.
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.gn import (
    GNState,
    pose_rows_of,
    solve_6x6_batched,
    stats_from_packed,
    step_norm,
    transforms_of,
)
from point_cloud_registration_tpu_torch.core.se3 import plus

__all__ = ["gn_step_reference"]

STATS_WIDTH = 29


def _check(stats: torch.Tensor, state: GNState) -> None:
    B = state.it.shape[0]
    if stats.dtype != torch.float32 or tuple(stats.shape) != (B, STATS_WIDTH):
        raise ValueError(f"stats must be float32 ({B}, {STATS_WIDTH}), got {stats.dtype} "
                         f"{tuple(stats.shape)}")
    if stats.device != state.words.device:
        raise ValueError(f"stats on {stats.device}, state on {state.words.device}")


def gn_step_reference(stats: torch.Tensor, state: GNState, tol: float,
                      dx: torch.Tensor | None = None) -> None:
    """One Gauss-Newton update of every problem of ``state`` that is not
    done, from its packed ``stats`` (B, 29) (or (29,) for one problem), in
    place on CPU tensors, with the host loops' operations
    (``core.gn.solve_6x6_batched``, ``step_norm``, ``se3.plus`` on each
    problem's (4, 4) transform), so that a loop over it is ``gauss_newton``'s
    and ``batched_gauss_newton``'s bit for bit. ``dx`` (B, 6) float32, when
    given, receives each updated problem's step."""
    stats = stats.reshape(state.it.shape[0], STATS_WIDTH)
    _check(stats, state)
    B, M = state.e2.shape
    st = stats_from_packed(stats)
    steps = torch.from_numpy(solve_6x6_batched(st.H, st.g))
    norms = step_norm(steps)
    e2 = st.e2.to(torch.float32)
    inliers = st.n_inliers.to(torch.int32)
    for b in range(B):
        if int(state.done[b]):
            continue
        if dx is not None:
            dx[b] = steps[b]
        bad = not bool(torch.isfinite(norms[b]))
        converged_now = bool(norms[b] < tol)
        if not (converged_now or bad):
            T = plus(transforms_of(state.poses[b:b + 1])[0], steps[b])
            state.poses[b] = pose_rows_of(T[None])[0]
        at = min(max(int(state.it[b]), 0), M - 1)
        state.e2[b, at] = e2[b]
        state.dx_norm[b, at] = norms[b]
        state.inliers[b, at] = inliers[b]
        state.it[b] += 1
        state.failed[b] |= int(bad)
        state.converged[b] |= int(converged_now)
        state.final_e2[b] = e2[b]
        state.done[b] = int(converged_now or bad or int(state.it[b]) >= M)
