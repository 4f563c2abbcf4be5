"""One Gauss-Newton update of B problems, on the device of their state (the
loop body of ``point_cloud_registration_tpu/core/gn.py::gauss_newton`` and
of ``models/_fused.py::batched_gauss_newton``, which XLA compiles; no Pallas
kernel stands behind them).

A resident Gauss-Newton loop keeps each problem's pose, counters, flags and
histories in a :class:`GNState` on the data's device, from the align's first
launch to its last. After each stats launch, :func:`gn_step` solves the 6x6
normal equations, tests the step, updates the pose and writes the histories
for every problem that is not done; a problem that is done is left as it is.

For CUDA tensors it launches the hand-written kernel of ``csrc/gn_step.cu``;
for CPU tensors it runs the plain PyTorch version, :func:`gn_step_reference`,
which the tests and ``chip_smoke.py`` also call directly. There is no
fallback between the two.

The state, :class:`~point_cloud_registration_tpu_torch.core.gn.GNState`, is
the loop's (``core/gn.py``): one int32 buffer whose pose rows are the
layout the stats kernels read.
"""

from __future__ import annotations

import ctypes
import functools

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
from point_cloud_registration_tpu_torch.ops.kernels._build import load_library

__all__ = ["gn_step", "gn_step_reference", "gn_stepper"]

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
    """Plain PyTorch version of :func:`gn_step`, on CPU tensors: the same
    update of ``state`` in place, with the host loops' operations
    (``core.gn.solve_6x6_batched``, ``step_norm``, ``se3.plus`` on each
    problem's (4, 4) transform), so that a loop over it is ``gauss_newton``'s
    and ``batched_gauss_newton``'s bit for bit."""
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


@functools.cache
def _kernel_fn():
    fn = load_library("gn_step").pcr_gn_step
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [c_ptr] * 11 + [c_int, c_int, ctypes.c_float, c_ptr]
    fn.restype = c_int
    return fn


def gn_stepper(state: GNState, tol: float):
    """``step(stats, dx=None)``: :func:`gn_step` of ``state`` with ``tol``,
    the state's arguments bound once (the resident loop's step). CPU states
    take :func:`gn_step_reference`; CUDA states launch the kernel on the
    stream current now."""
    dev = state.words.device
    if dev.type == "cpu":
        return lambda stats, dx=None: gn_step_reference(stats, state, tol, dx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, M = state.e2.shape
    fn = _kernel_fn()
    bound = [x.data_ptr() for x in state[1:]]
    tail = (B, M, float(tol), torch.cuda.current_stream(dev).cuda_stream)

    def step(stats: torch.Tensor, dx: torch.Tensor | None = None) -> None:
        stats = stats.reshape(B, STATS_WIDTH)
        _check(stats, state)
        if not stats.is_contiguous():
            raise ValueError("stats must be contiguous")
        if dx is not None and (dx.device != dev or dx.dtype != torch.float32
                               or tuple(dx.shape) != (B, 6) or not dx.is_contiguous()):
            raise ValueError(f"dx must be a contiguous float32 ({B}, 6) tensor on {dev}")
        rc = fn(stats.data_ptr(), *bound, dx.data_ptr() if dx is not None else None, *tail)
        if rc != 0:
            raise RuntimeError(f"gn_step kernel launch failed: CUDA error {rc}")
        gn_step.launches += 1

    return step


def gn_step(stats: torch.Tensor, state: GNState, tol: float,
            dx: torch.Tensor | None = None) -> None:
    """One Gauss-Newton update of every problem of ``state`` that is not
    done, from its packed ``stats`` (B, 29) (or (29,) for one problem), in
    place on the state's device.

    ``dx`` (B, 6) float32, when given, receives each updated problem's step.
    CPU tensors take :func:`gn_step_reference`; CUDA tensors launch the
    kernel on the current stream and add one to ``gn_step.launches``. It
    never waits for the card.
    """
    if stats.device != state.words.device:
        raise ValueError(f"stats on {stats.device}, state on {state.words.device}")
    gn_stepper(state, tol)(stats.contiguous(), dx)


gn_step.launches = 0
