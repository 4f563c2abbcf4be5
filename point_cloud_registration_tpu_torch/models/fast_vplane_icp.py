"""Coreset-accelerated voxelized plane ICP (counterpart of
``point_cloud_registration_tpu/models/fast_vplane_icp.py``).

A working realization of the reference's experimental solver
(fast_voxelized_plane_icp.py:22-99): full-cloud Gauss-Newton until the step
shrinks below a switch threshold, then an exact Caratheodory coreset of the
linearization there (at most ``N_target`` weighted points that reproduce
H, g and e^2 exactly at the switch transform), and the remaining iterations
on the coreset.

* Phase 1 is the plain solver's align (``models/_fused.fused_voxel_align``:
  one launch of the loop kernel over the fused plane stats on a dense map)
  with the switch threshold as its tolerance; the switch reads its step-norm
  history from the state the loop returns.
* The lift runs on the host in float64 (exactness needs it,
  ``models/coreset.py``), from the per-point (J, r, w) of
  :func:`vplane_linearize` at phase 1's transform.
* Phase 2 (:func:`_phase2_align`) is the GN loop over the ``N_target``
  coreset within the remaining iteration budget: the plain solver's align
  again, one launch of the loop kernel (``fused_loop`` on a dense map,
  ``grid_loop`` on a hashed one) over ``N_target`` rows.

Phase 1 freezes T on its breaking step (the GN loop's contract) and the
lift runs at that transform; because the coreset reproduces H and g exactly
there, phase 2's first step is the step the reference applied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.config import VPlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import GNDiagnostics
from point_cloud_registration_tpu_torch.core.se3 import makeRt, skew_time_vector, transform_points
from point_cloud_registration_tpu_torch.models._fused import fused_voxel_align
from point_cloud_registration_tpu_torch.models.base import Registration, pad_points
from point_cloud_registration_tpu_torch.models.coreset import create_gn_set, fast_caratheodory
from point_cloud_registration_tpu_torch.models.voxelized_plane_icp import build_vplane_target
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap, query_nearest_voxel

__all__ = ["FastVPlaneICP", "vplane_linearize"]


def vplane_linearize(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                     T: torch.Tensor, cfg: VPlaneICPConfig):
    """The per-point plane linearization at ``T``: ``(J (N, 6), r (N,),
    w (N,))`` on the device of ``source`` (fast_voxelized_plane_icp.py:40-54).

    The nearest valid voxel within ``max_dist`` (``query_nearest_voxel``),
    ``r = n . (q - mu)``, ``J = [n, p x (R^T n)]`` and the weights gated on
    a match closer than ``max_dist``: the explicit form of what the fused
    kernel sums, which the coreset lift consumes point by point. Plain torch
    ops, as the JAX function is XLA.
    """
    T = torch.as_tensor(T, dtype=torch.float32).to(source.device)
    R, _ = makeRt(T)
    src_trans = transform_points(T, source)
    nn = query_nearest_voxel(vm, src_trans, voxel_size=cfg.voxel_size, max_dist=cfg.max_dist)
    w = src_weight * (nn.dist < cfg.max_dist) * (nn.idx >= 0)
    safe = nn.idx.clamp(0, vm.means.shape[0] - 1).to(torch.int64)
    means = vm.means[safe]
    norms = vm.normals[safe]
    r = torch.sum(norms * (src_trans - means), dim=-1)
    J = torch.cat([norms, skew_time_vector(source, norms @ R)], dim=-1)
    return J, r, w


def _phase2_align(vm: VoxelMap, src_sub: torch.Tensor, w_sub: torch.Tensor, init_T,
                  iters_left: int, cfg: VPlaneICPConfig) -> tuple[torch.Tensor, GNDiagnostics]:
    """GN on the coreset ``src_sub`` (N_target, 3) with its weights ``w_sub``
    from ``init_T``, for at most ``iters_left`` iterations (the JAX
    package's ``_phase2_align``, fast_vplane_icp.py:109-168).

    Its stats are the plane stats of the coreset weighted by ``w_sub``,
    which fold in the match and the ``dist < max_dist`` gate as the JAX
    loop's ``w_sub * (w_lin > 0)`` does. The whole loop is
    ``fused_voxel_align``'s with ``max_iter = iters_left``: one launch of the
    loop kernel (``gn_loop.fused_loop`` on a dense map, ``grid_loop`` on a
    hashed one) and one read, on the coreset's device, as the JAX phase 2 is
    one dispatch. The histories have length ``iters_left``.
    """
    return fused_voxel_align(vm, src_sub, w_sub, init_T,
                             dataclasses.replace(cfg, max_iter=iters_left), "plane")


class FastVPlaneICP(Registration):
    """Reference-compatible shim (fast_voxelized_plane_icp.py:23-30
    signature), plus the port's ``device``."""

    # Breakeven of the "auto" mode, in GN iterations left after the switch:
    # the host float64 lift against one full-cloud iteration, both linear in
    # the live points. 48 is the JAX package's value, measured on a v5e chip
    # (about 3 us a point for the lift, 63 ns a point for an iteration); it is
    # kept, so that "auto" picks what the JAX package picks. The H100's
    # figure is in PERF.md. At the reference's max_iter of 30 "auto" is plain
    # VPlaneICP.
    CORESET_BREAKEVEN_ITERS = 48

    def __init__(
        self,
        voxel_size: float = 1.0,
        max_iter: int = 30,
        max_dist: float = 2,
        tol: float = 1e-3,
        N_target: int = 1024,
        debug: bool = False,
        coreset_switch: float = 1e-2,
        coreset_clusters: int = 64,
        coreset: str = "auto",
        *,
        device=None,
    ):
        super().__init__(max_iter=max_iter, tol=tol, device=device)
        if coreset not in ("auto", "always", "never"):
            raise ValueError(f"unknown coreset mode {coreset!r}")
        self.voxel_size = voxel_size
        self.max_dist = max_dist
        self.N_target = N_target
        self.debug = debug
        self.coreset_switch = coreset_switch  # switch heuristic (ref :63, 1e-2)
        self.coreset_clusters = coreset_clusters  # ref :34 (k=64)
        self.coreset_mode = coreset
        self.cfg = VPlaneICPConfig(
            voxel_size=voxel_size, max_iter=max_iter, max_dist=max_dist, tol=tol
        )

    def set_target(self, target) -> None:
        self._target = build_vplane_target(target, self.cfg, device=self.device)

    def _phase1(self, src, w_src, T0, cfg1) -> tuple[torch.Tensor, GNDiagnostics]:
        return fused_voxel_align(self._target, src, w_src, T0, cfg1, slot=self._loop)

    def align(self, source, init_T=None, verbose: bool = False) -> np.ndarray:
        if not self.is_target_set():
            raise ValueError("Target is not set.")
        if init_T is None:
            init_T = np.eye(4)
        src, w_src = pad_points(source, device=self.device)
        T0 = torch.as_tensor(init_T, dtype=torch.float32)

        # Phase 1: full-cloud GN to the switch threshold. In "auto" (below the
        # breakeven) and "never" it runs at the true tolerance: plain VPlaneICP.
        may_engage = self.coreset_mode == "always" or (
            self.coreset_mode == "auto" and self.max_iter > self.CORESET_BREAKEVEN_ITERS
        )
        switch = max(self.coreset_switch, self.tol) if may_engage else self.tol
        T1, diag1 = self._phase1(src, w_src, T0, dataclasses.replace(self.cfg, tol=switch))
        iters1 = diag1.iterations
        iters_left = self.max_iter - iters1

        def finish(T, diag):
            self.last_diagnostics = diag
            if verbose or self.debug:
                for i in range(int(diag.iterations)):
                    print(f"iter {i}, points {int(diag.inlier_history[i])}, "
                          f"error {float(diag.e2_history[i])}")
            return T.numpy().astype(np.float64)

        # No coreset, no budget left, a failure, the true tolerance reached
        # already, or the switch never reached: phase 1's answer stands (the
        # reference switches only once the step has shrunk below the threshold).
        reached_switch = diag1.converged and not diag1.solver_failed
        true_converged = iters1 > 0 and float(diag1.dx_norm_history[iters1 - 1]) < self.tol
        if not may_engage or iters_left <= 0 or not reached_switch or true_converged:
            return finish(T1, diag1)

        # The float64 Caratheodory lift on the host, at the frozen switch transform.
        J, r, w = (x.cpu().numpy() for x in vplane_linearize(self._target, src, w_src, T1,
                                                              self.cfg))
        live = np.where(w > 0)[0]
        if len(live) == 0:
            return finish(T1, diag1)
        P = create_gn_set(J[live], r[live])
        _, w_core, sel = fast_caratheodory(P, w[live].astype(np.float64),
                                           self.coreset_clusters, self.N_target)
        chosen = live[sel]
        src_np = src.cpu().numpy()[chosen]
        pad = self.N_target - len(chosen)
        if pad > 0:
            src_np = np.vstack([src_np, np.zeros((pad, 3), np.float32)])
            w_core = np.concatenate([w_core, np.zeros(pad)])

        # Phase 2: the coreset GN within the remaining budget.
        T2, diag2 = _phase2_align(
            self._target, torch.from_numpy(src_np.astype(np.float32)).to(src.device),
            torch.from_numpy(w_core.astype(np.float32)).to(src.device), T1, iters_left,
            self.cfg,
        )
        it2 = diag2.iterations
        iterations = iters1 + it2
        e2_hist = torch.zeros(self.max_iter, dtype=torch.float32)
        dxn_hist = torch.zeros(self.max_iter, dtype=torch.float32)
        inl_hist = torch.zeros(self.max_iter, dtype=torch.int32)
        for hist, h1, h2 in ((e2_hist, diag1.e2_history, diag2.e2_history),
                             (dxn_hist, diag1.dx_norm_history, diag2.dx_norm_history),
                             (inl_hist, diag1.inlier_history, diag2.inlier_history)):
            hist[:iters1] = h1[:iters1]
            hist[iters1:iterations] = h2[:it2]
        diag = GNDiagnostics(
            iterations=iterations,
            converged=diag2.converged,
            solver_failed=diag2.solver_failed,
            e2_history=e2_hist,
            dx_norm_history=dxn_hist,
            inlier_history=inl_hist,
            final_e2=diag2.final_e2 if it2 > 0 else diag1.final_e2,
        )
        return finish(T2, diag)
