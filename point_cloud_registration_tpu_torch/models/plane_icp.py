"""Point-to-plane ICP (counterpart of
``point_cloud_registration_tpu/models/plane_icp.py``).

Objective ``sum_i (n_i^T (T p_i - q_i))^2`` against the target's k-NN PCA
normals, the reference solver at plane_icp.py:13-69. Correspondences are
gated raw-point 1-NN as in ICP; the residual is the projection on the
matched point's normal. On a packed target (50k points and more) the normal
rides in the packed rows beside the point, queries beyond the packed tier's
exactness radius take the proxy voxel's centroid and plane, and each
Gauss-Newton iteration is one launch of the "plane_pt" stats kernel; a
smaller target takes the grid method and one launch of the grid "plane_pt"
stats kernel (``models/_point_fused.py``). Either way ``set_target`` estimates the
normals through the k-NN moments kernel (``ops/normals.py``) unless they are
given (plane_icp.py:19-28), so that alignment is timed apart from normal
estimation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from point_cloud_registration_tpu_torch.core.config import PlaneICPConfig
from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.models._point_corr import (
    PointCorrTarget,
    build_point_corr,
)
from point_cloud_registration_tpu_torch.models._point_fused import (
    fused_point_align,
    fused_point_stats,
)
from point_cloud_registration_tpu_torch.models.base import AlignResult, Registration
from point_cloud_registration_tpu_torch.ops.normals import estimate_normals
from point_cloud_registration_tpu_torch.utils.diagnostics import span

__all__ = ["PlaneICP", "PlaneICPTarget", "build_plane_icp_target", "plane_icp_align",
           "plane_icp_stats"]


class PlaneICPTarget(NamedTuple):
    """Raw-point correspondence target + per-point normals."""

    corr: PointCorrTarget  # packed rows of width 6 (xyz + normal), proxy with normals
    normals: torch.Tensor  # (N, 3) f32


def build_plane_icp_target(points, cfg: PlaneICPConfig, *, normals=None,
                           device=None) -> PlaneICPTarget:
    """Index the target and (unless ``normals`` is given) estimate its
    normals (``PlaneICP.set_target``, plane_icp.py:19-28). The proxy tier
    serves voxel planes, so its voxels need at least 3 points. Under a
    profiler the map's copy, the normals and the index are the spans
    ``pcr.build.upload``, ``pcr.build.normals`` and ``pcr.build.index``."""
    device = resolve_device(points, device)
    with span("pcr.build.upload"):
        points = torch.as_tensor(points).to(device=device, dtype=torch.float32)
    with span("pcr.build.normals"):
        if normals is None:
            normals = estimate_normals(points, k=cfg.k)
        normals = torch.as_tensor(normals).to(device=device, dtype=torch.float32)
    with span("pcr.build.index"):
        corr = build_point_corr(points, cfg.corr, cfg.max_dist, proxy_min_points=3,
                                proxy_normals=True, feats=normals)
    return PlaneICPTarget(corr=corr, normals=normals)


def plane_icp_stats(target: PlaneICPTarget, source: torch.Tensor, src_weight: torch.Tensor,
                    T: torch.Tensor, cfg: PlaneICPConfig):
    """Correspondence + plane linearization + reduction for one GN iteration
    (plane_icp.py:30-69) -> GNStats on the host."""
    return fused_point_stats(target.corr, source, src_weight, T, cfg, "plane_pt",
                             target.normals)


def plane_icp_align(target: PlaneICPTarget, source: torch.Tensor, src_weight: torch.Tensor,
                    init_T, cfg: PlaneICPConfig) -> AlignResult:
    T, diag = fused_point_align(target.corr, source, src_weight, init_T, cfg, "plane_pt",
                                target.normals)
    return AlignResult(T=T, diagnostics=diag)


class PlaneICP(Registration):
    """Reference-compatible shim (constructor of plane_icp.py:14-17).

    As for :class:`ICP`, the default correspondence engine resolves to the
    packed method for targets of at least 50k points and to the CSR grid
    method below that.
    """

    def __init__(self, max_iter: int = 30, max_dist: float = 2, tol: float = 1e-3,
                 k: int = 15, huber_delta: float | None = None, *, device=None):
        super().__init__(max_iter=max_iter, tol=tol, device=device)
        self.max_dist = max_dist
        self.k = k
        self.cfg = PlaneICPConfig(
            max_iter=max_iter, max_dist=max_dist, tol=tol, k=k, huber_delta=huber_delta
        )

    def set_target(self, target, kdree=None, norm=None) -> None:
        """``kdree`` is accepted for signature parity (plane_icp.py:19) and
        unused: the grid index is rebuilt on the device. ``norm`` injects
        precomputed normals and skips their estimation."""
        del kdree
        with span("pcr.set_target"):
            self._target = build_plane_icp_target(target, self.cfg, normals=norm,
                                                  device=self.device)
        self.normal = self._target.normals  # attribute parity (plane_icp.py:23)

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        return plane_icp_align(target, source, src_weight, init_T, self.cfg)

    def _stats_fn(self, target, source, src_weight, T):
        return plane_icp_stats(target, source, src_weight, T, self.cfg)
