"""The host loop of an align: ``core.gn.gauss_newton`` (the stats copied to
the host each iteration, the solve and the update there) over the public
host stats of the align's path, ``models._fused.fused_voxel_stats`` or
``models._point_fused.fused_point_stats``, on the same target and padded
scan. It is the plain reference that the tests hold the aligns' loops to:
on the CPU both run the same plain stats and the same operations, so their
results are equal bit for bit.
"""

import torch

from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.models import _fused, _point_fused, pad_points


def voxel_align(vm, src, w, init_T, cfg, kind="plane"):
    """``(T, diagnostics)`` of ``models._fused.fused_voxel_align``'s
    arguments through the host loop."""
    return gn.gauss_newton(lambda T: _fused.fused_voxel_stats(vm, src, w, T, cfg, kind),
                           init_T, cfg.max_iter, cfg.tol)


def point_align(target, src, w, init_T, cfg, kind="point", normals=None):
    """``(T, diagnostics)`` of ``models._point_fused.fused_point_align``'s
    arguments through the host loop."""
    return gn.gauss_newton(
        lambda T: _point_fused.fused_point_stats(target, src, w, T, cfg, kind, normals),
        init_T, cfg.max_iter, cfg.tol)


def solver_align(solver, scan, init_T=None):
    """``(T, diagnostics)`` of ``solver.align(scan, init_T)`` through the
    host loop: the solver's own stats (``_stats_fn``, the stats of
    ``calc_H_g_e2``) on its target and the scan padded as ``align`` pads it;
    T as a float32 CPU tensor."""
    src, w = pad_points(scan, device=solver.device)
    T0 = torch.eye(4) if init_T is None else torch.as_tensor(init_T, dtype=torch.float32)
    return gn.gauss_newton(lambda T: solver._stats_fn(solver._target, src, w, T), T0,
                           solver.cfg.max_iter, solver.cfg.tol)
