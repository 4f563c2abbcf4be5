"""On the card (marker ``card``; skipped without one): the prepared align
(``core.gn.PreparedLoop``, through the solver's slot) against a fresh
slot's align (``models._fused.fused_voxel_align`` /
``models._point_fused.fused_point_align`` with a new ``core.gn.LoopSlot``:
a plan made for that align alone) on the same inputs, the state's words bit
for bit, and so T and the diagnostics; and against the host loop
(``core.gn.gauss_newton`` over the same stats kernel, ``tests/host_loop.py``):
equal iterations and flags, T within ``TOL_HOST``. For VPlaneICP, NDT,
PlaneICP and ICP on their dense or packed targets, both voxel kinds on a
hashed map and both point kinds on a grid target. Two scans go through one
plan, then the first again.

This file imports no JAX, so it runs where the JAX package is not installed::

    python -m pytest tests/test_torch_gn_plan_card.py -m card --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.models import _fused, _point_fused, pad_points
from point_cloud_registration_tpu_torch.ops import voxelize
import host_loop
from oracles import make_scan, make_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# case -> (solver, layout): the single-align paths of the four solvers
CASES = {
    "vplane": (pt.VPlaneICP, "dense"),
    "ndt": (pt.NDT, "dense"),
    "plane_icp": (pt.PlaneICP, "packed"),
    "icp": (pt.ICP, "packed"),
    "vplane_hashed": (pt.VPlaneICP, "hashed"),
    "ndt_hashed": (pt.NDT, "hashed"),
    "icp_grid": (pt.ICP, "grid"),
    "plane_icp_grid": (pt.PlaneICP, "grid"),
}
OFFSETS = [[0.1, -0.08, 0.2, 0.02, -0.02, 0.03], [-0.05, 0.06, -0.1, -0.01, 0.015, -0.02]]
# the loop kernel against the host loop over the same stats kernel: both sum
# the block rows in double, the host's update rounds as the kernel's (T
# within chip_smoke.py's TOL_LOOP)
TOL_HOST = 1e-5


@pytest.fixture(scope="module")
def device():
    """The card; skips the module's tests where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene():
    """A 400k-point room and two 100k-point scans of it (one padded length)."""
    rng = np.random.RandomState(3)
    points = make_scene(rng, n_floor=200_000, n_wall=100_000).astype(np.float32)
    scans = [make_scan(np.random.RandomState(20 + i), points, np.array(dx), n_points=100_000)[0]
             for i, dx in enumerate(OFFSETS)]
    return points, scans


def _solver(case, points, device):
    cls, layout = CASES[case]
    s = cls(device=device)
    if cls in (pt.ICP, pt.PlaneICP):
        s.cfg = dataclasses.replace(s.cfg, corr=pt.CorrespondenceConfig(method=layout))
        if layout == "grid":
            points = points[::20]  # a small target, as the grid method serves
    with pytest.MonkeyPatch.context() as mp:
        if layout == "hashed":
            mp.setattr(voxelize, "DENSE_CELL_BUDGET", 1)
        s.set_target(points)
    return s


def _unprepared(s, src, w):
    """``(words, T, diagnostics)`` of the align through a fresh slot: a plan
    made for it alone."""
    target, T0, slot = s._target, torch.eye(4), gn.LoopSlot()
    if isinstance(s, (pt.VPlaneICP, pt.NDT)):
        kind = "plane" if isinstance(s, pt.VPlaneICP) else "ndt"
        T, d = _fused.fused_voxel_align(target, src, w, T0, s.cfg, kind, slot=slot)
    elif isinstance(s, pt.PlaneICP):
        T, d = _point_fused.fused_point_align(target.corr, src, w, T0, s.cfg, "plane_pt",
                                              target.normals, slot=slot)
    else:
        T, d = _point_fused.fused_point_align(target, src, w, T0, s.cfg, "point", slot=slot)
    return slot.plan.read.clone(), T, d


def _bits(x):
    x = torch.as_tensor(x)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
def test_prepared_align_is_the_unprepared_one_bit_for_bit(device, scene, case):
    points, scans = scene
    s = _solver(case, points, device)
    builds, reuses = gn.PreparedLoop.builds, gn.PreparedLoop.reuses
    for scan in scans + scans[:1]:
        src, w = pad_points(scan, device=device)
        want, T_want, d_want = _unprepared(s, src, w)
        T = torch.as_tensor(s.align(scan), dtype=torch.float32)
        d = s.last_diagnostics
        got = s._loop.plan.read
        assert torch.equal(got, want), (case, (got != want).nonzero().flatten().tolist())
        assert torch.equal(_bits(T), _bits(T_want))
        for f in d._fields:
            x, y = getattr(d, f), getattr(d_want, f)
            assert torch.equal(_bits(x), _bits(y)) if isinstance(x, torch.Tensor) else x == y, f
        T_host, d_host = host_loop.solver_align(s, scan)
        dT = float((T - T_host).abs().max())
        print(case, src.shape[0], "points:", d.iterations, "iterations, converged", d.converged,
              "; host loop: max |dT|", dT)
        assert (d.iterations, d.converged, d.solver_failed) == (
            d_host.iterations, d_host.converged, d_host.solver_failed)
        assert dT <= TOL_HOST
        assert 1 <= d.iterations and not d.solver_failed
    # the solver's plan made once and kept; a fresh slot's made each align
    assert (gn.PreparedLoop.builds, gn.PreparedLoop.reuses) == (builds + 1 + 3, reuses + 2)
