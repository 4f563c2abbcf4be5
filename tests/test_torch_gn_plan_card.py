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

The scan slot (``models.base.ScanSlot``, the solver's ``_scan``) on the four
solvers of the benchmark's ``track`` cells (VPlaneICP, NDT, PlaneICP packed,
ICP packed):
scans of two lengths in one bucket, as float32 and float64 NumPy and as card
tensors, back to back through one slot and one plan, each align's state words
bit for bit the align on ``pad_points``'s tensors; an align that raised after
its scan's copy, then a correct align.

This file imports no JAX, so it runs where the JAX package is not installed::

    python -m pytest tests/test_torch_gn_plan_card.py -m card --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.models import ScanSlot, _fused, _point_fused, pad_points
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


TRACK = ["vplane", "ndt", "plane_icp", "icp"]  # the solvers of the benchmark's track cells


def _scan_inputs(scans, device):
    """Back to back: each scan, a shorter one in the same bucket, float64
    NumPy and card tensors among them, then the first scan again."""
    a, b = scans
    short = b[:99_000]  # 100,000 and 99,000 points: one padded length, 106,496
    return [a, b, short, a.astype(np.float64), torch.from_numpy(b).to(device),
            torch.from_numpy(short.astype(np.float64)).to(device), a]


def _held_to_pad_points(s, scan, device):
    """The solver's align of ``scan`` through its slot and plan against the
    align on ``pad_points``'s tensors: the state words, T and the
    diagnostics bit for bit; and the slot's tensors ``pad_points``'s."""
    T = torch.as_tensor(s.align(scan), dtype=torch.float32)
    got, d = s._loop.plan.read.clone(), s.last_diagnostics
    src, w = pad_points(scan, device=device)
    want, T_want, d_want = _unprepared(s, src, w)
    assert torch.equal(got, want), (got != want).nonzero().flatten().tolist()
    assert torch.equal(_bits(T), _bits(T_want))
    for f in d._fields:
        x, y = getattr(d, f), getattr(d_want, f)
        assert torch.equal(_bits(x), _bits(y)) if isinstance(x, torch.Tensor) else x == y, f
    assert torch.equal(s._scan.src.view(torch.int32), src.view(torch.int32))
    assert torch.equal(s._scan.w, w)
    return T


@pytest.mark.card
@pytest.mark.parametrize("case", TRACK)
def test_scan_slot_align_is_the_pad_points_align_bit_for_bit(device, scene, case):
    points, scans = scene
    s = _solver(case, points, device)
    builds, reuses = ScanSlot.builds, ScanSlot.reuses
    Ts, slot = [], None
    for scan in _scan_inputs(scans, device):
        Ts.append(_held_to_pad_points(s, scan, device))
        slot = slot or s._scan
        assert s._scan is slot and s._loop.plan.launch.args[s._loop.plan.launch.scan_at] == (
            slot.src.data_ptr())
    # each scan its own result: none staged stale
    assert not torch.equal(Ts[0], Ts[1]) and not torch.equal(Ts[1], Ts[2])
    assert torch.equal(Ts[0], Ts[3]) and torch.equal(Ts[1], Ts[4]) and torch.equal(Ts[0], Ts[6])
    assert (ScanSlot.builds, ScanSlot.reuses) == (builds + 1, reuses + 6)
    print(case, "slot: T of the two scans", Ts[0][:3, 3].tolist(), Ts[1][:3, 3].tolist())


@pytest.mark.card
@pytest.mark.parametrize("case", TRACK)
def test_scan_slot_align_after_one_that_raised(device, scene, case, monkeypatch):
    """The loop's launch raises once after the scan's copy was issued
    behind a long kernel (the copy still in flight); the next align, of
    the other scan, is the ``pad_points`` align bit for bit."""
    points, scans = scene
    s = _solver(case, points, device)
    _held_to_pad_points(s, scans[0], device)
    plan = s._loop.plan

    def refused(src, w):
        raise RuntimeError("the launch failed")

    monkeypatch.setattr(plan.launch, "run", refused)
    torch.cuda._sleep(50_000_000)  # about 25 ms of the card's clock ahead of the copy
    with pytest.raises(RuntimeError, match="the launch failed"):
        s.align(scans[0])
    assert not s._scan.sent.query()
    monkeypatch.undo()
    _held_to_pad_points(s, scans[1], device)
    assert s._loop.plan is plan
