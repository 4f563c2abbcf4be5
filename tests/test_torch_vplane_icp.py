"""Port parity of the whole slice: VPlaneICP ``set_target`` + ``align`` of
point_cloud_registration_tpu_torch against the JAX package's fused align
(Pallas kernel in interpret mode) on the scenes of tests/test_vpicp.py.

Tolerances: final T within 1e-3 of JAX's (the port builds its own map, so
the maps agree to float32 rounding, not bit for bit), equal iteration counts
and equal ``converged``; H/g/e2 within 2e-3 per inlier of the float64 oracle
(the bound of tests/test_vpicp.py).
"""

import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxConfig
from point_cloud_registration_tpu.models._fused import fused_voxel_align
from point_cloud_registration_tpu.ops.pallas.fused_align import voxel_fused_spec
from point_cloud_registration_tpu.ops.voxelize import build_voxel_map
from point_cloud_registration_tpu_torch import VPlaneICP
from point_cloud_registration_tpu_torch.core.config import VPlaneICPConfig
from point_cloud_registration_tpu_torch.models import pad_points, vplane_align
from point_cloud_registration_tpu_torch.utils.convert import voxel_map_from_numpy
from oracles import gn_align_np, make_scan, make_scene, voxel_map_np, vplane_stats_np

PARAMS = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)

# (scan seed, 6-dof offset); the first two are the scans of tests/test_vpicp.py
SCANS = {
    "small_offset": (7, [0.02, -0.02, 0.04, 0.008, -0.01, 0.012]),
    "large_offset": (8, [0.1, -0.08, 0.2, 0.02, -0.02, 0.03]),
}


@pytest.fixture(scope="module")
def scene():
    pts = make_scene(np.random.RandomState(5))
    jm = build_voxel_map(pts, 1.0, min_points=10, rich="normals")
    return pts, jm


def _jax_align(jm, scan):
    cfg = JaxConfig(**PARAMS)
    spec = voxel_fused_spec(jm, "plane", max_dist=cfg.max_dist)
    w = jnp.ones((len(scan),), jnp.float32)
    T, diag = fused_voxel_align(jm, scan, w, jnp.eye(4, dtype=jnp.float32), cfg, spec,
                                interpret=True)
    return np.asarray(T), int(diag.iterations), bool(diag.converged)


@pytest.mark.parametrize("scan_name", sorted(SCANS))
def test_slice_matches_jax_fused_align(scene, scan_name):
    pts, jm = scene
    seed, dx = SCANS[scan_name]
    scan, _ = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    T_j, it_j, conv_j = _jax_align(jm, scan)
    vp = VPlaneICP(**PARAMS, device="cpu")
    vp.set_target(pts)
    T_t = vp.align(scan)
    d = vp.last_diagnostics
    assert T_t.dtype == np.float64 and T_t.shape == (4, 4)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-3)
    assert d.iterations == it_j
    assert d.converged == conv_j
    assert not d.solver_failed
    assert d.e2_history.shape == (PARAMS["max_iter"],)


def test_align_on_carried_map_matches_jax(scene):
    """With the identical (carried) map, T agrees far inside the 1e-3 bound."""
    pts, jm = scene
    scan, _ = make_scan(np.random.RandomState(7), pts, np.array(SCANS["small_offset"][1]))
    T_j, it_j, _ = _jax_align(jm, scan)
    tm = voxel_map_from_numpy(jm.means, jm.covs, jm.normals, jm.counts, jm.valid,
                              jm.grid.origin_cell, jm.grid.dims, jm.grid.cell_size,
                              device="cpu")
    src, w = pad_points(scan)
    res = vplane_align(tm, src, w, torch.eye(4), VPlaneICPConfig(**PARAMS))
    np.testing.assert_allclose(res.T.numpy(), T_j, rtol=0, atol=1e-4)
    assert res.diagnostics.iterations == it_j


def test_align_recovers_transform_like_oracle(scene):
    pts, _ = scene
    scan, T_true = make_scan(np.random.RandomState(8), pts, np.array(SCANS["large_offset"][1]))
    vp = VPlaneICP(**PARAMS, device="cpu")
    vp.set_target(pts)
    T_est = vp.align(scan)
    assert np.abs(T_est @ T_true - np.eye(4)).max() < 0.05
    means, _, normals, _ = voxel_map_np(pts, 1.0, min_points=10)
    T_ref, _ = gn_align_np(
        lambda T: vplane_stats_np(means, normals, scan, T, 2.0), max_iter=30, tol=1e-3
    )
    np.testing.assert_allclose(T_est, T_ref, atol=5e-3)


def test_calc_H_g_e2_matches_oracle(scene):
    pts, _ = scene
    vp = VPlaneICP(voxel_size=1.0, max_iter=10, max_dist=2.0, tol=1e-3, device="cpu")
    vp.set_target(pts)
    scan, _ = make_scan(np.random.RandomState(6), pts,
                        np.array([0.03, -0.02, 0.05, 0.01, 0.0, -0.01]))
    H1, g1, e2_1 = vp.calc_H_g_e2(np.eye(4), scan)
    means, _, normals, _ = voxel_map_np(pts, 1.0, min_points=10)
    H2, g2, e2_2, n = vplane_stats_np(means, normals, scan, np.eye(4), 2.0)
    np.testing.assert_allclose(H1 / n, H2 / n, atol=2e-3)
    np.testing.assert_allclose(g1 / n, g2 / n, atol=2e-3)
    assert abs(e2_1 - e2_2) / n < 2e-3
    assert H1.dtype == np.float64


def test_voxels_attribute(scene):
    pts, jm = scene
    vp = VPlaneICP(device="cpu")
    vp.set_target(pts)
    assert vp.voxels.num_voxels == int(jm.num_voxels) > 50


@pytest.mark.parametrize("method", ["align", "calc_H_g_e2"])
def test_value_error_before_set_target(method):
    vp = VPlaneICP(device="cpu")
    scan = np.zeros((10, 3), np.float32)
    args = (scan,) if method == "align" else (np.eye(4), scan)
    with pytest.raises(ValueError, match="Target is not set"):
        getattr(vp, method)(*args)


def test_update_target_not_implemented(scene):
    vp = VPlaneICP(device="cpu")
    with pytest.raises(NotImplementedError):
        vp.update_target(scene[0])


def test_backend_other_than_auto_raises():
    with pytest.raises(ValueError):
        VPlaneICPConfig(backend="xla")


def test_pad_points_buckets():
    src, w = pad_points(np.ones((10, 3), np.float32), bucket=8)
    assert src.shape == (16, 3) and w.tolist() == [1.0] * 10 + [0.0] * 6
    assert float(src[10:].abs().sum()) == 0.0


def test_import_does_not_load_jax():
    code = (
        "import sys\n"
        "import point_cloud_registration_tpu_torch as pt\n"
        "import point_cloud_registration_tpu_torch.models\n"
        "import point_cloud_registration_tpu_torch.ops.kernels.fused_align\n"
        "import point_cloud_registration_tpu_torch.utils.convert\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not any(m.startswith('point_cloud_registration_tpu.') for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
