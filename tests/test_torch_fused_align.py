"""Port parity: the plain PyTorch version of the fused plane-stats kernel
against the JAX package's Pallas kernel (run in interpret mode, as the JAX
package's own tests run it on the CPU) and against the float64 oracle.

Both packages read the identical map: JAX builds it and
``voxel_map_from_numpy`` carries it across. Tolerances (float32 sums taken
in another order): H / max|H| within 1e-5, g and e2 within rtol 1e-4,
n_inliers equal; against the float64 oracle 2e-3 per inlier, the bound of
tests/test_vpicp.py.

The CUDA kernel itself cannot run here; ``chip_smoke.py`` holds it against
this plain version on the card.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu.ops.pallas.fused_align import (
    band_layout,
    fused_stats_call,
    scatter_banded,
    voxel_fused_spec,
)
from point_cloud_registration_tpu.ops.voxelize import build_voxel_map
from point_cloud_registration_tpu_torch.core.gn import GNStats
from point_cloud_registration_tpu_torch.ops.kernels import _build
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    STATS_WIDTH,
    fused_plane_stats,
    fused_plane_stats_reference,
    packed_from_stats,
    stats_from_packed,
    window_offsets,
    window_radius,
)
from point_cloud_registration_tpu_torch.utils.convert import voxel_map_from_numpy
from oracles import plus_np, vplane_stats_np
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_DIST = 2.0


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    centers = rng.rand(60, 3) * 18
    pts = (centers[:, None, :] + rng.randn(60, 80, 3) * 0.5).reshape(-1, 3)
    pts = pts.astype(np.float32)
    scan = pts[rng.choice(len(pts), 1500, replace=False)] + np.float32([0.05, -0.03, 0.08])
    jm = build_voxel_map(pts, 1.0, min_points=5, rich="normals")
    tm = voxel_map_from_numpy(
        jm.means, jm.covs, jm.normals, jm.counts, jm.valid,
        jm.grid.origin_cell, jm.grid.dims, jm.grid.cell_size, device="cpu",
    )
    return jm, tm, scan


POSES = {
    "identity": np.zeros(6),
    "perturbed": np.array([0.04, -0.05, 0.03, 0.01, -0.015, 0.02]),
}


def _jax_stats(jm, scan, T, huber_delta):
    spec = voxel_fused_spec(jm, "plane", max_dist=MAX_DIST, huber_delta=huber_delta, tq=256)
    Tj = jnp.asarray(T, jnp.float32)
    q = transform_points(Tj, jnp.asarray(scan))
    pos = band_layout(spec, q)
    q_s, p_s, w_s = scatter_banded(
        spec, pos, q, jnp.asarray(scan), jnp.ones((len(scan),), jnp.float32)
    )
    R, _ = makeRt(Tj)
    C, unres = fused_stats_call(spec, jm.dense_blocks, q_s, p_s, w_s, R.reshape(9),
                                interpret=True)
    # the comparison needs every query resolved inside the kernel
    assert int(np.asarray(unres).sum()) == 0
    return np.asarray(C)


def _port_stats(tm, scan, T, huber_delta, w=None):
    T = torch.as_tensor(T, dtype=torch.float32)
    src = torch.from_numpy(scan)
    w = torch.ones(len(scan)) if w is None else w
    return fused_plane_stats_reference(
        tm.cells, tm.origin_cell, tm.dims, tm.cell_size, src, w,
        T[:3, :3], T[:3, 3], MAX_DIST, huber_delta,
    )


@pytest.mark.parametrize("huber_delta", [None, 0.05], ids=["plain", "huber"])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_reference_matches_jax_fused_kernel(scene, pose, huber_delta):
    jm, tm, scan = scene
    T = plus_np(np.eye(4), POSES[pose]).astype(np.float32)
    C = _jax_stats(jm, scan, T, huber_delta)
    st = stats_from_packed(_port_stats(tm, scan, T, huber_delta))
    H, g, e2, n = (x.numpy() for x in st)
    scale = np.abs(C[:6, :6]).max()
    np.testing.assert_allclose(H / scale, C[:6, :6] / scale, rtol=0, atol=1e-5)
    np.testing.assert_allclose(g, C[:6, 6], rtol=1e-4, atol=1e-4 * np.abs(C[:6, 6]).max())
    np.testing.assert_allclose(e2, C[6, 6], rtol=1e-4)
    if huber_delta is None:
        assert n == C[7, 7]
    else:
        np.testing.assert_allclose(n, C[7, 7], rtol=1e-5)


@pytest.mark.parametrize("pose", sorted(POSES))
def test_reference_matches_float64_oracle(scene, pose):
    jm, tm, scan = scene
    T = plus_np(np.eye(4), POSES[pose])
    st = stats_from_packed(_port_stats(tm, scan, T.astype(np.float32), None))
    valid = np.asarray(jm.valid)
    H2, g2, e2_2, n = vplane_stats_np(
        np.asarray(jm.means, np.float64)[valid], np.asarray(jm.normals, np.float64)[valid],
        scan, T, MAX_DIST,
    )
    assert int(st.n_inliers) == n
    np.testing.assert_allclose(st.H.numpy() / n, H2 / n, atol=2e-3)
    np.testing.assert_allclose(st.g.numpy() / n, g2 / n, atol=2e-3)
    assert abs(float(st.e2) - e2_2) / n < 2e-3


def test_zero_weights_drop_points(scene):
    _, tm, scan = scene
    T = np.eye(4, dtype=np.float32)
    w = torch.ones(len(scan))
    w[::2] = 0.0
    half = _port_stats(tm, scan[1::2].copy(), T, None)
    masked = _port_stats(tm, scan, T, None, w=w)
    torch.testing.assert_close(masked, half, rtol=1e-5, atol=1e-3)


def test_chunking_does_not_change_result(scene):
    _, tm, scan = scene
    args = (tm.cells, tm.origin_cell, tm.dims, tm.cell_size, torch.from_numpy(scan),
            torch.ones(len(scan)), torch.eye(3), torch.zeros(3), MAX_DIST)
    torch.testing.assert_close(
        fused_plane_stats_reference(*args, chunk=97),
        fused_plane_stats_reference(*args), rtol=1e-5, atol=1e-3,
    )


def test_cpu_wrapper_runs_plain_version_without_launching(scene):
    _, tm, scan = scene
    before = fused_plane_stats.launches
    T = torch.eye(4)
    out = fused_plane_stats(tm.cells, tm.origin_cell, tm.dims, tm.cell_size,
                            torch.from_numpy(scan), torch.ones(len(scan)),
                            T[:3, :3], T[:3, 3], MAX_DIST)
    assert fused_plane_stats.launches == before == 0
    assert out.shape == (STATS_WIDTH,) and out.device.type == "cpu"
    torch.testing.assert_close(out, _port_stats(tm, scan, T, None), rtol=0, atol=0)


def test_wrapper_rejects_mismatched_table(scene):
    _, tm, scan = scene
    with pytest.raises(ValueError, match="occupancy"):
        fused_plane_stats(tm.cells._replace(occ=tm.cells.occ[:-1]), tm.origin_cell,
                          tm.dims, tm.cell_size,
                          torch.from_numpy(scan), torch.ones(len(scan)),
                          torch.eye(3), torch.zeros(3), MAX_DIST)


def test_stats_packing_round_trip():
    rng = np.random.RandomState(3)
    A = rng.randn(6, 6).astype(np.float32)
    H = torch.from_numpy(A @ A.T)
    packed = packed_from_stats(
        GNStats(H, torch.arange(6.0), torch.tensor(7.0), torch.tensor(8.0))
    )
    assert packed.shape == (STATS_WIDTH,)
    st = stats_from_packed(packed)
    torch.testing.assert_close(st.H, H, rtol=0, atol=0)
    torch.testing.assert_close(st.g, torch.arange(6.0), rtol=0, atol=0)
    assert float(st.e2) == 7.0 and float(st.n_inliers) == 8.0


def test_window_matches_jax_radius_and_order():
    # radius covers max_dist (fused_align.py:670), x fastest, z slowest
    assert window_radius(2.0, 1.0) == 2 and window_radius(2.0, 0.7) == 3
    assert window_radius(1.0, 1.0) == 1
    offs = window_offsets(1).tolist()
    assert offs[0] == [-1, -1, -1] and offs[1] == [0, -1, -1] and offs[3] == [-1, 0, -1]
    assert offs[9] == [-1, -1, 0] and len(offs) == 27


def test_import_and_cpu_path_need_no_nvcc(tmp_path):
    code = (
        "import torch\n"
        "from point_cloud_registration_tpu_torch.ops.kernels.fused_align import "
        "fused_plane_stats\n"
        "from point_cloud_registration_tpu_torch.ops.knn import cell_index\n"
        "t = cell_index(torch.zeros(8, 3), torch.ones(8, dtype=torch.bool), torch.zeros(8, 3))\n"
        "out = fused_plane_stats(t, (0, 0, 0), (2, 2, 2), 1.0, torch.rand(5, 3), "
        "torch.ones(5), torch.eye(3), torch.zeros(3), 2.0)\n"
        "assert fused_plane_stats.launches == 0 and out.shape == (29,)\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # no nvcc on it
    env["PYTHONPATH"] = os.pathsep.join(sys.path)
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)


def test_find_nvcc_raises_when_absent(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_is_keyed_by_sources():
    path = _build.library_path("fused_align")
    assert path.parent.parent == _build.BUILD_ROOT
    assert path.name == "libfused_align.so"
    assert [p.name for p in _build._sources()] == ["exact_nn.cu", "fused_align.cu", "gn_loop.cu",
                                                  "gn_step.cu", "grid_align.cu", "grid_loop.cu",
                                                  "knn_normals.cu", "point_align.cu",
                                                  "point_loop.cu"]
