"""The port's utilities and API surface: the reference's export list
(tests/test_api.py:10-38) on ``point_cloud_registration_tpu_torch``, the
phase timer and profiler trace, PCD IO with the native reader (built into
the package's ``_build/``, NumPy when no compiler is present), the copied
Caratheodory coresets against the JAX package's (equal bits: the same
float64 NumPy code), and that the port imports no JAX.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu.models import coreset as jax_coreset
from point_cloud_registration_tpu_torch import native
from point_cloud_registration_tpu_torch.models import coreset
from point_cloud_registration_tpu_torch.utils import (
    PhaseTimer,
    io,
    profiler_trace,
    read_pcd,
    read_pcd_xyz,
    write_pcd,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REFERENCE_EXPORTS = [
    "Registration", "ICP", "PlaneICP", "VPlaneICP", "NDT", "FastVPlaneICP",
    "makeRt", "expSO3", "makeT", "skews", "huber_weight", "plus", "transform_points",
    "skew_time_vector",
    "KDTree", "VoxelGrid", "voxel_filter", "color_by_voxel",
    "estimate_normals", "get_norm_lines", "estimate_norm_with_tree",
    "fast_caratheodory", "create_gn_set",
]


@pytest.mark.parametrize("name", REFERENCE_EXPORTS)
def test_reference_export_present(name):
    assert hasattr(pt, name), f"missing reference API export: {name}"
    assert name in pt.__all__


def test_phase_timer_accumulates():
    t = PhaseTimer(device="cpu")
    with t.phase("a"):
        x = torch.ones((64, 64)).sum()
    with t.phase("a", block_on=lambda: x):
        pass
    with t.phase("b"):
        pass
    d = t.as_dict()
    assert set(d) == {"a", "b"} and all(v >= 0 for v in d.values())
    assert t.counts["a"] == 2
    rep = t.report()
    assert "a" in rep and "ms/call" in rep


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiler_trace(str(tmp_path)) as prof:
        torch.ones((32, 32)) @ torch.ones((32, 32))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_pcd_roundtrip(tmp_path):
    pts = np.random.RandomState(1).rand(100, 3).astype(np.float32)
    p = str(tmp_path / "t.pcd")
    write_pcd(p, pts)
    np.testing.assert_array_equal(read_pcd(p)["xyz"], pts)
    p2 = str(tmp_path / "a.pcd")
    write_pcd(p2, pts, binary=False)
    np.testing.assert_allclose(read_pcd(p2)["xyz"], pts, atol=1e-5)


def test_native_reader_matches_numpy(tmp_path):
    pts = (np.random.RandomState(2).rand(5000, 3) * 50).astype(np.float32)
    p = str(tmp_path / "n.pcd")
    write_pcd(p, pts)
    np.testing.assert_array_equal(read_pcd_xyz(p), pts)
    lib = native.load()
    assert lib is None or hasattr(lib, "pcd_read_xyz")
    if lib is not None:
        assert native.library_path().parent.parent == native.BUILD_ROOT


def test_read_pcd_truncated_header_raises(tmp_path):
    bad = tmp_path / "truncated.pcd"
    bad.write_bytes(b"# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\n")  # no DATA line
    with pytest.raises(ValueError, match="DATA"):
        io.read_pcd(str(bad))


@pytest.mark.parametrize("fn", ["caratheodory", "fast_caratheodory"])
def test_coresets_equal_the_jax_packages(fn):
    # the plain elimination takes a full SVD per removed point (n^4 in all):
    # 120 points make 91 eliminations, the clustered one takes 300
    n = 120 if fn == "caratheodory" else 300
    rng = np.random.RandomState(3)
    P = rng.randn(28, n)
    u = rng.rand(n)
    u /= u.sum()
    args = (P, u, 64, 29) if fn == "fast_caratheodory" else (P, u, 29)
    got = getattr(coreset, fn)(*args)
    want = getattr(jax_coreset, fn)(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_create_gn_set_equals_the_jax_packages():
    rng = np.random.RandomState(4)
    J, r = rng.randn(50, 6), rng.randn(50)
    np.testing.assert_array_equal(coreset.create_gn_set(J, r), jax_coreset.create_gn_set(J, r))
    assert pt.create_gn_set is coreset.create_gn_set


def test_port_imports_no_jax():
    code = ("import sys, point_cloud_registration_tpu_torch as pt, "
            "point_cloud_registration_tpu_torch.compat, point_cloud_registration_tpu_torch.utils; "
            "sys.exit(1 if any(m == 'jax' or m == 'point_cloud_registration_tpu' or "
            "m.startswith(('jax.', 'point_cloud_registration_tpu.')) for m in sys.modules) "
            "else 0)")
    assert subprocess.run([sys.executable, "-c", code], timeout=120).returncode == 0
