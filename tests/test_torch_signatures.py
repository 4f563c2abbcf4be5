"""The port's callables take the reference's parameters: for every callable
in the JAX package's ``__init__`` export lists (the package root, ``ops``,
``models``, ``core``, ``parallel``, ``utils``) and in ``compat``, the port's
counterpart has the JAX parameters' names, kinds and defaults in the JAX
order, followed only by keyword-only parameters of its own (``device``,
``rng``, ``chunk`` ...). The layout types whose fields differ by design
(ROADMAP.md queue 3, "Known deviations") are listed with the port's
signature, which they must keep.

Then the keyword faults that were found (F2), each held to the JAX result on
the CPU: ``build_voxel_map`` with ``with_normals=False`` and ``rich=None``,
``knn_points`` with a positional ``chunk``, ``query_nearest_voxel`` and
``vplane_stats`` by the reference's keywords, ``sample_knn_radius`` with
``seed``. Tolerances: centroids within 1e-5 m (float32 sums in two orders),
distances within 1e-5 relative, the stats within 1e-4 of their scale.
"""

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import point_cloud_registration_tpu.compat as jcompat
from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxVPlaneConfig
from point_cloud_registration_tpu.models import voxelized_plane_icp as jvpicp
from point_cloud_registration_tpu.ops import hashgrid as jgrid
from point_cloud_registration_tpu.ops import knn as jknn
from point_cloud_registration_tpu.ops import normals as jnormals
from point_cloud_registration_tpu.ops import voxelize as jvox
import point_cloud_registration_tpu_torch.compat as tcompat
from point_cloud_registration_tpu_torch.core.config import VPlaneICPConfig
from point_cloud_registration_tpu_torch.models import voxelized_plane_icp as tvpicp
from point_cloud_registration_tpu_torch.ops import hashgrid as tgrid
from point_cloud_registration_tpu_torch.ops import knn as tknn
from point_cloud_registration_tpu_torch.ops import normals as tnormals
from point_cloud_registration_tpu_torch.ops import voxelize as tvox

JAX_PKG = Path(__file__).resolve().parents[1] / "point_cloud_registration_tpu"
SUBPACKAGES = ("", "ops", "models", "core", "parallel", "utils")
TOL_MEAN = 1e-5
TOL_DIST = 1e-5
TOL_STATS = 1e-4

# The layout types and mesh helpers that differ by design, with the port's
# signature: the cell index in place of dense_blocks, slab maps, a torch
# device type in place of a JAX device list, the kernel's kind in
# place of a Pallas spec; ICPTarget's grid, buckets and rows (the grid
# method's points in bucket order, read by the grid stats kernel) default to
# None, so that a packed target needs none of them.
DEVIATIONS = {
    "VoxelMap": "(origin_cell, dims, cell_size, means, covs, normals, counts, valid, icovs, "
                "cells, grid=None)",
    "ShardedVoxelMap": "(slabs)",
    "make_mesh": "(batch=1, data=None, *, device_type='cuda')",
    "make_map_mesh": "(model, data=None, *, device_type='cuda')",
    "align_batched_fused_sharded": "(target, normals, sources, src_weights, init_Ts, cfg, kind, "
                                   "mesh)",
    "ICPTarget": "(points, packed, proxy, grid=None, buckets=None, rows=None)",
}


def _init_names(sub: str) -> list[str]:
    tree = ast.parse((JAX_PKG / sub / "__init__.py").read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names if node.module != "__future__"]


def _module(pkg: str, sub: str):
    return importlib.import_module(pkg + (f".{sub}" if sub else ""))


def _cases() -> list[tuple[str, str]]:
    out = []
    for sub in SUBPACKAGES:
        jm = _module("point_cloud_registration_tpu", sub)
        out += [(sub, n) for n in _init_names(sub) if _signature(getattr(jm, n)) is not None]
    out += [("compat", n) for n in dir(jcompat) if not n.startswith("_")
            and not inspect.ismodule(getattr(jcompat, n)) and _signature(getattr(jcompat, n))]
    return out


def _signature(obj):
    if not callable(obj) or inspect.ismodule(obj):
        return None
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


CASES = _cases()


def test_the_export_lists_are_read():
    subs = {s for s, _ in CASES}
    assert len(CASES) > 80 and subs == set(SUBPACKAGES) | {"compat"}, (len(CASES), subs)


def _plain(sig: inspect.Signature) -> str:
    """A signature without its annotations: names, defaults and the ``*``."""
    return str(sig.replace(parameters=[p.replace(annotation=p.empty)
                                       for p in sig.parameters.values()],
                           return_annotation=sig.empty))


def _same_default(a, b) -> bool:
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("sub,name", CASES, ids=[f"{s or 'root'}.{n}" for s, n in CASES])
def test_port_takes_the_reference_parameters(sub, name):
    pkg = "point_cloud_registration_tpu_torch" if sub != "compat" else None
    port = getattr(tcompat if pkg is None else _module(pkg, sub), name)
    ref = getattr(jcompat if pkg is None else _module("point_cloud_registration_tpu", sub), name)
    got = inspect.signature(port)
    if name in DEVIATIONS:
        assert _plain(got) == DEVIATIONS[name]
        return
    want = list(inspect.signature(ref).parameters.values())
    have = list(got.parameters.values())
    assert len(have) >= len(want), (got, inspect.signature(ref))
    for w, h in zip(want, have):
        assert (h.name, h.kind) == (w.name, w.kind), (got, inspect.signature(ref))
        assert _same_default(h.default, w.default), (h, w)
    extra = have[len(want):]
    assert all(p.kind in (p.KEYWORD_ONLY, p.VAR_KEYWORD) for p in extra), got


# --- the F2 cases against the JAX package ------------------------------------


@pytest.fixture(scope="module")
def box():
    """5,000 uniform points in a 10 x 10 x 2 m box."""
    return (np.random.RandomState(0).rand(5000, 3) * [10.0, 10.0, 2.0]).astype(np.float32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _valid_means(vm):
    return _np(vm.means)[_np(vm.valid).astype(bool)]


def test_build_voxel_map_without_normals_is_centroid_only(box):
    jm = jvox.build_voxel_map(box, 1.0, with_normals=False)
    tm = tvox.build_voxel_map(box, 1.0, with_normals=False, device="cpu")
    assert int(_np(tm.valid).sum()) == int(_np(jm.valid).sum()) == 200
    np.testing.assert_array_equal(_np(tm.counts), _np(jm.counts))
    np.testing.assert_allclose(_valid_means(tm), _valid_means(jm), rtol=0, atol=TOL_MEAN)
    for field in ("normals", "covs"):
        assert not _np(getattr(jm, field)).any() and not _np(getattr(tm, field)).any()
    # the normals come back with with_normals=True, on both sides
    assert _np(tvox.build_voxel_map(box, 1.0, device="cpu").normals).any()


@pytest.mark.parametrize("kw", [dict(rich=None), dict(with_icov=True, rich=None)],
                         ids=["rich_none", "icov_rich_none"])
def test_build_voxel_map_takes_rich_none(box, kw):
    jm = jvox.build_voxel_map(box, 1.0, **kw)
    tm = tvox.build_voxel_map(box, 1.0, device="cpu", **kw)
    np.testing.assert_array_equal(_np(tm.valid), _np(jm.valid))
    np.testing.assert_allclose(_valid_means(tm), _valid_means(jm), rtol=0, atol=TOL_MEAN)
    assert (tm.icovs is None) == (jm.icovs is None)
    # the same map as the port's default rows
    same = tvox.build_voxel_map(box, 1.0, device="cpu", **{**kw, "rich": "normals"})
    assert torch.equal(tm.cells.feats, same.cells.feats)


def test_knn_points_takes_chunk_before_with_overflow(box):
    cell = 0.5
    jg, _, jb = jgrid.build_grid(box[:3000], cell, with_buckets=True)
    tg, _, tb = tgrid.build_grid(box[:3000], cell, device="cpu", with_buckets=True)
    q = box[:3000][::10]
    offs = tgrid.search_offsets(cell, cell)
    want = jknn.knn_points(jg, jb, jnp.asarray(box[:3000]), jnp.asarray(q), offs, 32, 5, 4096)
    got = tknn.knn_points(tg, tb, torch.from_numpy(box[:3000]), torch.from_numpy(q), offs, 32, 5,
                          4096)
    assert len(got) == len(want) == 2
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=TOL_DIST, atol=0)
    small = tknn.knn_points(tg, tb, torch.from_numpy(box[:3000]), torch.from_numpy(q), offs, 32,
                            5, 7)
    assert torch.equal(small[1], got[1]) and torch.equal(small[0], got[0])


def test_query_nearest_voxel_by_the_reference_keywords(box):
    jm = jvox.build_voxel_map(box, 1.0)
    tm = tvox.build_voxel_map(box, 1.0, device="cpu")
    q = box[::7] + np.float32([0.3, -0.2, 0.1])
    kw = dict(voxel_size=1.0, max_dist=2.0, fixed_tiers=True, full_window=True)
    want = jvox.query_nearest_voxel(vmap_=jm, query=jnp.asarray(q), **kw)
    got = tvox.query_nearest_voxel(vmap_=tm, query=torch.from_numpy(q), **kw)
    hit = _np(want.idx) >= 0
    np.testing.assert_array_equal(_np(got.idx) >= 0, hit)
    np.testing.assert_allclose(_np(tm.means)[_np(got.idx)[hit]], _np(jm.means)[_np(want.idx)[hit]],
                               rtol=0, atol=TOL_MEAN)
    np.testing.assert_allclose(_np(got.dist)[hit], _np(want.dist)[hit], rtol=TOL_DIST, atol=1e-6)


def test_vplane_stats_by_the_reference_keywords(box):
    jm = jvox.build_voxel_map(box, 1.0, rich="normals")
    tm = tvox.build_voxel_map(box, 1.0, device="cpu")
    src = box[::5] + np.float32([0.05, -0.03, 0.02])
    w = np.ones(len(src), np.float32)
    T = np.eye(4, dtype=np.float32)
    want = jvpicp.vplane_stats(vmap_=jm, source=jnp.asarray(src), src_weight=jnp.asarray(w),
                               T=jnp.asarray(T), cfg=JaxVPlaneConfig())
    got = tvpicp.vplane_stats(vmap_=tm, source=torch.from_numpy(src),
                              src_weight=torch.from_numpy(w), T=torch.from_numpy(T),
                              cfg=VPlaneICPConfig())
    for g, j in zip(got[:3], want[:3]):
        scale = max(float(np.abs(_np(j)).max()), 1e-30)
        assert float(np.abs(_np(g) - _np(j)).max()) <= TOL_STATS * scale
    assert abs(float(got.n_inliers) - float(want.n_inliers)) <= 1


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_knn_radius_takes_seed(box, seed):
    want = float(jnormals.sample_knn_radius(box, 15, seed=seed))
    got = tnormals.sample_knn_radius(torch.from_numpy(box), 15, seed=seed)
    assert got == pytest.approx(want, rel=1e-6)
    by_rng = tnormals.sample_knn_radius(torch.from_numpy(box), 15,
                                        rng=np.random.RandomState(seed))
    assert by_rng == got
