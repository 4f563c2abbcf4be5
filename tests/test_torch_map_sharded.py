"""Port parity of map-sharded alignment
(``point_cloud_registration_tpu_torch.parallel.map_sharded``) against the
JAX package's ``align_map_sharded``, against the same plain stats on the
whole map in one process (``query_nearest_voxel`` + ``plane_stats`` /
``ndt_stats``, what the JAX package's replicated reference computes), and
against the port's single-device align (the fused kernel's plain version on
the CPU).

The ranks are four gloo processes that run this file as a script, as in
``test_torch_parallel.py`` (whose ``spawn_ranks`` starts them, once for the
module, under its timeout); they import no JAX. The JAX references run in
the pytest process on the virtual 8-device CPU mesh.

Tolerances (tests/test_map_sharded.py:61-66, :188): T within 1e-5 of the
whole-map plain stats for the z-slab builder, 5e-5 for the auto axis; within
5e-5 of the port's single align (its NDT is the whitened form, the plain
stats the icov form); within 1e-3 of JAX; iterations equal throughout.
The port's builds sum exact fixed-point moments, so the two builders'
slabs are equal bit for bit here, where the JAX package allows 2e-5.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from point_cloud_registration_tpu_torch.core.config import NDTConfig, VPlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import (
    gauss_newton,
    packed_from_stats,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu_torch.models import (
    build_ndt_target,
    build_vplane_target,
    ndt_align,
    pad_points,
    vplane_align,
)
from point_cloud_registration_tpu_torch.ops.reduce import ndt_stats, plane_stats
from point_cloud_registration_tpu_torch.ops.voxelize import query_nearest_voxel
from point_cloud_registration_tpu_torch.parallel import (
    align_map_sharded,
    make_map_mesh,
    shard_voxel_map,
    shard_voxel_map_on_mesh,
)
from point_cloud_registration_tpu_torch.parallel.mesh import axes_rank
from oracles import make_scan, make_scene
from test_torch_parallel import WORKER_ENV, put, rank_main, spawn_ranks

TOL_PLAIN = {"z": 1e-5, "auto": 5e-5}  # vs the whole-map plain stats
TOL_SINGLE = 5e-5  # vs the port's single align
TOL_JAX = 1e-3
VOXEL_KINDS = ("vplane_icp", "ndt")
MAP_MESHES = {"4x1": (4, 1), "2x2": (2, 2)}  # (model, data)
BUILDERS = ("z", "auto")  # shard_voxel_map, shard_voxel_map_on_mesh(axis="auto")
JAX_CASES = {"4x1": "z", "2x2": "auto"}  # the builder of each mesh's JAX reference
CFGS = {
    "vplane_icp": VPlaneICPConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3),
    "ndt": NDTConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3),
}
SKEWED_CFG = VPlaneICPConfig(voxel_size=1.0, max_iter=10, max_dist=2.0, tol=1e-3)
TIE_CFG = VPlaneICPConfig(voxel_size=1.0, max_iter=1, max_dist=1.0, tol=1e-3)
TIE_QUERY = np.float32([[0.5, 0.5, 1.0]])  # 0.5 from both voxels' means
SINGLE = {"vplane_icp": (build_vplane_target, vplane_align), "ndt": (build_ndt_target, ndt_align)}


def problem():
    """The scene and scan of tests/test_map_sharded.py:31-37 (seed 7)."""
    rng = np.random.RandomState(7)
    scene = make_scene(rng)
    scan, _ = make_scan(rng, scene, np.array([0.05, -0.03, 0.1, 0.01, -0.01, 0.015]))
    return scene, scan


def skewed_scan(scene):
    """Every scan point near one end of the widest axis
    (tests/test_map_sharded.py:192-216)."""
    rng = np.random.RandomState(13)
    sel = np.argsort(scene[:, 0])[:4000]
    return (scene[sel][rng.choice(4000, 6000, replace=True)]
            + np.float32([0.05, -0.03, 0.1])).astype(np.float32)


def tie_scene(horizontal_low: bool) -> np.ndarray:
    """Two voxels of 16 points each, one above the other on two z-slabs of a
    1 m grid: a horizontal square (normal z) and a vertical one (normal x),
    with means (0.5, 0.5, 0.5) and (0.5, 0.5, 1.5), exact in float32.
    ``TIE_QUERY`` lies 0.5 from both: an exact tie across slabs 0 and 1."""
    g = np.float32([0.125, 0.375, 0.625, 0.875])
    a, b = (x.ravel() for x in np.meshgrid(g, g))
    half = np.full(16, 0.5, np.float32)
    z_h, z_v = (0.0, 1.0) if horizontal_low else (1.0, 0.0)
    horizontal = np.stack([a, b, half + z_h], axis=1)
    vertical = np.stack([half, a, b + z_v], axis=1)
    return np.vstack([horizontal, vertical]).astype(np.float32)


def meta_row(meta) -> np.ndarray:
    return np.float64([meta.n_shards, *meta.dims_slab, *meta.origin_cell, meta.cell_size,
                       meta.axis])


def job_map(res: dict, out: Path) -> None:
    """align_map_sharded of both kinds on (4, 1) and (2, 2) with both
    builders; the builders' slabs; a skewed scan; exact ties across slabs."""
    scene, scan = problem()
    src, w = pad_points(scan, device="cpu")
    eye = torch.eye(4)
    meshes = {name: make_map_mesh(*shape, device_type="cpu")
              for name, shape in MAP_MESHES.items()}
    for name, mesh in meshes.items():
        for kind in VOXEL_KINDS:
            icov = kind == "ndt"
            maps = {
                "z": shard_voxel_map(scene, 1.0, MAP_MESHES[name][0], with_icov=icov,
                                     device="cpu"),
                "auto": shard_voxel_map_on_mesh(scene, 1.0, mesh, with_icov=icov, device="cpu"),
            }
            for builder, (svm, meta) in maps.items():
                put(res, f"map/{name}/{builder}/{kind}",
                    align_map_sharded(kind, svm, meta, src, w, eye, CFGS[kind], mesh))
                res[f"meta/{name}/{builder}"] = meta_row(meta)
    mesh = meshes["4x1"]
    rank = axes_rank(mesh, ("model",))
    local, meta_l = shard_voxel_map(scene, 1.0, 4, with_icov=True, device="cpu")
    dist_, meta_d = shard_voxel_map_on_mesh(scene, 1.0, mesh, with_icov=True, axis=2,
                                            device="cpu")
    res["build/meta_equal"] = np.asarray(meta_l == meta_d)
    for tag, svm in (("local", local), ("mesh", dist_)):
        vm = svm.slabs[rank]
        for field in ("means", "counts", "valid", "icovs"):
            res[f"build/{tag}/{field}"] = getattr(vm, field).numpy()
        res[f"build/{tag}/origin"] = np.asarray(vm.origin_cell)
        res[f"build/{tag}/dims"] = np.asarray(vm.dims)
    src_s, w_s = pad_points(skewed_scan(scene), device="cpu")
    svm, meta = shard_voxel_map_on_mesh(scene, 1.0, mesh, device="cpu")
    res["skewed/axis"] = np.asarray(meta.axis)
    put(res, "skewed", align_map_sharded("vplane_icp", svm, meta, src_s, w_s, eye, SKEWED_CFG,
                                         mesh))
    sub = make_map_mesh(3, 1, device_type="cpu")  # ranks 0-2; every rank joins its groups
    if sub.get_coordinate() is not None:
        svm, meta = shard_voxel_map(scene, 1.0, 3, device="cpu")
        put(res, "submesh", align_map_sharded("vplane_icp", svm, meta, src, w, eye,
                                              CFGS["vplane_icp"], sub))
    for name, low in (("horizontal_low", True), ("vertical_low", False)):
        svm, meta = shard_voxel_map(tie_scene(low), 1.0, 4, device="cpu")
        put(res, f"tie/{name}", align_map_sharded("vplane_icp", svm, meta, TIE_QUERY,
                                                  np.ones(1, np.float32), eye, TIE_CFG, mesh))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(__file__, "map", 4, tmp_path_factory.mktemp("map_sharded"))


@pytest.fixture(scope="module")
def scene_scan():
    return problem()


def plain_voxel_stats(vm, src, w, T, cfg, kind):
    """The plain stats of a voxel map at ``T``: ``query_nearest_voxel`` +
    ``plane_stats`` / ``ndt_stats``, in the kernels' packed layout."""
    R, _ = makeRt(T)
    q = transform_points(T, src)
    nn = query_nearest_voxel(vm, q, voxel_size=cfg.voxel_size, max_dist=cfg.max_dist)
    wq = w * (nn.dist < cfg.max_dist) * (nn.idx >= 0)
    safe = nn.idx.clamp(0, vm.means.shape[0] - 1).to(torch.int64)
    if kind == "vplane_icp":
        stats = plane_stats(src, q, vm.means[safe], vm.normals[safe], wq, R,
                            huber_delta=cfg.huber_delta)
    else:
        stats = ndt_stats(src, q, vm.means[safe], vm.icovs[safe], wq, R,
                          huber_delta=cfg.huber_delta)
    return stats_from_packed(packed_from_stats(stats))


def plain_whole_map_align(scene, src, w, cfg, kind):
    """GN over the plain stats on the whole map in one process:
    ``query_nearest_voxel`` + ``plane_stats`` / ``ndt_stats``."""
    vm = SINGLE[kind][0](scene, cfg, device="cpu")
    return gauss_newton(lambda T: plain_voxel_stats(vm, src, w, T, cfg, kind),
                        torch.eye(4), cfg.max_iter, cfg.tol)


@pytest.fixture(scope="module")
def port_refs(scene_scan):
    """The port's single align and the whole-map plain align of each kind."""
    scene, scan = scene_scan
    src, w = pad_points(scan, device="cpu")
    out = {}
    for kind in VOXEL_KINDS:
        build, align = SINGLE[kind]
        out[kind] = (align(build(scene, CFGS[kind], device="cpu"), src, w, torch.eye(4),
                           CFGS[kind]),
                     plain_whole_map_align(scene, src, w, CFGS[kind], kind))
    return out


@pytest.fixture(scope="module")
def jax_refs(scene_scan):
    """JAX align_map_sharded per kind: (4, 1) with shard_voxel_map and
    (2, 2) with shard_voxel_map_on_mesh (auto axis)."""
    import jax.numpy as jnp
    from point_cloud_registration_tpu.core import config as jc
    from point_cloud_registration_tpu.models.base import pad_points as jax_pad
    from point_cloud_registration_tpu.parallel import align_map_sharded as j_align
    from point_cloud_registration_tpu.parallel import make_map_mesh as j_mesh
    from point_cloud_registration_tpu.parallel import shard_voxel_map as j_shard
    from point_cloud_registration_tpu.parallel import shard_voxel_map_on_mesh as j_shard_mesh

    scene, scan = scene_scan
    src, w = jax_pad(scan)
    cfgs = {"vplane_icp": jc.VPlaneICPConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3),
            "ndt": jc.NDTConfig(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)}
    out = {}
    for name, builder in JAX_CASES.items():
        model, data = MAP_MESHES[name]
        mesh = j_mesh(model, data)
        for kind in VOXEL_KINDS:
            icov = kind == "ndt"
            svm, meta = (j_shard(scene, 1.0, n_shards=model, with_icov=icov) if builder == "z"
                         else j_shard_mesh(scene, 1.0, mesh, with_icov=icov))
            out[name, kind] = (j_align(kind, svm, meta, src, w, jnp.eye(4, dtype=jnp.float32),
                                       cfgs[kind], mesh), meta)
    return out


def _check(res, key, T, iterations, atol):
    np.testing.assert_allclose(res[f"{key}/T"], np.asarray(T), rtol=0, atol=atol, err_msg=key)
    assert int(res[f"{key}/it"]) == int(iterations), key


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("mesh", list(MAP_MESHES))
@pytest.mark.parametrize("kind", VOXEL_KINDS)
def test_align_map_sharded(ranks, port_refs, jax_refs, kind, mesh, builder):
    """Each kind on (model 4, data 1) and (model 2, data 2), with the
    z-slab builder and the on-mesh builder (auto axis)."""
    key = f"map/{mesh}/{builder}/{kind}"
    res = ranks[0]
    single, (T_plain, d_plain) = port_refs[kind]
    _check(res, key, T_plain, d_plain.iterations, TOL_PLAIN[builder])
    _check(res, key, single.T, single.diagnostics.iterations, TOL_SINGLE)
    assert bool(res[f"{key}/conv"]) and not bool(res[f"{key}/failed"])
    ref, meta = jax_refs[mesh, kind]
    _check(res, key, ref.T, ref.diagnostics.iterations, TOL_JAX)
    if builder == JAX_CASES[mesh]:
        row = np.float64([meta.n_shards, *meta.dims_slab, *meta.origin_cell, meta.cell_size,
                          meta.axis])
        np.testing.assert_array_equal(res[f"meta/{mesh}/{builder}"], row)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{key}/T"], res[f"{key}/T"])
        np.testing.assert_array_equal(r[f"{key}/it"], res[f"{key}/it"])


def test_builders_agree(ranks):
    """shard_voxel_map_on_mesh(axis=2) builds on each rank the slab that
    shard_voxel_map cuts from the global map: equal meta, origin, dims,
    counts and valid cells, means and icovs (tests/test_map_sharded.py:137-160)."""
    for res in ranks:
        assert bool(res["build/meta_equal"])
        for field in ("origin", "dims", "counts", "valid"):
            np.testing.assert_array_equal(res[f"build/mesh/{field}"], res[f"build/local/{field}"])
        for field in ("means", "icovs"):
            np.testing.assert_allclose(res[f"build/mesh/{field}"], res[f"build/local/{field}"],
                                       rtol=0, atol=2e-5)
    assert sum(int(r["build/mesh/valid"].sum()) for r in ranks) > 0


def test_skewed_scan(ranks, scene_scan):
    """A scan at one end of the widest axis, so that one slab holds most of
    its matches: T stays that of the single align and of the whole-map
    plain stats."""
    scene, _ = scene_scan
    src, w = pad_points(skewed_scan(scene), device="cpu")
    single = vplane_align(build_vplane_target(scene, SKEWED_CFG, device="cpu"), src, w,
                          torch.eye(4), SKEWED_CFG)
    T_plain, d_plain = plain_whole_map_align(scene, src, w, SKEWED_CFG, "vplane_icp")
    res = ranks[0]
    assert int(res["skewed/axis"]) == 0
    _check(res, "skewed", T_plain, d_plain.iterations, TOL_PLAIN["auto"])
    _check(res, "skewed", single.T, single.diagnostics.iterations, TOL_SINGLE)


def test_mesh_smaller_than_the_world(ranks, port_refs):
    """A (3, 1) map mesh in a world of four ranks: ranks 0-2 align over their
    groups and the group that spans the mesh; rank 3 holds no slab."""
    _, (T_plain, d_plain) = port_refs["vplane_icp"]
    for res in ranks[:3]:
        _check(res, "submesh", T_plain, d_plain.iterations, TOL_PLAIN["z"])
        np.testing.assert_array_equal(res["submesh/T"], ranks[0]["submesh/T"])
    assert "submesh/T" not in ranks[3]


@pytest.mark.parametrize("name, e2", [("horizontal_low", 0.25), ("vertical_low", 0.0)])
def test_lowest_rank_wins_an_exact_tie(ranks, name, e2):
    """The query is exactly 0.5 from a voxel on slab 0 and one on slab 1:
    rank 0's voxel wins. Its residual tells which: 0.5 against the
    horizontal voxel, 0 against the vertical one."""
    res = ranks[0]
    assert int(res[f"tie/{name}/inliers_0"]) == 1
    np.testing.assert_allclose(float(res[f"tie/{name}/e2_0"]), e2, rtol=0, atol=1e-6)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"tie/{name}/e2_0"], res[f"tie/{name}/e2_0"])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_slabs_split_the_dense_map(n_shards):
    """Each slab holds 1/S of the dense map's cells (the capacity contract,
    tests/test_map_sharded.py:76), and the slabs in order are the one-slab
    map's rows: the same cells, counts and means."""
    rng = np.random.RandomState(11)
    scene = (rng.rand(60000, 3) * np.array([30.0, 30.0, 64.0])).astype(np.float32)
    whole, meta1 = shard_voxel_map(scene, 1.0, 1, device="cpu")
    svm, meta = shard_voxel_map(scene, 1.0, n_shards, device="cpu")
    assert sorted(svm.slabs) == list(range(n_shards))
    assert meta.slab_cells * n_shards == meta1.slab_cells  # 64 cells of z divide
    one = whole.slabs[0]
    for s, vm in svm.slabs.items():
        assert vm.means.shape[0] == meta.slab_cells == one.means.shape[0] // n_shards
        assert vm.origin_cell[2] == meta.origin_cell[2] + s * meta.dims_slab[2]
        rows = slice(s * meta.slab_cells, (s + 1) * meta.slab_cells)
        assert torch.equal(vm.counts, one.counts[rows]) and torch.equal(vm.means, one.means[rows])
        assert vm.cells.centers.shape[0] == int(vm.valid.sum()) + 1


def test_rejections(scene_scan):
    """Only the voxel kinds; NDT needs a map built with icovs."""
    scene, scan = scene_scan
    svm, meta = shard_voxel_map(scene, 1.0, 2, device="cpu")
    src, w = pad_points(scan, device="cpu")
    with pytest.raises(ValueError, match="voxel-map kinds"):
        align_map_sharded("icp", svm, meta, src, w, torch.eye(4), CFGS["vplane_icp"], None)
    with pytest.raises(ValueError, match="needs per-voxel icovs"):
        align_map_sharded("ndt", svm, meta, src, w, torch.eye(4), CFGS["ndt"], None)


if __name__ == "__main__" and os.environ.get(WORKER_ENV):
    rank_main({"map": job_map})
