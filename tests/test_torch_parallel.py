"""Port parity of the multi-rank paths of ``point_cloud_registration_tpu_torch.parallel``
(``distributed``, ``mesh``, ``sharded``) against the JAX package's
``parallel`` and against the port's own single-device aligns.

The ranks are gloo processes: each runs this file as a script (its job and
rank in ``PCR_TORCH_RANK``), joins one process group through a FileStore
under ``tmp_path`` (the torchrun-style job: through ``RANK`` / ``WORLD_SIZE``
/ ``MASTER_ADDR`` / ``MASTER_PORT`` on localhost), runs every case of its
job in one process with one thread, and writes its results to a ``.npz``.
Each rank set is started once per module and runs under a timeout of
``RANK_TIMEOUT_S``, so a hung collective fails its tests and nothing else.
This module imports no JAX at its top, so a rank loads none, which each rank
asserts; the JAX references run in the pytest process, on the virtual
8-device CPU mesh of ``conftest.py``, Pallas in interpret mode.

On the CPU every stats wrapper runs its plain version; on the card the same
paths launch the kernels, which ``chip_smoke.py`` phase 16 checks.

Tolerances: T within 1e-5 of the port's single-device align with equal
iterations (the JAX bound for sharded against single, tests/test_sharded.py:63,
:100-103); within 1e-3 of the JAX functions with equal iterations (the
port's parity bound of a single path); bit for bit equal on every rank.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from point_cloud_registration_tpu_torch.core.config import (
    CorrespondenceConfig,
    ICPConfig,
    NDTConfig,
    PlaneICPConfig,
    VPlaneICPConfig,
)
from point_cloud_registration_tpu_torch.models import (
    build_icp_target,
    build_ndt_target,
    build_plane_icp_target,
    build_vplane_target,
    icp_align,
    ndt_align,
    pad_points,
    plane_icp_align,
    vplane_align,
)
from point_cloud_registration_tpu_torch.models._fused import fused_voxel_align_batched
from point_cloud_registration_tpu_torch.models._point_fused import fused_point_align_batched
from point_cloud_registration_tpu_torch.ops.voxelize import build_voxel_map
from point_cloud_registration_tpu_torch.parallel import (
    align_batched_fused_sharded,
    align_batched_sharded,
    align_sharded,
    distributed,
    make_map_mesh,
    make_mesh,
)
from oracles import make_scan, make_scene

WORKER_ENV = "PCR_TORCH_RANK"
RANK_TIMEOUT_S = 120
REPO = Path(__file__).resolve().parents[1]
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

TOL_SINGLE = 1e-5  # sharded vs the port's single-device align
TOL_JAX = 1e-3  # the port vs the JAX package

KINDS = ("icp", "plane_icp", "vplane_icp", "ndt")
FUSED_KINDS = ("plane", "ndt", "point", "plane_pt")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}  # (batch, data); 4 and 2 data ranks
DX = np.array([0.05, -0.03, 0.1, 0.01, -0.01, 0.015])
B_BATCHED = 2  # problems of align_batched_sharded
B_FUSED, N_FUSED = 4, 512  # problems and points of align_batched_fused_sharded
PACKED = dict(method="packed")
# ICP and PlaneICP on the packed method, the path of targets of 50k points and
# more (and of the kernels on the card); the grid method, this 10k scene's
# default, has a case of its own (GRID_CFG)
CFGS = {
    "icp": ICPConfig(corr=CorrespondenceConfig(**PACKED), max_iter=10, max_dist=2.0, tol=1e-3),
    "plane_icp": PlaneICPConfig(corr=CorrespondenceConfig(**PACKED), max_iter=10, max_dist=2.0,
                                tol=1e-3),
    "vplane_icp": VPlaneICPConfig(voxel_size=1.0, max_iter=10, max_dist=2.0, tol=1e-3),
    "ndt": NDTConfig(voxel_size=1.0, max_iter=10, max_dist=2.0, tol=1e-3),
}
FUSED_CFGS = {
    "plane": VPlaneICPConfig(voxel_size=1.0, max_iter=8, max_dist=2.0, tol=1e-3),
    "ndt": NDTConfig(voxel_size=1.0, max_iter=8, max_dist=2.0, tol=1e-3),
    "point": ICPConfig(corr=CorrespondenceConfig(**PACKED), max_iter=8, max_dist=2.0, tol=1e-3),
    "plane_pt": PlaneICPConfig(corr=CorrespondenceConfig(**PACKED), max_iter=8, max_dist=2.0,
                               tol=1e-3),
}
GRID_CFG = ICPConfig(max_iter=10, max_dist=2.0, tol=1e-3)
HASHED_CAPACITY = 1024  # slots of a hashed map of the scene (about 480 occupied cells)
SINGLE = {"icp": icp_align, "plane_icp": plane_icp_align, "vplane_icp": vplane_align,
          "ndt": ndt_align}
BUILD = {"icp": build_icp_target, "plane_icp": build_plane_icp_target,
         "vplane_icp": build_vplane_target, "ndt": build_ndt_target}


# --- inputs, made the same way in the ranks and in the pytest process --------


def problem():
    """The scene and scan of tests/test_sharded.py:39-43 (seed 33)."""
    rng = np.random.RandomState(33)
    scene = make_scene(rng)
    scan, _ = make_scan(rng, scene, DX)
    return scene, scan


def batched_init() -> np.ndarray:
    """Distinct initial transforms of the align_batched_sharded problems."""
    T0 = np.stack([np.eye(4)] * B_BATCHED).astype(np.float32)
    T0[1, :3, 3] += 0.02
    return T0


def fused_scans(scene) -> np.ndarray:
    """B_FUSED scans of N_FUSED scene points, each with its own offset
    (tests/test_sharded.py:164-185)."""
    rng = np.random.RandomState(7)
    return np.stack([
        scene[rng.choice(len(scene), N_FUSED, replace=False)]
        + np.float32([0.05 * (b + 1), -0.03, 0.08])
        + rng.randn(N_FUSED, 3).astype(np.float32) * 0.004
        for b in range(B_FUSED)
    ]).astype(np.float32)


def port_targets(scene, normals) -> dict:
    """Each kind's target on the CPU; PlaneICP takes the shared normals."""
    out = {k: BUILD[k](scene, CFGS[k], device="cpu") for k in ("icp", "vplane_icp", "ndt")}
    out["plane_icp"] = build_plane_icp_target(scene, CFGS["plane_icp"], normals=normals,
                                              device="cpu")
    return out


def hashed_map(scene):
    """The scene's voxel map hashed (no cell index: the plain stats)."""
    return build_voxel_map(scene, 1.0, capacity=HASHED_CAPACITY, device="cpu")


def fused_target(scene, normals, kind):
    """``(target, normals)`` of a fused kind, as tests/test_sharded.py:188-206."""
    if kind == "plane":
        return build_voxel_map(scene, 1.0, min_points=5, rich="normals", device="cpu"), None
    if kind == "ndt":
        return build_voxel_map(scene, 1.0, min_points=5, with_icov=True, rich="sqrt_icov",
                               device="cpu"), None
    if kind == "point":
        return build_icp_target(scene, FUSED_CFGS["point"], device="cpu"), None
    tg = build_plane_icp_target(scene, FUSED_CFGS["plane_pt"], normals=normals, device="cpu")
    return tg.corr, tg.normals


def multihost_scene():
    """The scene and scan of tests/test_multihost.py:29-37."""
    rng = np.random.RandomState(5)
    centers = rng.rand(50, 3) * 15
    pts = (centers[:, None, :] + rng.randn(50, 60, 3) * 0.4).reshape(-1, 3).astype(np.float32)
    scan = pts[rng.choice(len(pts), 1024, replace=False)] + np.float32([0.04, -0.02, 0.06])
    return pts, scan


MULTIHOST_CFG = VPlaneICPConfig(voxel_size=1.0, min_points=5)


# --- the ranks ------------------------------------------------------------------


def put(res: dict, key: str, result) -> None:
    d = result.diagnostics
    res[f"{key}/T"] = result.T.numpy()
    res[f"{key}/it"] = np.asarray(d.iterations)
    res[f"{key}/conv"] = np.asarray(d.converged)
    res[f"{key}/failed"] = np.asarray(d.solver_failed)
    res[f"{key}/e2_0"] = np.asarray(d.e2_history)[..., 0]
    res[f"{key}/inliers_0"] = np.asarray(d.inlier_history)[..., 0]


def error_of(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def job_parallel(res: dict, out: Path) -> None:
    """align_sharded on two meshes, align_batched_sharded and
    align_batched_fused_sharded on (2, 2), the refusals."""
    scene, scan = problem()
    normals = np.load(out / "normals.npy")
    src, w = pad_points(scan, device="cpu")
    eye = torch.eye(4)
    targets = port_targets(scene, normals)
    meshes = {name: make_mesh(*shape, device_type="cpu") for name, shape in MESHES.items()}
    for name, mesh in meshes.items():
        for kind in KINDS:
            put(res, f"sharded/{name}/{kind}",
                align_sharded(kind, targets[kind], src, w, eye, CFGS[kind], mesh))
    put(res, "sharded/1x4/icp_grid", align_sharded(
        "icp", build_icp_target(scene, GRID_CFG, device="cpu"), src, w, eye, GRID_CFG,
        meshes["1x4"]))
    mesh = meshes["2x2"]
    srcs, ws = src.expand(B_BATCHED, -1, -1), w.expand(B_BATCHED, -1)
    for kind in KINDS:
        put(res, f"batched/{kind}", align_batched_sharded(
            kind, targets[kind], srcs, ws, batched_init(), CFGS[kind], mesh))
    put(res, "batched/vplane_icp_hashed", align_batched_sharded(
        "vplane_icp", hashed_map(scene), srcs, ws, batched_init(), CFGS["vplane_icp"], mesh))
    scans = fused_scans(scene)
    for kind in FUSED_KINDS:
        target, tnormals = fused_target(scene, normals, kind)
        for B in (2, B_FUSED):
            put(res, f"fused/{kind}/{B}", align_batched_fused_sharded(
                target, tnormals, scans[:B], np.ones((B, N_FUSED), np.float32),
                np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)), FUSED_CFGS[kind], kind, mesh))
    vm, _ = fused_target(scene, normals, "plane")
    res["err/fused_batch"] = error_of(lambda: align_batched_fused_sharded(
        vm, None, scans[:3], np.ones((3, N_FUSED), np.float32),
        np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)), FUSED_CFGS["plane"], "plane", mesh))
    res["err/fused_kind"] = error_of(lambda: align_batched_fused_sharded(
        vm, None, scans, np.ones((B_FUSED, N_FUSED), np.float32),
        np.tile(np.eye(4, dtype=np.float32), (B_FUSED, 1, 1)), FUSED_CFGS["plane"], "voxel",
        mesh))
    res["err/data"] = error_of(lambda: align_sharded(
        "vplane_icp", targets["vplane_icp"], src[:8190], w[:8190], eye, CFGS["vplane_icp"],
        meshes["1x4"]))
    res["err/batch"] = error_of(lambda: align_batched_sharded(
        "vplane_icp", targets["vplane_icp"], src.expand(3, -1, -1), w.expand(3, -1),
        np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)), CFGS["vplane_icp"], mesh))
    res["err/mesh"] = error_of(lambda: make_mesh(2, 4, device_type="cpu"))
    res["err/map_mesh"] = error_of(lambda: make_map_mesh(8, device_type="cpu"))


def job_torchrun(res: dict, out: Path) -> None:
    """Two ranks from torchrun's environment: initialize twice, process_info,
    align_sharded over both (tests/test_multihost.py:40-77)."""
    distributed.initialize(device="cpu")  # idempotent: the group exists
    for k, v in distributed.process_info().items():
        res[f"info/{k}"] = np.asarray(str(v))
    pts, scan = multihost_scene()
    target = build_vplane_target(pts, MULTIHOST_CFG, device="cpu")
    put(res, "align", align_sharded("vplane_icp", target, scan, np.ones(len(scan), np.float32),
                                    torch.eye(4), MULTIHOST_CFG, make_mesh(device_type="cpu")))


JOBS = {"parallel": job_parallel, "torchrun": job_torchrun}


def port_modules_loaded_jax() -> bool:
    return any(m in ("jax", "point_cloud_registration_tpu")
               or m.startswith(("jax.", "point_cloud_registration_tpu."))
               for m in sys.modules)


def rank_main(jobs: dict) -> None:
    """Entry point of one rank: join the group, run the job, write the
    results to ``rank{r}.npz``."""
    import torch.distributed as dist

    spec = json.loads(os.environ[WORKER_ENV])
    torch.set_num_threads(1)
    out = Path(spec["out"])
    if spec["torchrun"]:
        distributed.initialize(device="cpu")
    else:
        distributed.initialize(world_size=spec["world"], rank=spec["rank"], device="cpu",
                               store=dist.FileStore(str(out / "store"), spec["world"]))
    res: dict = {}
    jobs[spec["job"]](res, out)
    assert not port_modules_loaded_jax(), "a rank imported JAX or the JAX package"
    res["jax_loaded"] = np.asarray(port_modules_loaded_jax())
    np.savez(out / f"rank{spec['rank']}.npz", **res)
    distributed.shutdown()


def spawn_ranks(script: str, job: str, world: int, out: Path, torchrun: bool = False) -> list:
    """Run ``job`` of ``script`` in ``world`` gloo processes; -> each rank's
    results. Fails when a rank fails or any is still running after
    ``RANK_TIMEOUT_S``; every process is ended before it returns."""
    out.mkdir(parents=True, exist_ok=True)
    port = None
    if torchrun:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
        env[WORKER_ENV] = json.dumps({"job": job, "rank": r, "world": world, "out": str(out),
                                      "torchrun": torchrun})
        env["PYTHONPATH"] = str(REPO) + (os.pathsep + env["PYTHONPATH"]
                                         if env.get("PYTHONPATH") else "")
        env["OMP_NUM_THREADS"] = "1"
        if torchrun:
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, script], env=env, cwd=str(REPO),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {job} failed:\n{o}\n{e[-6000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def same_on_every_rank(ranks: list, prefix: str) -> None:
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith(prefix):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def check(res: dict, key: str, T, iterations, atol: float) -> None:
    np.testing.assert_allclose(res[f"{key}/T"], np.asarray(T), rtol=0, atol=atol, err_msg=key)
    np.testing.assert_array_equal(res[f"{key}/it"], np.asarray(iterations), err_msg=key)


# --- the pytest process ---------------------------------------------------------


@pytest.fixture(scope="module")
def scene_and_normals(tmp_path_factory):
    """The scene, the scan and PlaneICP's normals, shared by both packages
    and by the ranks (written beside their store)."""
    from point_cloud_registration_tpu_torch.ops.normals import estimate_normals

    scene, scan = problem()
    normals = estimate_normals(scene, k=CFGS["plane_icp"].k, device="cpu").numpy()
    out = tmp_path_factory.mktemp("parallel")
    np.save(out / "normals.npy", normals)
    return scene, scan, normals, out


@pytest.fixture(scope="module")
def ranks(scene_and_normals):
    """The ``parallel`` job on four gloo ranks."""
    return spawn_ranks(__file__, "parallel", 4, scene_and_normals[3])


@pytest.fixture(scope="module")
def port_single(scene_and_normals):
    """The port's single-device align of each kind."""
    scene, scan, normals, _ = scene_and_normals
    src, w = pad_points(scan, device="cpu")
    targets = port_targets(scene, normals)
    return {k: SINGLE[k](targets[k], src, w, torch.eye(4), CFGS[k]) for k in KINDS}


def _jax_cfgs():
    from point_cloud_registration_tpu.core import config as jc

    packed = jc.CorrespondenceConfig(**PACKED)
    return (
        {"icp": jc.ICPConfig(corr=packed, max_iter=10, max_dist=2.0, tol=1e-3),
         "plane_icp": jc.PlaneICPConfig(corr=packed, max_iter=10, max_dist=2.0, tol=1e-3),
         "icp_grid": jc.ICPConfig(max_iter=10, max_dist=2.0, tol=1e-3),
         "vplane_icp": jc.VPlaneICPConfig(voxel_size=1.0, max_iter=10, max_dist=2.0, tol=1e-3),
         "ndt": jc.NDTConfig(voxel_size=1.0, max_iter=10, max_dist=2.0, tol=1e-3)},
        {"plane": jc.VPlaneICPConfig(voxel_size=1.0, max_iter=8, max_dist=2.0, tol=1e-3),
         "ndt": jc.NDTConfig(voxel_size=1.0, max_iter=8, max_dist=2.0, tol=1e-3),
         "point": jc.ICPConfig(corr=packed, max_iter=8, max_dist=2.0, tol=1e-3),
         "plane_pt": jc.PlaneICPConfig(corr=packed, max_iter=8, max_dist=2.0, tol=1e-3)},
    )


def _jax_target(kind, scene, normals, cfg):
    from point_cloud_registration_tpu import models as jm

    if kind == "plane_icp":
        return jm.build_plane_icp_target(scene, cfg, normals=normals)
    return {"icp": jm.build_icp_target, "icp_grid": jm.build_icp_target,
            "vplane_icp": jm.build_vplane_target, "ndt": jm.build_ndt_target}[kind](scene, cfg)


@pytest.fixture(scope="module")
def jax_sharded(scene_and_normals):
    """JAX align_sharded on make_mesh(batch=1, data=4), each kind, and the
    batched problems' results: align_batched_sharded on (2, 2) for the voxel
    kinds; for ICP and PlaneICP, whose packed targets the JAX function does
    not take under vmap (a pvary error in core/gn.py), align_sharded on
    1 x 4 from each problem's T0. -> ``(single, {kind: (Ts, iterations)})``."""
    import jax.numpy as jnp
    from point_cloud_registration_tpu.models.base import pad_points as jax_pad
    from point_cloud_registration_tpu.parallel import (
        align_batched_sharded as j_batched,
        align_sharded as j_sharded,
        make_mesh as j_mesh,
    )

    scene, scan, normals, _ = scene_and_normals
    cfgs, _ = _jax_cfgs()
    src, w = jax_pad(scan)
    single, batched = {}, {}
    mesh = j_mesh(batch=1, data=4)
    for kind in KINDS:
        target = _jax_target(kind, scene, normals, cfgs[kind])
        single[kind] = j_sharded(kind, target, src, w, jnp.eye(4, dtype=jnp.float32),
                                 cfgs[kind], mesh)
        if kind in ("icp", "plane_icp"):
            outs = [j_sharded(kind, target, src, w, jnp.asarray(T0), cfgs[kind], mesh)
                    for T0 in batched_init()]
            batched[kind] = (np.stack([np.asarray(o.T) for o in outs]),
                             np.asarray([int(o.diagnostics.iterations) for o in outs]))
            continue
        out = j_batched(
            kind, target, jnp.broadcast_to(src, (B_BATCHED,) + src.shape),
            jnp.broadcast_to(w, (B_BATCHED,) + w.shape), jnp.asarray(batched_init()),
            cfgs[kind], j_mesh(batch=2, data=2))
        batched[kind] = (np.asarray(out.T), np.asarray(out.diagnostics.iterations))
    single["icp_grid"] = j_sharded("icp", _jax_target("icp_grid", scene, normals,
                                                      cfgs["icp_grid"]),
                                   src, w, jnp.eye(4, dtype=jnp.float32), cfgs["icp_grid"],
                                   mesh)
    return single, batched


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_align_sharded(ranks, port_single, jax_sharded, kind, mesh):
    """Every kind on 4 (1x4) and 2 (2x2) data ranks: the single-device
    align's T within 1e-5 and its iterations, JAX's align_sharded within
    1e-3 and its iterations, the same bits on every rank."""
    key = f"sharded/{mesh}/{kind}"
    res = ranks[0]
    single = port_single[kind]
    check(res, key, single.T, single.diagnostics.iterations, TOL_SINGLE)
    assert bool(res[f"{key}/conv"]) == single.diagnostics.converged
    assert not bool(res[f"{key}/failed"])
    ref = jax_sharded[0][kind]
    check(res, key, ref.T, int(ref.diagnostics.iterations), TOL_JAX)
    same_on_every_rank(ranks, key)


def test_align_sharded_grid_target(ranks, scene_and_normals, jax_sharded):
    """ICP on the scene's default grid target (below 50k points: the CSR
    scan and the plain stats) over four data ranks."""
    scene, scan, _, _ = scene_and_normals
    src, w = pad_points(scan, device="cpu")
    single = icp_align(build_icp_target(scene, GRID_CFG, device="cpu"), src, w, torch.eye(4),
                       GRID_CFG)
    key = "sharded/1x4/icp_grid"
    check(ranks[0], key, single.T, single.diagnostics.iterations, TOL_SINGLE)
    ref = jax_sharded[0]["icp_grid"]
    check(ranks[0], key, ref.T, int(ref.diagnostics.iterations), TOL_JAX)
    same_on_every_rank(ranks, key)


def test_align_batched_sharded_hashed_map(ranks, scene_and_normals):
    """A hashed map has no cell index for the batched kernel: each rank takes
    its problems' plain stats one by one, equal to the single aligns."""
    scene, scan, _, _ = scene_and_normals
    src, w = pad_points(scan, device="cpu")
    vm = hashed_map(scene)
    assert vm.hashed
    key = "batched/vplane_icp_hashed"
    for b, T0 in enumerate(batched_init()):
        one = vplane_align(vm, src, w, torch.from_numpy(T0), CFGS["vplane_icp"])
        np.testing.assert_allclose(ranks[0][f"{key}/T"][b], one.T.numpy(), rtol=0,
                                   atol=TOL_SINGLE)
        assert int(ranks[0][f"{key}/it"][b]) == one.diagnostics.iterations
    same_on_every_rank(ranks, key)


@pytest.mark.parametrize("kind", KINDS)
def test_align_batched_sharded(ranks, scene_and_normals, jax_sharded, kind):
    """Problems over batch, points over data on (2, 2): each problem equal to
    the single align from its T0 (1e-5, a loop over the problems), JAX's
    batched results within 1e-3, gathered on every rank."""
    scene, scan, normals, _ = scene_and_normals
    src, w = pad_points(scan, device="cpu")
    target = port_targets(scene, normals)[kind]
    key = f"batched/{kind}"
    res = ranks[0]
    assert res[f"{key}/T"].shape == (B_BATCHED, 4, 4)
    for b, T0 in enumerate(batched_init()):
        one = SINGLE[kind](target, src, w, torch.from_numpy(T0), CFGS[kind])
        np.testing.assert_allclose(res[f"{key}/T"][b], one.T.numpy(), rtol=0, atol=TOL_SINGLE)
        assert int(res[f"{key}/it"][b]) == one.diagnostics.iterations
        assert bool(res[f"{key}/conv"][b]) == one.diagnostics.converged
    check(res, key, *jax_sharded[1][kind], TOL_JAX)
    same_on_every_rank(ranks, key)


@pytest.fixture(scope="module")
def jax_fused(scene_and_normals):
    """JAX align_batched_fused_sharded on (2, 2), B = 4 (the full-mesh fold),
    Pallas in interpret mode, each kind."""
    import jax.numpy as jnp
    from point_cloud_registration_tpu.models import build_icp_target as j_icp
    from point_cloud_registration_tpu.models import build_plane_icp_target as j_picp
    from point_cloud_registration_tpu.ops.pallas.fused_align import voxel_fused_spec
    from point_cloud_registration_tpu.ops.pallas.point_align import point_fused_spec
    from point_cloud_registration_tpu.ops.voxelize import build_voxel_map as j_voxel_map
    from point_cloud_registration_tpu.parallel import align_batched_fused_sharded as j_fused
    from point_cloud_registration_tpu.parallel import make_mesh as j_mesh

    scene, _, normals, _ = scene_and_normals
    _, cfgs = _jax_cfgs()
    scans = jnp.asarray(fused_scans(scene))
    w = jnp.ones((B_FUSED, N_FUSED), jnp.float32)
    T0 = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B_FUSED, 4, 4))
    out = {}
    for kind in FUSED_KINDS:
        cfg, tnormals = cfgs[kind], None
        if kind in ("plane", "ndt"):
            target = j_voxel_map(scene, 1.0, min_points=5, with_icov=kind == "ndt",
                                 rich="normals" if kind == "plane" else "sqrt_icov")
            spec = voxel_fused_spec(target, kind, max_dist=cfg.max_dist, tq=256)
        elif kind == "point":
            target = j_icp(scene, cfg)
            spec = point_fused_spec(target.packed, "point", cfg.max_dist)
        else:
            full = j_picp(scene, cfg, normals=normals)
            target, tnormals = full.corr, full.normals
            spec = point_fused_spec(target.packed, "plane_pt", cfg.max_dist)
        out[kind] = j_fused(target, tnormals, scans, w, T0, cfg, spec,
                            j_mesh(batch=2, data=2), interpret=True)
    return out


@pytest.mark.parametrize("B", [2, B_FUSED])
@pytest.mark.parametrize("kind", FUSED_KINDS)
def test_align_batched_fused_sharded(ranks, scene_and_normals, jax_fused, kind, B):
    """Each kind on (2, 2): B = 2 over batch alone, B = 4 over all four
    ranks. Each problem equal to the port's single-process batched align
    (1e-5) and to JAX's (1e-3), with equal iterations; gathered in problem
    order on every rank."""
    scene, _, normals, _ = scene_and_normals
    scans = fused_scans(scene)[:B]
    w = np.ones((B, N_FUSED), np.float32)
    T0 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    target, tnormals = fused_target(scene, normals, kind)
    if kind in ("plane", "ndt"):
        Ts, d = fused_voxel_align_batched(target, scans, w, T0, FUSED_CFGS[kind], kind)
    else:
        Ts, d = fused_point_align_batched(target, tnormals, scans, w, T0, FUSED_CFGS[kind], kind)
    key = f"fused/{kind}/{B}"
    res = ranks[0]
    check(res, key, Ts, d.iterations, TOL_SINGLE)
    np.testing.assert_array_equal(res[f"{key}/conv"], d.converged.numpy())
    np.testing.assert_array_equal(res[f"{key}/failed"], d.solver_failed.numpy())
    ref = jax_fused[kind]
    check(res, key, np.asarray(ref.T)[:B], np.asarray(ref.diagnostics.iterations)[:B], TOL_JAX)
    same_on_every_rank(ranks, key)


def test_refusals_on_the_ranks(ranks):
    """The JAX package's ValueErrors: a batch that divides neither the batch
    axis nor the mesh, an unknown fused kind, a scan or batch that does not
    divide, a mesh larger than the world."""
    res = ranks[0]
    assert "does not divide over 2 batch shards" in str(res["err/fused_batch"])
    assert "unknown fused kind" in str(res["err/fused_kind"])
    assert "does not divide over 4 data shards" in str(res["err/data"])
    assert "does not divide over 2 batch shards" in str(res["err/batch"])
    assert "mesh 2x4 needs 8 devices, have 4" == str(res["err/mesh"])
    assert "mesh 8x0 needs 8 devices, have 4" == str(res["err/map_mesh"])
    for r in ranks:
        assert not bool(r["jax_loaded"])


def test_two_processes_match_one(tmp_path, scene_and_normals):
    """Two ranks started from torchrun's environment (localhost store):
    ``initialize()`` reads it and is idempotent, ``process_info`` names each
    rank, and align_sharded over both equals the one-process align within
    1e-5 with equal iterations (tests/test_multihost.py:80-153) and JAX's
    align_sharded on the 8-device mesh within 1e-3."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxVPlaneConfig
    from point_cloud_registration_tpu.models import build_vplane_target as j_build
    from point_cloud_registration_tpu.parallel import align_sharded as j_sharded

    ranks = spawn_ranks(__file__, "torchrun", 2, tmp_path, torchrun=True)
    pts, scan = multihost_scene()
    one = vplane_align(build_vplane_target(pts, MULTIHOST_CFG, device="cpu"),
                       torch.from_numpy(scan), torch.ones(len(scan)), torch.eye(4), MULTIHOST_CFG)
    for r, res in enumerate(ranks):
        assert {k: str(res[f"info/{k}"]) for k in ("rank", "world_size", "local_rank", "device",
                                                   "backend")} == {
            "rank": str(r), "world_size": "2", "local_rank": str(r), "device": "cpu",
            "backend": "gloo"}
        check(res, "align", one.T, one.diagnostics.iterations, TOL_SINGLE)
    same_on_every_rank(ranks, "align")
    jcfg = JaxVPlaneConfig(voxel_size=1.0, min_points=5)
    ref = j_sharded("vplane_icp", j_build(pts, jcfg), jnp.asarray(scan),
                    jnp.ones((len(scan),), jnp.float32), jnp.eye(4, dtype=jnp.float32), jcfg,
                    Mesh(np.array(jax.devices()).reshape(8), ("data",)))
    check(ranks[0], "align", ref.T, int(ref.diagnostics.iterations), TOL_JAX)


# --- without ranks -----------------------------------------------------------------


@pytest.fixture
def no_torchrun_env(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


def test_initialize_without_anything_to_discover(no_torchrun_env):
    """One process with nothing to discover: a no-op, as the JAX wrapper's;
    a larger world with nothing to join raises."""
    import torch.distributed as dist

    distributed.initialize()
    distributed.initialize(world_size=1)
    assert not dist.is_initialized()
    assert distributed.process_info() == {"rank": 0, "world_size": 1, "local_rank": 0,
                                          "device": None, "backend": None}
    with pytest.raises(RuntimeError, match="world size 2 needs"):
        distributed.initialize(world_size=2)
    assert not dist.is_initialized()


def test_nccl_without_a_card_raises(no_torchrun_env, monkeypatch):
    """The default backend is NCCL: without a usable card it raises and
    names the way to gloo; it never switches on its own."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize(world_size=1, rank=0, store=dist.HashStore())
    assert not dist.is_initialized()


@pytest.mark.parametrize("make, args, message", [
    (make_mesh, (2, 4), "mesh 2x4 needs 8 devices, have 1"),
    (make_mesh, (3,), "mesh 3x0 needs 3 devices, have 1"),
    (make_map_mesh, (4, 2), "mesh 4x2 needs 8 devices, have 1"),
    (make_map_mesh, (4,), "mesh 4x0 needs 4 devices, have 1"),
])
def test_mesh_needs_more_ranks_than_exist(no_torchrun_env, make, args, message):
    import torch.distributed as dist

    with pytest.raises(ValueError, match=message):
        make(*args, device_type="cpu")
    assert not dist.is_initialized()


def test_parallel_imports_no_jax():
    """The parallel package and each of its modules load neither JAX nor the
    JAX package (checked in a fresh interpreter; the ranks check it too)."""
    code = ("import sys, point_cloud_registration_tpu_torch.parallel, "
            "point_cloud_registration_tpu_torch.parallel.distributed, "
            "point_cloud_registration_tpu_torch.parallel.mesh, "
            "point_cloud_registration_tpu_torch.parallel.sharded, "
            "point_cloud_registration_tpu_torch.parallel.map_sharded; "
            "sys.exit(1 if any(m == 'jax' or m == 'point_cloud_registration_tpu' or "
            "m.startswith(('jax.', 'point_cloud_registration_tpu.')) for m in sys.modules) "
            "else 0)")
    assert subprocess.run([sys.executable, "-c", code], timeout=120, cwd=str(REPO)).returncode == 0


def test_exports_match_the_jax_package():
    """``parallel`` exports the names of the JAX package's
    ``parallel/__init__.py:3-18``; the package root exports none of them."""
    import point_cloud_registration_tpu.parallel as jp
    import point_cloud_registration_tpu_torch as port
    import point_cloud_registration_tpu_torch.parallel as tp

    names = {"distributed", "ShardedMapMeta", "ShardedVoxelMap", "align_map_sharded",
             "make_map_mesh", "shard_voxel_map", "shard_voxel_map_on_mesh", "make_mesh",
             "STATS_FNS", "align_batched_fused_sharded", "align_batched_sharded",
             "align_sharded"}
    assert all(hasattr(jp, n) and hasattr(tp, n) for n in names)
    assert set(tp.STATS_FNS) == set(jp.STATS_FNS)
    assert not names & set(port.__all__)


if __name__ == "__main__" and os.environ.get(WORKER_ENV):
    rank_main(JOBS)
