"""Device meshes and the collectives of the sharded aligners (counterpart
of ``point_cloud_registration_tpu/parallel/mesh.py``).

A JAX mesh names the axes of a grid of devices under one controller; here
it is a :class:`~torch.distributed.device_mesh.DeviceMesh` of ranks, one
process each, whose dimensions carry the same names:

* ``data`` — scan points sharded across ranks; each Gauss-Newton iteration
  all-reduces the 29 stat values, so every rank runs the same loop on the
  same sums and holds the same T;
* ``batch`` — many (scan, init_T) problems against one replicated map.

A ``psum`` / ``pmin`` over mesh axes becomes one ``all_reduce`` over the
group that spans them (:func:`all_reduce`). The mesh's device type says
where it reduces: a ``"cuda"`` mesh (NCCL) reduces device tensors, a
``"cpu"`` mesh (gloo) host copies. The kernels run on each rank's compute
device either way, the device of its data.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from point_cloud_registration_tpu_torch.parallel import distributed

AXES = ("batch", "data")
# groups that span both axes of a mesh smaller than the world, by (the world
# group, device type, ranks): made with the mesh, since every rank of the
# world joins them, and unreachable once the world group is destroyed
_SPAN_GROUPS: dict = {}


def make_mesh(batch: int = 1, data: int | None = None, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A (batch, data) mesh over the first ``batch * data`` ranks.

    ``data`` defaults to ``world_size // batch``. A 1x1 mesh is valid: in a
    process with no group yet it makes a group of one rank (NCCL for a
    ``"cuda"`` mesh, gloo for ``"cpu"``), so the same align code path runs
    everywhere. Every rank of the world calls it.
    """
    return device_mesh((batch, data), AXES, device_type)


def device_mesh(shape: tuple, names: tuple, device_type: str) -> DeviceMesh:
    """The mesh of :func:`make_mesh` (and ``map_sharded.make_map_mesh``):
    ``shape`` (outer, inner or None), dimensions named ``names``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    outer, inner = shape
    if inner is None:
        inner = world // outer
    n = outer * inner
    if n > world or inner < 1:
        raise ValueError(f"mesh {outer}x{inner} needs {max(n, outer)} devices, have {world}")
    if not dist.is_initialized():
        distributed.initialize(world_size=1, rank=0, store=dist.HashStore(),
                               device="cpu" if device_type == "cpu" else None)
    mesh = init_device_mesh(device_type, (outer, inner), mesh_dim_names=names)
    if n < world:
        key = _span_key(mesh)
        if key not in _SPAN_GROUPS:
            _SPAN_GROUPS[key] = dist.new_group(list(key[2]))
    return mesh


def _span_key(mesh: DeviceMesh) -> tuple:
    return (id(dist.group.WORLD), mesh.device_type,
            tuple(sorted(int(r) for r in mesh.mesh.flatten())))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axes_group(mesh: DeviceMesh, axes: tuple):
    """The process group that spans ``axes`` of ``mesh`` (None: the world)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if sorted(axes) != sorted(mesh.mesh_dim_names):
        raise ValueError(f"axes {axes} must be one axis or all of {mesh.mesh_dim_names}")
    key = _span_key(mesh)
    if len(key[2]) == dist.get_world_size():
        return None
    if key not in _SPAN_GROUPS:
        raise ValueError("a mesh smaller than the world needs make_mesh / make_map_mesh, "
                         "which make its spanning group")
    return _SPAN_GROUPS[key]


def axes_rank(mesh: DeviceMesh, axes: tuple) -> int:
    """This rank's index along ``axes`` (row-major over them), the order in
    which :func:`all_gather_rows` stacks the ranks' rows."""
    group = axes_group(mesh, axes)
    return dist.get_rank() if group is None else dist.get_group_rank(group, dist.get_rank())


def axes_size(mesh: DeviceMesh, axes: tuple) -> int:
    size = 1
    for a in axes:
        size *= axis_size(mesh, a)
    return size


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axes: tuple,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced by ``op`` over the ranks that span ``axes`` -> a new
    tensor, on ``t``'s device for a ``"cuda"`` mesh and on the host for a
    ``"cpu"`` one (every rank receives the same bits)."""
    buf = t.clone() if t.device.type == mesh.device_type else t.to(mesh.device_type)
    dist.all_reduce(buf, op=op, group=axes_group(mesh, axes))
    return buf


def all_gather_rows(t: torch.Tensor, mesh: DeviceMesh, axes: tuple) -> torch.Tensor:
    """Every rank's ``t`` over ``axes``, concatenated along dim 0 in the
    order of :func:`axes_rank` -> a host tensor."""
    buf = t.to(mesh.device_type).contiguous()
    out = [torch.empty_like(buf) for _ in range(axes_size(mesh, axes))]
    dist.all_gather(out, buf, group=axes_group(mesh, axes))
    return torch.cat(out).cpu()
