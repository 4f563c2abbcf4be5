"""Multi-process start-up on ``torch.distributed`` (counterpart of
``point_cloud_registration_tpu/parallel/distributed.py``).

JAX runs one controller over all local devices and
``jax.distributed.initialize`` joins the hosts. PyTorch runs one process
per rank: every rank runs the same program, :func:`initialize` joins them
into one process group, and the sharded aligners of this package reduce
their per-iteration Gauss-Newton stats (29 floats) over it.

Typical entry point under ``torchrun`` (one process per card)::

    from point_cloud_registration_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize()          # RANK, WORLD_SIZE, MASTER_ADDR/PORT, LOCAL_RANK
    mesh = make_mesh(batch=1)         # every rank on the data axis
    ...

Without ``torchrun``, pass ``init_method`` (or a ``store``), ``world_size``
and ``rank``. The backend is NCCL on the card ``cuda:{LOCAL_RANK}``;
``device="cpu"`` asks for gloo instead. Nothing is picked from what is
installed: NCCL without a usable card raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None, *,
               device=None, store=None) -> None:
    """Idempotent ``init_process_group`` wrapper.

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``). When
    there is nothing to discover (no ``init_method``, ``store`` or
    ``MASTER_ADDR`` / ``MASTER_PORT``) and ``world_size`` is None or 1, it
    is a no-op single-process run; with a larger ``world_size`` it raises,
    as the JAX wrapper does. A second call once the group exists is a no-op.

    ``backend`` defaults to ``"nccl"``, on the card ``cuda:{LOCAL_RANK}``
    (``LOCAL_RANK`` defaults to the rank) or the card ``device`` names, set
    as the current device; ``device="cpu"`` gives ``"gloo"``.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and store is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None and store is None:
        if world_size in (None, 1):
            return  # one process with nothing to discover: run locally
        raise RuntimeError(f"world size {world_size} needs an init_method, a store or "
                           "MASTER_ADDR / MASTER_PORT to join the other ranks")
    rank = 0 if rank is None else rank
    dev = torch.device(device) if device is not None else None
    if backend is None:
        backend = "gloo" if dev is not None and dev.type == "cpu" else "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a usable CUDA device; pass device='cpu' "
                               "for gloo")
        index = dev.index if dev is not None and dev.index is not None else None
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) if index is None else index)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=-1 if world_size is None else world_size, rank=rank)


def shutdown() -> None:
    """Destroy the process group of :func:`initialize`, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> dict:
    """Rank, world size, local rank, device and backend of this process, for
    logs and diagnostics (a single process without a group: rank 0 of 1,
    device and backend None). The device is the one the backend reduces on:
    the current card for NCCL, the CPU for gloo."""
    if not dist.is_initialized():
        return {"rank": 0, "world_size": 1, "local_rank": 0, "device": None, "backend": None}
    rank, backend = dist.get_rank(), str(dist.get_backend())
    return {
        "rank": rank,
        "world_size": dist.get_world_size(),
        "local_rank": int(os.environ.get("LOCAL_RANK", rank)),
        "device": f"cuda:{torch.cuda.current_device()}" if backend == "nccl" else "cpu",
        "backend": backend,
    }
