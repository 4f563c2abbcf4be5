"""Exact brute-force 1-NN (counterpart of
``point_cloud_registration_tpu/ops/pallas/exact_nn.py``).

``exact_nn(query, ref)`` returns, for every query, the distance to and the
index of the nearest of all reference points: the minimum of
``(qx - rx)^2 + (qy - ry)^2 + (qz - rz)^2`` with the first index on ties,
``inf`` and -1 for an empty reference. It is the validation oracle of the
grid engines, not a solver's path.

For CUDA tensors it launches the hand-written kernel ``csrc/exact_nn.cu``;
for CPU tensors it runs the plain PyTorch version,
:func:`exact_nn_reference` (``ops.knn.brute_force_nn``), which the tests and
``chip_smoke.py`` also call directly. There is no fallback between the two.
The kernel's shape query and its launch run with the card of ``query``
current.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import require_cuda
from point_cloud_registration_tpu_torch.ops.knn import brute_force_nn


def exact_nn_reference(query: torch.Tensor, ref: torch.Tensor,
                       chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on the device of ``query``:
    ``(dist (Nq,) f32, idx (Nq,) i32)``."""
    return brute_force_nn(query, ref, chunk=chunk)


@functools.cache
def _kernel_fn():
    lib = load_library("exact_nn")
    fn = lib.pcr_exact_nn
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [c_ptr, c_int, c_ptr, c_int, c_int] + [c_ptr] * 5
    fn.restype = c_int
    for shape_fn in (lib.pcr_exact_nn_segments, lib.pcr_exact_nn_segment_length):
        shape_fn.argtypes = [c_int, c_int]
        shape_fn.restype = c_int
    return fn, lib.pcr_exact_nn_segments, lib.pcr_exact_nn_segment_length


def launch_shape(nq: int, nr: int, device) -> tuple[int, int]:
    """``(segments, references per segment)`` of the kernel's launch for
    ``nq`` queries and ``nr`` references on the CUDA card ``device``: segment
    ``s`` holds the references from ``s`` times the length on."""
    _, segments_fn, length_fn = _kernel_fn()
    with torch.cuda.device(device):
        segments = segments_fn(nq, nr)
    if segments < 1:
        raise RuntimeError(f"exact_nn: CUDA error {-segments} reading the device")
    return segments, length_fn(nr, segments)


def _check(name: str, x: torch.Tensor, device) -> None:
    if x.device != device or x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name} must be an (N, 3) float32 tensor on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def exact_nn(query: torch.Tensor, ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact nearest reference point of every query: ``(dist (Nq,) f32,
    idx (Nq,) i32)`` on the device of ``query``. CPU tensors take the plain
    version; CUDA tensors launch the kernel and add one to
    ``exact_nn.launches``."""
    if query.device.type == "cpu":
        return exact_nn_reference(query, ref)
    require_cuda(query)
    _check("query", query, query.device)
    _check("ref", ref, query.device)
    nq, nr = query.shape[0], ref.shape[0]
    dist = torch.full((nq,), float("inf"), dtype=torch.float32, device=query.device)
    idx = torch.full((nq,), -1, dtype=torch.int32, device=query.device)
    if nq == 0 or nr == 0:
        return dist, idx
    fn = _kernel_fn()[0]
    if ref.data_ptr() % 16:
        # the kernel's bulk copies need a 16-byte aligned source: an unaligned
        # view (a slice that starts at an odd point) is copied once
        ref = ref.clone()
    segments, _ = launch_shape(nq, nr, query.device)  # segments that fill the card
    part_d2 = torch.empty((segments, nq), dtype=torch.float32, device=query.device)
    part_idx = torch.empty((segments, nq), dtype=torch.int32, device=query.device)
    with torch.cuda.device(query.device):
        rc = fn(query.data_ptr(), nq, ref.data_ptr(), nr, segments, part_d2.data_ptr(),
                part_idx.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream(query.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exact_nn kernel launch failed: CUDA error {rc}")
    exact_nn.launches += 1
    return dist, idx


exact_nn.launches = 0
