"""Solver base: alignment result + the reference-compatible class shim
(counterpart of ``point_cloud_registration_tpu/models/base.py``).

The class layer mirrors the reference ``Registration`` surface
(registration.py:9-112): ``__init__(hyperparams)``, ``set_target``,
``align(source, init_T, verbose)``, ``is_target_set``, ``calc_H_g_e2``.
Each solver runs on one explicit ``device``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.device import default_device, resolve_device
from point_cloud_registration_tpu_torch.core.gn import GNDiagnostics, LoopSlot
from point_cloud_registration_tpu_torch.utils.diagnostics import span


__all__ = ["AlignResult", "Registration", "ScanSlot", "default_device", "pad_points"]


class AlignResult(NamedTuple):
    """Transform + structured diagnostics (replaces verbose printing)."""

    T: torch.Tensor  # (4, 4) f32, on the host
    diagnostics: GNDiagnostics


# An align's scan is padded to a multiple of this many rows.
BUCKET = 8192


def pad_points(points, bucket: int = BUCKET, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad (N, 3) to the next multiple of ``bucket`` with a 0/1 weight mask.

    Scans of similar size then share one launch shape, so the kernel's
    block partials, and the order of its sums, stay the same.
    """
    points = torch.as_tensor(points).to(device=device, dtype=torch.float32)
    n = points.shape[0]
    n_pad = -(-n // bucket) * bucket
    padded = torch.cat(
        [points, torch.zeros((n_pad - n, 3), dtype=torch.float32, device=points.device)]
    )
    w = (torch.arange(n_pad, device=points.device) < n).to(torch.float32)
    return padded, w


class ScanSlot:
    """An align's scan as :func:`pad_points` pads it, in buffers made once a
    padded length, device and stream and refilled by every align after it: a
    host buffer ``(n_pad, 3)`` (pinned for a card) whose rows past the scan
    are zero, the scan and its 0/1 weights on the device, and an event
    recorded after each copy from the host buffer.

    :meth:`fill` writes a host scan into the host buffer in one copy (NumPy's
    for float32, torch's ``copy_`` for a cast to float32) and sends all
    ``n_pad`` rows to the device in one copy that does not wait; a scan on a
    card is copied into the device buffer there. The weights are remade only
    when the length changes. Every align gets the same two tensors, bit for
    bit ``pad_points``'s.
    ``ScanSlot.builds`` and ``ScanSlot.reuses`` count the slots made and the
    aligns that found one (:meth:`take`)."""

    builds = 0
    reuses = 0

    def __init__(self, key: tuple, n_pad: int, device: torch.device, stream):
        self.key, self.stream = key, stream
        card = device.type == "cuda"
        self.host = torch.zeros((n_pad, 3), dtype=torch.float32, pin_memory=card)
        self.host_np = self.host.numpy()
        self.src = torch.zeros((n_pad, 3), dtype=torch.float32, device=device)
        self.w = torch.zeros(n_pad, dtype=torch.float32, device=device)
        self.n = 0  # the rows of weight 1
        self.host_rows = self.src_rows = 0  # the rows of each buffer that may not be zero
        # recorded after each copy from ``host``: an align that raised, or
        # read nothing back, may leave one in flight
        self.sent = torch.cuda.Event() if card else None

    @staticmethod
    def fits(points: torch.Tensor) -> bool:
        """Whether the slot takes ``points``: (N, 3) with N >= 1, on the CPU or
        a card, outside autograd."""
        return (points.dim() == 2 and points.shape[1] == 3 and points.shape[0] > 0
                and points.device.type in ("cpu", "cuda") and not points.requires_grad)

    @classmethod
    def take(cls, slot: "ScanSlot | None", n: int, device: torch.device) -> "ScanSlot":
        """``slot`` when it was made for ``n`` points' padded length, the
        device and its current stream, else a new slot for them."""
        n_pad = -(-n // BUCKET) * BUCKET
        stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        key = (n_pad, device, None if stream is None else stream.cuda_stream)
        if slot is not None and slot.key == key:
            cls.reuses += 1
            return slot
        cls.builds += 1
        return cls(key, n_pad, device, stream)

    def fill(self, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(src, w)``: ``points`` (N, 3) in the slot's buffers, padded."""
        n = points.shape[0]
        if points.device.type == "cpu":
            if self.sent is not None and not self.sent.query():
                self.sent.synchronize()  # the last copy from ``host`` has not run yet
            if points.dtype == torch.float32:
                self.host_np[:n] = points.numpy()  # nothing to round: NumPy's memcpy
            else:
                self.host[:n].copy_(points)  # the cast of ``.to(torch.float32)``
            if self.host_rows > n:
                self.host[n:self.host_rows].zero_()
            self.host_rows = self.src_rows = n
            self.src.copy_(self.host, non_blocking=True)
            if self.sent is not None:
                self.sent.record(self.stream)
        else:
            self.src[:n].copy_(points)
            if self.src_rows > n:
                self.src[n:self.src_rows].zero_()
            self.src_rows = n
        if n != self.n:
            self.w[:n].fill_(1.0)
            self.w[n:].fill_(0.0)
            self.n = n
        return self.src, self.w


class Registration:
    """Reference-compatible stateful wrapper around the functional core.

    Subclasses set ``self._target`` in ``set_target`` and implement
    ``_align_fn(target, source, src_weight, init_T) -> AlignResult`` plus
    ``_stats_fn(target, source, src_weight, T) -> GNStats``. ``_loop`` keeps
    the loop that the aligns prepare for the target (``core.gn.LoopSlot``);
    setting ``_target`` drops it. ``_scan`` keeps the :class:`ScanSlot` of
    the aligns on a card (None until the first).
    """

    def __init__(self, max_iter: int = 30, tol: float = 1e-3, *, device=None):
        self.max_iter = max_iter
        self.tol = tol
        self.device = resolve_device(None, device)
        self._loop = LoopSlot()
        self._scan: ScanSlot | None = None
        self._target = None
        self.last_diagnostics: GNDiagnostics | None = None

    @property
    def _target(self) -> Any:
        return self._target_now

    @_target.setter
    def _target(self, target) -> None:
        self._target_now = target
        self._loop.plan = None

    def is_target_set(self) -> bool:
        return self._target is not None

    def set_target(self, target) -> None:
        raise NotImplementedError("set_target is not implemented.")

    def update_target(self, target) -> None:
        """Incremental map update: declared but unimplemented in the
        reference too (registration.py:36-43)."""
        raise NotImplementedError("update_target is not implemented.")

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        raise NotImplementedError

    def _stats_fn(self, target, source, src_weight, T):
        raise NotImplementedError

    def align(self, source, init_T=None, verbose: bool = False) -> np.ndarray:
        """Gauss-Newton alignment; returns the (4, 4) transform as float64 NumPy.

        Signature and semantics of registration.py:71-112; the per-iteration
        error trace is in ``self.last_diagnostics`` (``verbose`` prints it).
        Under a profiler the call is the span ``pcr.align``, the scan's
        copy and padding ``pcr.align.upload``.
        """
        if not self.is_target_set():
            raise ValueError("Target is not set.")
        if init_T is None:
            init_T = np.eye(4)
        with span("pcr.align"):
            with span("pcr.align.upload"):
                src, w = self._upload(source)
            result = self._align_fn(
                self._target, src, w, torch.as_tensor(init_T, dtype=torch.float32)
            )
            self.last_diagnostics = result.diagnostics
            if verbose:
                d = self.last_diagnostics
                for i in range(d.iterations):
                    print(f"iter {i}, error {float(d.e2_history[i])}")
            return result.T.numpy().astype(np.float64)

    def _upload(self, source) -> tuple[torch.Tensor, torch.Tensor]:
        """``pad_points(source)`` on the solver's device: on a card through
        the solver's :class:`ScanSlot` when it takes the scan, else
        ``pad_points`` itself."""
        points = torch.as_tensor(source)
        if self.device.type != "cuda" or not ScanSlot.fits(points):
            return pad_points(points, device=self.device)
        self._scan = ScanSlot.take(self._scan, points.shape[0], self.device)
        return self._scan.fill(points)

    def calc_H_g_e2(self, cur_T, source):
        """One linearization at ``cur_T`` -> (H, g, e2) as NumPy float64."""
        if not self.is_target_set():
            raise ValueError("Target is not set.")
        src, w = pad_points(source, device=self.device)
        stats = self._stats_fn(
            self._target, src, w, torch.as_tensor(cur_T, dtype=torch.float32)
        )
        return (
            stats.H.cpu().numpy().astype(np.float64),
            stats.g.cpu().numpy().astype(np.float64),
            float(stats.e2),
        )
