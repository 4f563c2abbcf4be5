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
from point_cloud_registration_tpu_torch.core.gn import GNDiagnostics
from point_cloud_registration_tpu_torch.utils.diagnostics import span


__all__ = ["AlignResult", "Registration", "default_device", "pad_points"]


class AlignResult(NamedTuple):
    """Transform + structured diagnostics (replaces verbose printing)."""

    T: torch.Tensor  # (4, 4) f32, on the host
    diagnostics: GNDiagnostics


def pad_points(points, bucket: int = 8192, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
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


class Registration:
    """Reference-compatible stateful wrapper around the functional core.

    Subclasses set ``self._target`` in ``set_target`` and implement
    ``_align_fn(target, source, src_weight, init_T) -> AlignResult`` plus
    ``_stats_fn(target, source, src_weight, T) -> GNStats``.
    """

    def __init__(self, max_iter: int = 30, tol: float = 1e-3, *, device=None):
        self.max_iter = max_iter
        self.tol = tol
        self.device = resolve_device(None, device)
        self._target: Any = None
        self.last_diagnostics: GNDiagnostics | None = None

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
                src, w = pad_points(source, device=self.device)
            result = self._align_fn(
                self._target, src, w, torch.as_tensor(init_T, dtype=torch.float32)
            )
            self.last_diagnostics = result.diagnostics
            if verbose:
                d = self.last_diagnostics
                for i in range(d.iterations):
                    print(f"iter {i}, error {float(d.e2_history[i])}")
            return result.T.numpy().astype(np.float64)

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
