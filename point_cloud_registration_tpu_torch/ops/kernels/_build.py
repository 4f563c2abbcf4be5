"""Build and load the package's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
which is loaded with ``ctypes``. A library lands in
``point_cloud_registration_tpu_torch/_build/<hash of its source, the shared
headers and the flags>/lib<name>.so``, so a changed source builds anew and
an unchanged one loads at once. :func:`build_all` starts one ``nvcc`` per
missing library, all at once, and waits for them together. Nothing is built
when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # report registers, shared memory and spills of every kernel (nvcc.log)
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: under PyTorch's ``CUDA_HOME``, else on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither under CUDA_HOME nor on PATH): the CUDA "
            "kernels of point_cloud_registration_tpu_torch cannot be built"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_names() -> list[str]:
    """One library per source: ``["fused_align", "point_align", ...]``."""
    return [p.stem for p in _sources()]


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` for the current source,
    shared headers and flags lives."""
    source = CSRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise ValueError(f"no kernel source {source}")
    h = hashlib.sha256()
    for f in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build_all(names: list[str] | None = None) -> None:
    """Compile every missing library of ``names`` (default: all sources),
    one ``nvcc`` process each, all started together; raises if any fails.
    Each build writes its command and ``nvcc``'s report to ``nvcc.log``
    beside its library."""
    todo = [n for n in (names or library_names()) if not library_path(n).is_file()]
    if not todo:
        return
    nvcc = find_nvcc()
    procs = []
    for name in todo:
        path = library_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        procs.append((name, path, tmp, cmd, proc))
    failed = []
    for name, path, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        (path.parent / "nvcc.log").write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (code {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile the library of ``csrc/<name>.cu`` if it is missing, then load it."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
