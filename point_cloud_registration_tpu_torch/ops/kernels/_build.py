"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, which
is loaded with ``ctypes``. The library lands in
``point_cloud_registration_tpu_torch/_build/<hash of sources and flags>/``,
so a changed source builds anew and an unchanged one loads at once. Nothing
is built when the package is imported.
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
LIB_NAME = "libpcr_kernels.so"
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


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for f in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile the kernels if their library is missing, then load it."""
    path = library_path()
    if not path.is_file():
        nvcc = find_nvcc()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (path.parent / "nvcc.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{proc.stderr}"
            )
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))
