"""Native (C++) host-side code, loaded with ctypes: the PCD reader of
``pcd_io.cpp`` (a copy of the JAX package's ``native/pcd_io.cpp``).

The library is compiled at first use with the system's C++ compiler (``CXX``,
else ``g++``) into ``point_cloud_registration_tpu_torch/_build/<hash of the
source and flags>/libpcd_io.so``, beside the CUDA kernels' libraries and not
beside the sources. This is host code, not a kernel: :func:`load` returns
None when no compiler is present or the build fails, and ``utils.io`` then
parses with NumPy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "pcd_io.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libpcd_io.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, path)


def load() -> ctypes.CDLL | None:
    """Load the library, building it first when it is missing; None when it
    cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    try:
        if not path.is_file():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.pcd_num_points.restype = ctypes.c_long
    lib.pcd_num_points.argtypes = [ctypes.c_char_p]
    for fn in (lib.pcd_read_xyz, lib.pcd_write_xyz):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    _lib = lib
    return _lib
