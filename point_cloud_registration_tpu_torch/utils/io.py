"""PCD point-cloud file IO (NumPy, dependency-free; a copy of
``point_cloud_registration_tpu/utils/io.py``, whose package the port does not
import).

The reference delegates IO to the optional ``q3dviewer`` GUI package
(benchmark/test_data.py:12-13 ``load_pcd``; data/get_data.py LAS->PCD); this
framework ships its own reader/writer so the benchmark/data path has no GUI
dependency. Supports PCD v0.7 ``ascii`` and ``binary`` encodings with
arbitrary scalar fields (``binary_compressed`` requires LZF and is rejected
with a clear error).
"""

from __future__ import annotations

import numpy as np

_PCD_TO_NP = {
    ("F", 4): "<f4",
    ("F", 8): "<f8",
    ("I", 1): "<i1",
    ("I", 2): "<i2",
    ("I", 4): "<i4",
    ("U", 1): "<u1",
    ("U", 2): "<u2",
    ("U", 4): "<u4",
}


def read_pcd_xyz(path: str) -> np.ndarray:
    """Fast (N, 3) float32 xyz read — native C++ parser when available
    (native/pcd_io.cpp), NumPy fallback otherwise. This is the benchmark/data
    hot path (the reference reads B-01.pcd through q3dviewer,
    benchmark/test_data.py:24)."""
    from point_cloud_registration_tpu_torch import native

    lib = native.load()
    if lib is not None:
        import ctypes

        n = lib.pcd_num_points(path.encode())
        if n >= 0:
            out = np.empty((n, 3), np.float32)
            rc = lib.pcd_read_xyz(
                path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
            )
            if rc == 0:
                return out
    rec = read_pcd(path)
    return np.ascontiguousarray(rec["xyz"], dtype=np.float32)


def read_pcd(path: str) -> np.recarray:
    """Read a PCD file into a record array with one entry per field.

    3-D coordinates are additionally exposed as a packed ``xyz`` (N, 3)
    float32 field when ``x``/``y``/``z`` columns exist, matching the
    ``data['xyz']`` access pattern of the reference benchmarks
    (benchmark/test_data.py:32).
    """
    with open(path, "rb") as f:
        header: dict[str, list[str]] = {}
        while True:
            raw_line = f.readline()
            if not raw_line:  # EOF before DATA: truncated / not a PCD file
                raise ValueError(f"{path}: PCD header ended before DATA line")
            line = raw_line.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n_points = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        dtype_fields = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            base = _PCD_TO_NP[(t.upper(), s)]
            dtype_fields.append((name, base, (c,)) if c > 1 else (name, base))
        dtype = np.dtype(dtype_fields)

        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            raw = np.atleast_2d(raw)
            rec = np.zeros(n_points, dtype=dtype)
            col = 0
            for name, _, c in [(n, t, c) for n, t, c in zip(fields, types, counts)]:
                if c > 1:
                    rec[name] = raw[:, col : col + c]
                else:
                    rec[name] = raw[:, col]
                col += c
        elif mode == "binary":
            rec = np.frombuffer(f.read(dtype.itemsize * n_points), dtype=dtype, count=n_points)
        else:
            raise NotImplementedError(
                f"PCD DATA mode '{mode}' not supported (binary_compressed needs LZF)"
            )

    rec = rec.view(np.recarray)
    if all(n in fields for n in ("x", "y", "z")):
        xyz = np.stack(
            [rec["x"], rec["y"], rec["z"]], axis=-1
        ).astype(np.float32)
        out = np.rec.fromarrays(
            [xyz] + [rec[n] for n in fields],
            dtype=[("xyz", "<f4", (3,))] + [(n, rec.dtype[n]) for n in fields],
        )
        return out
    return rec


def write_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write an (N, 3) float cloud as PCD v0.7 (x, y, z float32)."""
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.float32))
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected (N, 3) points, got {pts.shape}")
    n = len(pts)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")
