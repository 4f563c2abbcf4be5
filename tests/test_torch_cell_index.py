"""The voxel map's cell index (``ops/knn.py`` ``CellIndex``: an occupancy
bitmap with ranks, the valid cells' centroids and features) and the search
the fused kernel (``csrc/fused_align.cu``) runs on it.

The CUDA kernel cannot run here. Its search is modelled below as it walks:
per (y, z) row of the window the row's bits, word by word; the valid cells
of a word's stretch are the consecutive rows from ``rank + popcount(bits
below the stretch)``, visited in ascending x with a strict ``<`` on
``dx*dx + dy*dy + dz*dz`` in float32. The model must give the
winners and distances of the dense probe (``ops/knn.py``
``nearest_valid_cell``, which probes every cell), bit for bit: on random
maps, on exact ties between valid cells of two rows and of two words of
one row, and on windows that a word boundary or a face of the grid cuts.
``chip_smoke.py`` holds the kernel itself to the plain version on the card.

The order of the scan's points changes only the order of the float32
sums: a permuted scan gives the stats within rounding, and the align ends
at the same T (1e-5) with the same iteration count.
"""

import numpy as np
import pytest
import torch

from point_cloud_registration_tpu_torch.core.config import NDTConfig, VPlaneICPConfig
from point_cloud_registration_tpu_torch.models import pad_points
from point_cloud_registration_tpu_torch.models._fused import fused_voxel_align
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    fused_ndt_stats_reference,
    fused_plane_stats_reference,
)
from point_cloud_registration_tpu_torch.ops.knn import (
    CellIndex,
    cell_index,
    cell_table,
    compact_rows,
    nearest_valid_cell,
)
from point_cloud_registration_tpu_torch.ops.voxelize import build_voxel_map
from oracles import make_scan, make_scene

F32 = np.float32


def _mask(kind: str, d: int, rng) -> np.ndarray:
    valid = {"random": rng.rand(d) < 0.3, "all": np.ones(d, bool), "none": np.zeros(d, bool),
             "one": np.zeros(d, bool)}[kind]
    if kind == "one":
        valid[d - 1] = True  # the last cell: the last word's top bit in use
    return valid


@pytest.mark.parametrize("kind,d", [("random", 1000), ("random", 31), ("random", 4096),
                                    ("all", 100), ("none", 77), ("one", 77), ("one", 64)])
def test_cell_index_ranks_give_the_compact_rows(kind, d):
    """``rank + popcount`` gives ``cumsum(valid) - 1`` for every valid cell,
    the sentinel for every other; the centers ``[mu, 1]`` and features
    ``[u6, 0, 0]`` are the valid cells' in key order, then a zero row."""
    rng = np.random.RandomState(d)
    valid = _mask(kind, d, rng)
    means = torch.from_numpy(rng.randn(d, 3).astype(F32))
    feats = torch.from_numpy(rng.randn(d, 6).astype(F32))
    v = torch.from_numpy(valid)
    occ, centers, out = cell_index(means, v, feats)
    n_valid = int(valid.sum())
    assert occ.dtype == torch.int32 and occ.shape == (-(-d // 32), 2)
    assert centers.shape == (n_valid + 1, 4) and out.shape == (n_valid + 1, 8)
    bits = occ[:, 0].numpy().view(np.uint32)
    unpacked = ((bits[:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)
    np.testing.assert_array_equal(unpacked[:d].astype(bool), valid)
    assert not unpacked[d:].any()
    key = torch.arange(d)
    want = np.where(valid, np.cumsum(valid) - 1, n_valid)
    np.testing.assert_array_equal(compact_rows(occ, key, n_valid).numpy(), want)
    ones, zeros = torch.ones(n_valid, 1), torch.zeros(n_valid, 2)
    torch.testing.assert_close(centers[:-1], torch.cat([means[v], ones], 1), rtol=0, atol=0)
    torch.testing.assert_close(out[:-1], torch.cat([feats[v], zeros], 1), rtol=0, atol=0)
    assert float(centers[-1].abs().sum()) == 0.0 and float(out[-1].abs().sum()) == 0.0


def _bit_walk(occ, centers, dims, cell, q, radius):
    """The kernel's search, query by query: ``(best_d2, best_row)``, row -1
    and +inf where the window holds no valid cell."""
    nx, ny, nz = dims
    words = occ.numpy()
    bits_all = words[:, 0].view(np.uint32)
    mu = centers.numpy()[:, :3]
    out_d2 = np.full(len(q), np.inf, F32)
    out_row = np.full(len(q), -1, np.int64)
    for i, ((cx, cy, cz), (qx, qy, qz)) in enumerate(zip(cell.tolist(), q.numpy())):
        x0, x1 = max(cx - radius, 0), min(cx + radius, nx - 1)
        y0, y1 = max(cy - radius, 0), min(cy + radius, ny - 1)
        z0, z1 = max(cz - radius, 0), min(cz + radius, nz - 1)
        if x0 > x1:
            continue
        best, best_row = F32(np.inf), -1
        for z in range(z0, z1 + 1):
            for y in range(y0, y1 + 1):
                first = nx * (y + ny * z) + x0
                last = first + (x1 - x0)
                k = first
                while k <= last:
                    w = k >> 5
                    bits = int(bits_all[w])
                    lo, hi = k & 31, min(last - (k & ~31), 31)
                    m = (bits >> lo << lo) & (0xFFFFFFFF >> (31 - hi))
                    # the stretch's valid cells are consecutive rows
                    idx = int(words[w, 1]) + bin(bits & ((1 << lo) - 1)).count("1")
                    for j in range(bin(m).count("1")):
                        dx, dy, dz = qx - mu[idx + j, 0], qy - mu[idx + j, 1], qz - mu[idx + j, 2]
                        d2 = dx * dx + dy * dy + dz * dz  # float32, no fused multiply-add
                        if d2 < best:
                            best, best_row = d2, idx + j
                    k = (k | 31) + 1
        out_d2[i], out_row[i] = best, best_row
    return out_d2, out_row


def _lattice_map(dims, rng, density=0.25):
    """Centroids at cell centres (every coordinate a multiple of 1/2 in cells
    of 1 m, so distances are exact in float32) and random normals."""
    d = int(np.prod(dims))
    key = np.arange(d)
    cells = np.stack([key % dims[0], (key // dims[0]) % dims[1], key // (dims[0] * dims[1])], 1)
    means = (cells + 0.5).astype(F32)
    valid = rng.rand(d) < density
    # pairs of valid cells for exact ties: across a word boundary inside a
    # row (keys 31 and 32; the test's grids have rows of more than two
    # cells there) and in two rows (keys 0 and nx)
    valid[[31, 32, 0, dims[0]]] = True
    normals = rng.randn(d, 3).astype(F32)
    return torch.from_numpy(means), torch.from_numpy(valid), torch.from_numpy(normals)


def _tie_queries(dims, valid):
    """Queries midway between two valid cells, and the lower key of each pair:
    cells of two rows (y and y + 1) and, in one row, the two sides of a word
    boundary (keys 32 w - 1 and 32 w)."""
    nx, ny, _ = dims
    v = valid.numpy()
    qs, lows = [], []
    for key in np.flatnonzero(v):
        x, y, z = key % nx, (key // nx) % ny, key // (nx * ny)
        if y + 1 < ny and v[key + nx]:
            qs.append([x + 0.5, y + 1.0, z + 0.5])
            lows.append(key)
        if key % 32 == 31 and x + 1 < nx and v[key + 1]:
            qs.append([x + 1.0, y + 0.5, z + 0.5])
            lows.append(key)
    return np.asarray(qs, F32).reshape(-1, 3), np.asarray(lows, np.int64)


@pytest.mark.parametrize("dims", [(37, 6, 5), (64, 3, 4), (5, 7, 3)])
def test_bit_walk_equals_the_dense_probe(dims):
    rng = np.random.RandomState(sum(dims))
    means, valid, normals = _lattice_map(dims, rng)
    dense = cell_table(means, valid, normals)
    occ, centers, _ = cell_index(means, valid, normals)
    hi = np.float32(dims)
    ties, lows = _tie_queries(dims, valid)
    faces = rng.rand(120, 3).astype(F32) * (hi + 4) - 2  # around and across every face
    far = np.float32([[1e12, 0, 0], [-50, 3, 2], [3, -1e9, 2], [2, 2, 1e30]])
    q = np.vstack([ties, faces, far, rng.rand(300, 3).astype(F32) * hi])
    assert len(ties) >= 4 and (lows % 32 == 31).any(), "exact ties of both kinds"
    q_t = torch.from_numpy(q)
    cell = torch.floor(q_t).clamp(-1e9, 1e9).to(torch.int64)
    keys = torch.nonzero(valid)[:, 0]
    for radius in (1, 2):
        d2_dense, key_dense = nearest_valid_cell(dense, dims, cell, q_t, radius)
        d2_c, row_c = nearest_valid_cell(centers, dims, cell, q_t, radius, occ=occ)
        d2_w, row_w = _bit_walk(occ, centers, dims, cell, q_t, radius)
        found = np.isfinite(d2_dense.numpy())
        assert found.any() and (~found).any()
        np.testing.assert_array_equal(d2_w, d2_dense.numpy())
        np.testing.assert_array_equal(d2_c.numpy(), d2_dense.numpy())
        np.testing.assert_array_equal(row_w[found], row_c.numpy()[found])
        np.testing.assert_array_equal(keys[row_w[found]].numpy(), key_dense.numpy()[found])
        assert (row_w[~found] == -1).all()
        # every tie went to the cell probed first: the lower key
        np.testing.assert_array_equal(key_dense[:len(ties)].numpy(), lows)


@pytest.fixture(scope="module")
def room():
    pts = make_scene(np.random.RandomState(5))
    scan, _ = make_scan(np.random.RandomState(7), pts,
                        np.array([0.1, -0.08, 0.2, 0.02, -0.02, 0.03]))
    return pts, scan


@pytest.mark.parametrize("kind", ["plane", "ndt"])
def test_permuted_scan_gives_the_same_stats_and_align(room, kind):
    pts, scan = room
    ndt = kind == "ndt"
    cfg = (NDTConfig if ndt else VPlaneICPConfig)(voxel_size=1.0, max_iter=30, max_dist=2.0,
                                                  tol=1e-3)
    vm = build_voxel_map(pts, 1.0, with_icov=ndt, rich="sqrt_icov" if ndt else "normals",
                         device="cpu")
    src, w = pad_points(scan)
    order = torch.from_numpy(np.random.RandomState(3).permutation(src.shape[0]))
    stats = fused_ndt_stats_reference if ndt else fused_plane_stats_reference
    T = torch.tensor([[1.0, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.1], [0, 0, 0, 1]])
    args = (vm.origin_cell, vm.dims, vm.cell_size)
    a = stats(vm.cells, *args, src, w, T[:3, :3], T[:3, 3], 2.0)
    b = stats(vm.cells, *args, src[order], w[order], T[:3, :3], T[:3, 3], 2.0)
    assert float(a[28]) == float(b[28]) > 100
    scale = a.abs().max()
    torch.testing.assert_close(b / scale, a / scale, rtol=0, atol=1e-6)
    T_a, d_a = fused_voxel_align(vm, src, w, torch.eye(4), cfg, kind)
    T_b, d_b = fused_voxel_align(vm, src[order], w[order], torch.eye(4), cfg, kind)
    assert d_a.iterations == d_b.iterations and d_a.converged
    torch.testing.assert_close(T_b, T_a, rtol=0, atol=1e-5)


def test_cell_index_of_the_map_matches_the_dense_table(room):
    """The map's index names the same rows as the dense per-cell table."""
    pts, _ = room
    vm = build_voxel_map(pts, 1.0, device="cpu")
    dense = cell_table(vm.means, vm.valid, vm.normals)
    keys = torch.nonzero(vm.valid)[:, 0]
    assert isinstance(vm.cells, CellIndex)
    torch.testing.assert_close(vm.cells.centers[:-1], dense[keys, 0:4], rtol=0, atol=0)
    torch.testing.assert_close(vm.cells.feats[:-1], dense[keys, 4:8], rtol=0, atol=0)
    n_valid = keys.numel()
    np.testing.assert_array_equal(
        compact_rows(vm.cells.occ, keys, n_valid).numpy(), np.arange(n_valid))
