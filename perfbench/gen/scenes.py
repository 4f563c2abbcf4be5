"""Scene generators: frozen copies of the repository's synthetic maps and of
the B-01 protocol's scan (upstream ``benchmark/test_data.py:21-44``).

NumPy only. The benchmark keeps its own copies so that its inputs never
change with the code under test. ``extent`` is the tile's side in metres;
the benchmark's configurations keep the default 200 m, and the harness's CPU
tests shrink it with the point count so that the density stays realistic.
"""

from __future__ import annotations

import numpy as np


def make_city_map(rng: np.random.RandomState, n_total: int = 1_200_000,
                  extent: float = 200.0) -> np.ndarray:
    """Synthetic LiDAR-map stand-in for B-01.pcd: ground plane + building
    facades + scattered structure over an ``extent`` x ``extent`` m tile."""
    n_ground = n_total // 2
    ground = np.stack(
        [
            rng.rand(n_ground) * extent,
            rng.rand(n_ground) * extent,
            rng.randn(n_ground) * 0.03,
        ],
        axis=1,
    )
    # building facades: axis-aligned walls on a street grid
    n_walls = n_total // 3
    n_per = n_walls // 40
    walls = []
    for _ in range(40):
        x0, y0 = rng.rand(2) * (extent - 30)
        length = 10 + rng.rand() * 20
        height = 5 + rng.rand() * 15
        if rng.rand() < 0.5:
            w = np.stack(
                [
                    x0 + rng.rand(n_per) * length,
                    np.full(n_per, y0) + rng.randn(n_per) * 0.02,
                    rng.rand(n_per) * height,
                ],
                axis=1,
            )
        else:
            w = np.stack(
                [
                    np.full(n_per, x0) + rng.randn(n_per) * 0.02,
                    y0 + rng.rand(n_per) * length,
                    rng.rand(n_per) * height,
                ],
                axis=1,
            )
        walls.append(w)
    n_rest = n_total - n_ground - n_per * 40
    scatter = np.stack(
        [
            rng.rand(n_rest) * extent,
            rng.rand(n_rest) * extent,
            rng.rand(n_rest) * 6,
        ],
        axis=1,
    )
    return np.vstack([ground, *walls, scatter]).astype(np.float32)


def make_lidar_map(rng: np.random.RandomState, n_total: int = 1_200_000,
                   extent: float = 200.0) -> np.ndarray:
    """Spinning-LiDAR sampling statistics: 64-ring scans ray-cast from ten
    poses through a walled world (first hit only, so facades shadow what
    lies behind them), concatenated; range-dependent density and noise."""
    n_walls = 40
    walls = []
    for _ in range(n_walls):
        x0, y0 = rng.rand(2) * (extent - 30)
        walls.append((x0, y0, 10 + rng.rand() * 20, 5 + rng.rand() * 15,
                      0 if rng.rand() < 0.5 else 1))
    wx0 = np.array([w[0] for w in walls])
    wy0 = np.array([w[1] for w in walls])
    wlen = np.array([w[2] for w in walls])
    whgt = np.array([w[3] for w in walls])
    waxis = np.array([w[4] for w in walls])

    n_rings = 64
    elev = np.deg2rad(np.linspace(-24.0, 14.0, n_rings))
    n_poses = 10
    path_t = np.linspace(0.15, 0.85, n_poses)
    ox = extent * path_t
    oy = extent * (0.5 + 0.25 * np.sin(path_t * 4.0))
    oz = np.full(n_poses, 1.8)
    n_az = max(256, n_total // (n_poses * n_rings) + 1)
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)

    max_range = 120.0
    pts = []
    for p in range(n_poses):
        a = az + rng.rand() * (2 * np.pi / n_az)
        ca, sa = np.cos(a), np.sin(a)
        ce, se = np.cos(elev), np.sin(elev)
        dx = ce[:, None] * ca[None, :]
        dy = ce[:, None] * sa[None, :]
        dz = np.broadcast_to(se[:, None], dx.shape)
        t_best = np.full(dx.shape, max_range)
        with np.errstate(divide="ignore", invalid="ignore"):
            tg = -oz[p] / dz
        hit = (dz < -1e-6) & (tg < t_best)
        t_best = np.where(hit, tg, t_best)
        for j in range(n_walls):
            if waxis[j] == 0:
                with np.errstate(divide="ignore", invalid="ignore"):
                    tw = (wy0[j] - oy[p]) / dy
                hx = ox[p] + tw * dx
                span_lo, span_hi = wx0[j], wx0[j] + wlen[j]
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    tw = (wx0[j] - ox[p]) / dx
                hx = oy[p] + tw * dy
                span_lo, span_hi = wy0[j], wy0[j] + wlen[j]
            hz = oz[p] + tw * dz
            ok = (
                (tw > 0.5) & (tw < t_best)
                & (hx >= span_lo) & (hx <= span_hi)
                & (hz >= 0.0) & (hz <= whgt[j])
            )
            t_best = np.where(ok, tw, t_best)
        ret = t_best < max_range
        r = t_best[ret]
        hits = np.stack(
            [ox[p] + r * dx[ret], oy[p] + r * dy[ret], oz[p] + r * dz[ret]],
            axis=1,
        )
        hits += (rng.randn(len(hits), 3) * (0.008 * (1 + r / 60.0))[:, None])
        pts.append(hits)
    pts = np.vstack(pts)
    if len(pts) >= n_total:
        sel = rng.choice(len(pts), n_total, replace=False)
        return pts[sel].astype(np.float32)
    extra = rng.choice(len(pts), n_total - len(pts), replace=True)
    dup = pts[extra] + rng.randn(n_total - len(pts), 3) * 0.01
    return np.vstack([pts, dup]).astype(np.float32)


SCENES = {"make_city_map": make_city_map, "make_lidar_map": make_lidar_map}


def make_scan(rng, map_points, num_points=100_000, offset=(0.0, 0.0, 0.3), sigma=0.005):
    """scan = a random ``num_points`` subsample of the map + ``offset`` +
    N(0, ``sigma``) noise (upstream benchmark/test_data.py:21-44)."""
    t = np.asarray(offset, np.float32)
    idx = rng.choice(len(map_points), num_points, replace=False)
    scan = map_points[idx] + t
    scan = scan + rng.randn(*scan.shape).astype(np.float32) * np.float32(sigma)
    return scan.astype(np.float32)
