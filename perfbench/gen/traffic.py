"""The traffic generator: one cell's inputs and requests, drawn from
``--seed``.

A traffic mix is a JSON file of parameters (``perfbench/traffic/<mix>.json``):

* ``maps``, ``scans_per_map``: the pool made at set-up, each map from the
  configuration's scene generator, each scan by the configuration's scan
  protocol;
* ``set_target_per_request``: a request is ``set_target(map)`` then
  ``align(scan, init_T)``; otherwise the first map is the target, set once
  at set-up, and a request is ``align`` alone;
* ``shift_voxels``: before each request its map and scan move by one
  translation, uniform in ``[0, shift_voxels)`` voxels on each axis (0: none);
* ``init_translation_sigma_m``, ``init_yaw_sigma_deg``: ``init_T``, drawn
  fresh for each request, is a yaw about the map's centre and a translation,
  each normal with that sigma: a motion prior's error;
* ``loop``, ``clients``: the arrival process; the harness runs a closed
  loop of one client and refuses any other (:func:`check_arrivals`);
* ``warmup_requests``, ``checked_requests``, ``traced_requests``: how many
  requests warm up, how many the comparison with the reference takes from
  the window, and how many a traced run records at most.

Requests take the pool's scans in turn. The same seed gives the same pool
and the same sequence of requests.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from perfbench.gen.scenes import SCENES, make_scan

STREAMS = ("scene", "pool", "requests", "warmup", "sample")
ARRIVALS = {("closed", 1)}  # (loop, clients) that the harness runs


def check_arrivals(traffic: dict) -> None:
    """Refuse a mix whose arrival process the harness does not run."""
    arrival = (traffic.get("loop"), traffic.get("clients"))
    if arrival not in ARRIVALS:
        raise ValueError(f"loop {arrival[0]!r} of {arrival[1]!r} clients: the harness runs "
                         f"only {sorted(ARRIVALS)}")


def seed_streams(seed: int) -> dict[str, np.random.RandomState]:
    """Independent generators for each use, from any whole ``seed``."""
    entropy = abs(int(seed)) * 2 + (1 if int(seed) < 0 else 0)
    children = np.random.SeedSequence(entropy).spawn(len(STREAMS))
    return {name: np.random.RandomState(c.generate_state(4))
            for name, c in zip(STREAMS, children)}


@dataclass
class Pool:
    maps: list  # (N, 3) float32 arrays
    scans: list  # scans[m] = list of (n, 3) float32 arrays of map m
    centres: list  # (3,) float64 bounding-box centre of each map


@dataclass
class Request:
    index: int
    map_index: int
    scan_index: int
    init_T: np.ndarray  # (4, 4) float64
    shift: np.ndarray  # (3,) float32, zeros without a shift


def make_pool(config: dict, traffic: dict, streams: dict) -> Pool:
    scene, scan_cfg = config["scene"], config["scan"]
    gen = SCENES[scene["generator"]]
    maps, scans, centres = [], [], []
    for m in range(int(traffic["maps"])):
        rng = streams["scene"] if m == 0 else streams["pool"]
        pts = gen(rng, int(scene["points"]), float(scene.get("extent", 200.0)))
        maps.append(pts)
        centres.append((pts.min(axis=0).astype(np.float64) + pts.max(axis=0)) / 2)
        scans.append([make_scan(streams["pool"], pts, int(scan_cfg["points"]),
                                scan_cfg["offset"], float(scan_cfg["sigma"]))
                      for _ in range(int(traffic["scans_per_map"]))])
    return Pool(maps=maps, scans=scans, centres=centres)


def draw_init_T(rng: np.random.RandomState, centre: np.ndarray, traffic: dict) -> np.ndarray:
    """A yaw about ``centre`` and a translation, normal with the mix's sigmas."""
    yaw = np.deg2rad(float(traffic["init_yaw_sigma_deg"])) * rng.randn()
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = centre - R @ centre + float(traffic["init_translation_sigma_m"]) * rng.randn(3)
    return T


class Requests:
    """The request sequence of one stream: ``next()`` draws the next one."""

    def __init__(self, pool: Pool, traffic: dict, voxel: float, rng: np.random.RandomState):
        self.pool, self.traffic, self.rng = pool, traffic, rng
        self.shift_m = float(traffic.get("shift_voxels", 0)) * voxel
        self.count = 0

    def next(self) -> Request:
        i = self.count
        self.count += 1
        n_maps, per_map = len(self.pool.maps), len(self.pool.scans[0])
        m = i % n_maps
        k = (i // n_maps) % per_map
        shift = (self.rng.rand(3) * self.shift_m).astype(np.float32)
        init_T = draw_init_T(self.rng, self.pool.centres[m] + shift, self.traffic)
        return Request(index=i, map_index=m, scan_index=k, init_T=init_T, shift=shift)


class Buffers:
    """Preallocated inputs of shifted requests: the map and the scan as
    the client hands them over, moved by the request's shift."""

    def __init__(self, pool: Pool):
        self.map = np.empty_like(pool.maps[0])
        self.scan = np.empty_like(pool.scans[0][0])

    def fill(self, pool: Pool, req: Request) -> tuple[np.ndarray, np.ndarray]:
        if not req.shift.any():
            return pool.maps[req.map_index], pool.scans[req.map_index][req.scan_index]
        shifted(pool.maps[req.map_index], req.shift, self.map)
        shifted(pool.scans[req.map_index][req.scan_index], req.shift, self.scan)
        return self.map, self.scan


def shifted(points: np.ndarray, shift: np.ndarray, out: np.ndarray, rows: int = 1024) -> None:
    """``out = points + shift`` for (N, 3) float32 points, bit for bit the
    broadcast sum, added over rows of ``3 * rows`` floats: NumPy's loop over
    a last axis of 3 costs several times the memory traffic."""
    period = np.tile(shift, rows)
    a, o = points.reshape(-1), out.reshape(-1)
    n = (a.size // period.size) * period.size
    np.add(a[:n].reshape(-1, period.size), period, out=o[:n].reshape(-1, period.size))
    np.add(a[n:], period[: a.size - n], out=o[n:])
