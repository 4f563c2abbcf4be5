"""The port's namespaces against the JAX package's, and the two functions
that only the namespace exposes: ``ops.eigvals_sym3`` and
``ops.reduce_H_g_e2``.

Every name that the JAX package's ``ops``, ``models``, ``core``,
``parallel`` and ``utils`` ``__init__`` imports must exist in the port's
counterpart (the names are read from the JAX sources, so a name added there
shows here).

Tolerances (f32 rounding, the same formulas on both sides, other op orders):
eigenvalues within 4e-6 of the input's largest entry; H, g and e2 within
1e-5 of the sum of the absolute values of their terms.
"""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_cloud_registration_tpu.ops import eigh3 as jeigh3
from point_cloud_registration_tpu.ops import reduce as jreduce
from point_cloud_registration_tpu_torch import ops as tops
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JAX_PKG = Path(__file__).resolve().parents[1] / "point_cloud_registration_tpu"
SUBPACKAGES = ("ops", "models", "core", "parallel", "utils")
TOL_EIG = 4e-6
TOL_SUM = 1e-5


def _init_names(sub: str) -> list[str]:
    """The names that the JAX ``<sub>/__init__.py`` imports."""
    tree = ast.parse((JAX_PKG / sub / "__init__.py").read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names if node.module != "__future__"]


NAMES = [(sub, name) for sub in SUBPACKAGES for name in _init_names(sub)]


def test_the_jax_namespaces_are_read():
    counts = {sub: len(_init_names(sub)) for sub in SUBPACKAGES}
    assert counts["ops"] == 29 and min(counts.values()) >= 5, counts


@pytest.mark.parametrize("sub,name", NAMES, ids=[f"{s}.{n}" for s, n in NAMES])
def test_port_namespace_has_the_jax_name(sub, name):
    module = importlib.import_module(f"point_cloud_registration_tpu_torch.{sub}")
    assert hasattr(module, name), f"point_cloud_registration_tpu_torch.{sub} lacks {name}"


def _packed_cases() -> dict:
    """Packed symmetric 3x3 inputs: seeded covariances over five decades of
    scale, rank-1 (a plane's point spread along one line) and rank-2,
    exactly diagonal, repeated eigenvalues, zero."""
    rng = np.random.RandomState(0)
    A = rng.randn(512, 3, 3)
    spd = A @ A.transpose(0, 2, 1) * (10.0 ** rng.uniform(-4, 1, (512, 1, 1)))
    v = rng.randn(64, 3)
    rank1 = v[:, :, None] * v[:, None, :]
    u = rng.randn(64, 3)
    rank2 = rank1 + u[:, :, None] * u[:, None, :]
    diag = np.stack([np.diag(d) for d in rng.uniform(0, 2, (32, 3))])
    iso = np.stack([np.eye(3) * s for s in (1e-6, 1.0, 7.0)])
    mats = {"spd": spd, "rank1": rank1, "rank2": rank2, "diagonal": diag,
            "isotropic": iso, "zero": np.zeros((4, 3, 3))}
    return {k: np.stack([m[:, 0, 0], m[:, 1, 1], m[:, 2, 2], m[:, 0, 1], m[:, 0, 2],
                         m[:, 1, 2]], -1).astype(np.float32) for k, m in mats.items()}


@pytest.mark.parametrize("case", sorted(_packed_cases()))
def test_eigvals_sym3_matches_jax(case):
    s = _packed_cases()[case]
    got = tops.eigvals_sym3(torch.from_numpy(s)).numpy()
    ref = np.asarray(jeigh3.eigvals_sym3(jnp.asarray(s)))
    scale = np.maximum(np.abs(s).max(-1, keepdims=True), 1e-30)
    assert got.shape == ref.shape == (s.shape[0], 3)
    assert np.all(np.abs(got - ref) <= TOL_EIG * scale), float(np.abs(got - ref).max())
    assert np.all(np.diff(got, axis=-1) >= -TOL_EIG * scale)  # ascending
    if case in ("diagonal", "zero", "isotropic"):  # the sorted-diagonal path
        assert np.all(np.abs(got - np.sort(s[:, :3], axis=-1)) <= TOL_EIG * scale)
    # a leading batch shape
    np.testing.assert_array_equal(
        tops.eigvals_sym3(torch.from_numpy(s[:2].reshape(2, 1, 6))).numpy().reshape(2, 3),
        got[:2])


def _reduce_case(m: int, zero_weights: str):
    rng = np.random.RandomState(1 + m)
    n = 3000
    Js = rng.randn(n, m, 6).astype(np.float32)
    rs = rng.randn(n, m).astype(np.float32)
    w = rng.uniform(0, 2, n).astype(np.float32)
    if zero_weights == "some":
        w[rng.rand(n) < 0.4] = 0.0
    elif zero_weights == "all":
        w[:] = 0.0
    if m == 1:  # the scalar-residual form: (N, 6) and (N,)
        Js, rs = Js[:, 0], rs[:, 0]
    return Js, rs, w


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("zero_weights", ["none", "some", "all"])
def test_reduce_H_g_e2_matches_jax(m, zero_weights):
    Js, rs, w = _reduce_case(m, zero_weights)
    H, g, e2 = (x.numpy() for x in tops.reduce_H_g_e2(*map(torch.from_numpy, (Js, rs, w))))
    Hj, gj, e2j = (np.asarray(x) for x in jreduce.reduce_H_g_e2(*map(jnp.asarray, (Js, rs, w))))
    J3 = Js.reshape(len(w), -1, 6).astype(np.float64)
    r3 = rs.reshape(len(w), -1).astype(np.float64)
    H_abs = np.einsum("nmi,nmj,n->ij", np.abs(J3), np.abs(J3), w)
    g_abs = np.einsum("nmi,nm,n->i", np.abs(J3), np.abs(r3), w)
    e2_abs = np.einsum("nm,nm,n->", r3, r3, w)
    assert H.shape == (6, 6) and g.shape == (6,) and e2.shape == ()
    assert np.all(np.abs(H - Hj) <= TOL_SUM * H_abs)
    assert np.all(np.abs(g - gj) <= TOL_SUM * g_abs)
    assert abs(float(e2) - float(e2j)) <= TOL_SUM * e2_abs
    assert np.all(np.abs(H - H.T) <= TOL_SUM * H_abs)
    if zero_weights == "all":
        assert not H.any() and not g.any() and float(e2) == 0.0
    if zero_weights == "some":  # a zero weight is a dropped row
        keep = w > 0
        Hk, gk, e2k = (x.numpy() for x in tops.reduce_H_g_e2(
            *map(torch.from_numpy, (Js[keep], rs[keep], w[keep]))))
        assert np.all(np.abs(H - Hk) <= TOL_SUM * H_abs)
        assert np.all(np.abs(g - gk) <= TOL_SUM * g_abs)
        assert abs(float(e2) - float(e2k)) <= TOL_SUM * e2_abs
