"""Port parity of the exact brute-force nearest-neighbour oracles:
``ops/kernels/exact_nn.py`` (the plain version of the exact 1-NN kernel) and
``ops/knn.py`` ``brute_force_nn`` / ``brute_force_knn`` of
point_cloud_registration_tpu_torch against the JAX package's
``exact_nn_pallas`` (Pallas in interpret mode) and ``ops/knn.py``.

Indices are equal, the first index on ties. Distances are sums of three
squares; XLA may contract them into fused multiply-adds, so they agree to
float32 rounding (rtol 1e-6), not bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.ops.knn import brute_force_knn as jax_brute_force_knn
from point_cloud_registration_tpu.ops.knn import brute_force_nn as jax_brute_force_nn
from point_cloud_registration_tpu.ops.pallas.exact_nn import exact_nn_pallas
from point_cloud_registration_tpu_torch.ops.kernels.exact_nn import exact_nn, exact_nn_reference
from point_cloud_registration_tpu_torch.ops.knn import brute_force_knn, brute_force_nn


def _clouds(nq, nr, seed):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(nr, 3) * np.float32([20, 20, 3])).astype(np.float32)
    q = (rng.rand(nq, 3) * np.float32([22, 22, 4]) - 1).astype(np.float32)
    return q, ref


@pytest.mark.parametrize("nq,nr", [(1, 1), (7, 513), (1025, 300), (300, 4097), (2000, 1)])
def test_exact_nn_reference_matches_pallas(nq, nr):
    """Ragged sizes around the TPU kernel's tiles (1024 queries, 512
    references), and a single reference point."""
    q, ref = _clouds(nq, nr, nq + nr)
    jd, ji = exact_nn_pallas(q, ref, interpret=True)
    d, i = exact_nn_reference(torch.from_numpy(q), torch.from_numpy(ref), chunk=600)
    assert i.dtype == torch.int32 and d.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)


def test_exact_nn_is_the_true_minimum():
    q, ref = _clouds(500, 3000, 1)
    d, i = exact_nn_reference(torch.from_numpy(q), torch.from_numpy(ref))
    d2 = ((q[:, None, :].astype(np.float64) - ref[None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), np.sqrt(d2.min(1)), rtol=1e-5)
    picked = d2[np.arange(500), i.numpy()]
    np.testing.assert_allclose(picked, d2.min(1), rtol=1e-5)


def test_ties_take_the_first_index():
    """Duplicated reference points, and a query midway between two."""
    _, ref = _clouds(1, 900, 3)
    ref = np.concatenate([ref, ref[::-1]])  # every point twice
    q = np.concatenate([ref[:900] + np.float32(0.001), [[0.5, 0.0, 0.0]]]).astype(np.float32)
    ref = np.concatenate([ref, [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]]).astype(np.float32)
    ref[:1800] += np.float32(50.0)  # keep the midway pair isolated
    q[:900] += np.float32(50.0)
    d, i = exact_nn_reference(torch.from_numpy(q), torch.from_numpy(ref), chunk=128)
    jd, ji = exact_nn_pallas(q, ref, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert int(i[-1]) == 1800 and float(d[-1]) == 0.5
    assert (i[:900].numpy() < 900).all()  # never the later duplicate


def test_empty_reference_and_empty_query():
    q = torch.from_numpy(_clouds(5, 1, 0)[0])
    d, i = exact_nn(q, torch.zeros((0, 3)))
    assert torch.isinf(d).all() and (i == -1).all()
    d, i = exact_nn(torch.zeros((0, 3)), q)
    assert d.shape == (0,) and i.shape == (0,)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, ref = _clouds(300, 700, 9)
    before = exact_nn.launches
    d, i = exact_nn(torch.from_numpy(q), torch.from_numpy(ref))
    dr, ir = exact_nn_reference(torch.from_numpy(q), torch.from_numpy(ref))
    torch.testing.assert_close(d, dr, rtol=0, atol=0)
    torch.testing.assert_close(i, ir, rtol=0, atol=0)
    assert exact_nn.launches == before


@pytest.mark.parametrize("masked", [False, True])
def test_brute_force_nn_matches_jax(masked):
    q, ref = _clouds(700, 5000, 11)
    valid = np.random.RandomState(0).rand(5000) > 0.5 if masked else None
    j = jax_brute_force_nn(jnp.asarray(q), jnp.asarray(ref),
                           None if valid is None else jnp.asarray(valid))
    d, i = brute_force_nn(torch.from_numpy(q), torch.from_numpy(ref),
                          None if valid is None else torch.from_numpy(valid), tile=1024)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j.idx))
    np.testing.assert_allclose(d.numpy(), np.asarray(j.dist), rtol=1e-6)
    if masked:
        assert valid[i.numpy()].all()


@pytest.mark.parametrize("k", [1, 8, 15])
def test_brute_force_knn_matches_jax(k):
    q, ref = _clouds(900, 2500, k)
    jd, ji = jax_brute_force_knn(jnp.asarray(q), jnp.asarray(ref), k)
    d, i = brute_force_knn(torch.from_numpy(q), torch.from_numpy(ref), k, chunk=400)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_array_equal(np.sort(i.numpy(), axis=1), np.sort(np.asarray(ji), axis=1))
    assert (np.diff(d.numpy(), axis=1) >= 0).all()
