"""annlite_torch.math against annlite_tpu.math on identical numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annlite_torch.math as tmath
import annlite_tpu.math as jmath
from annlite_tpu.enums import Metric

RNG = np.random.default_rng(7)
X = RNG.standard_normal((40, 64)).astype(np.float32)
Y = RNG.standard_normal((50, 64)).astype(np.float32)


def _close(t, j, scale):
    # rtol 1e-5; the atol covers results that are differences of terms of
    # size ``scale`` (float32 rounding of those terms, summed in another
    # order by the two frameworks)
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-5,
                               atol=1e-6 * scale)


def test_l2_normalize():
    z = X.copy()
    z[3] = 0.0  # zero rows stay zero
    _close(tmath.l2_normalize(torch.from_numpy(z)).numpy(),
           jmath.l2_normalize(jnp.asarray(z)), 1.0)


@pytest.mark.parametrize('name', ['sqeuclidean', 'euclidean', 'cosine',
                                  'inner_product'])
def test_pairwise(name):
    t = getattr(tmath, name)(torch.from_numpy(X), torch.from_numpy(Y))
    j = getattr(jmath, name)(jnp.asarray(X), jnp.asarray(Y))
    _close(t.numpy(), j, 4.0 * X.shape[1])


def test_sqeuclidean_clamped_at_zero():
    t = tmath.sqeuclidean(torch.from_numpy(X), torch.from_numpy(X)).numpy()
    assert (t >= 0).all()
    _close(t, jmath.sqeuclidean(jnp.asarray(X), jnp.asarray(X)), 4.0 * X.shape[1])


@pytest.mark.parametrize('metric', list(Metric))
def test_cdist(metric):
    t = tmath.cdist(X, Y, metric=metric.name.lower())
    j = jmath.cdist(X, Y, metric=metric)
    _close(t.numpy(), j, 4.0 * X.shape[1])


@pytest.mark.parametrize('k', [1, 5, 200])
def test_top_k_ties_to_lower_index(k):
    # integer-valued distances: many exact ties
    dists = RNG.integers(0, 6, (8, 100)).astype(np.float32)
    tv, ti = tmath.top_k(dists, k)
    jv, ji = jmath.top_k(dists, k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
