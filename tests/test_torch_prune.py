"""annlite_torch.ops.prune.robust_prune_batch against
annlite_tpu.ops.prune.robust_prune_batch and a numpy oracle of the
documented contract, on identical numpy inputs.

Pools are L = 8, 40 and 96 wide, with and without duplicate ids, the point
itself and -1 pads, in both metrics.  Pools in which some ``alpha * d(i, j)``
lies within 1e-6 relative of ``d(p, j)`` are left out (a float32 product in
another summation order may fall on either side of such a tie), so the ids
must be equal bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch.ops.prune import robust_prune_batch as t_prune
from annlite_tpu.ops.prune import robust_prune_batch as j_prune

N, D, P, ALPHA = 600, 16, 96, 1.2


def _pools(l, metric_ip, dups, seed=0):
    """(pool_ids, pool_d, pool_vecs, self_ids, vecs) of the pools without a
    near-tie; distances in float32 as the builder computes them."""
    rng = np.random.default_rng(seed + 7 * l + int(metric_ip))
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    if metric_ip:
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    self_ids = rng.integers(0, N, P).astype(np.int32)
    pool = np.stack([rng.permutation(N)[:l] for _ in range(P)]).astype(np.int32)
    if dups:
        pool[:, l // 2] = pool[:, 0]        # a duplicate id
        pool[:, l // 3 + 1] = self_ids      # the point itself
        pool[:, -1] = -1                    # a pad
    pv = vecs[np.clip(pool, 0, N - 1)]
    sv = vecs[self_ids]
    if metric_ip:
        pd = (1.0 - np.einsum('pd,pld->pl', sv, pv)).astype(np.float32)
    else:
        pd = ((pv - sv[:, None, :]) ** 2).sum(-1).astype(np.float32)
    # float64 check of every alpha * d(i, j) <= d(p, j) compare
    v64 = pv.astype(np.float64)
    if metric_ip:
        pw = 1.0 - np.einsum('pld,pmd->plm', v64, v64)
    else:
        pw = ((v64[:, :, None, :] - v64[:, None, :, :]) ** 2).sum(-1)
    lhs = ALPHA * pw
    rhs = pd.astype(np.float64)[:, None, :]
    near = np.abs(lhs - rhs) <= 1e-6 * np.maximum(np.abs(rhs), 1e-30)
    # only members the prune compares: real, not the point, first copies
    real = (pool >= 0) & (pool != self_ids[:, None])
    first = np.ones_like(real)
    for j in range(1, pool.shape[1]):
        first[:, j] = ~(pool[:, :j] == pool[:, j:j + 1]).any(axis=1)
    lane = real & first
    pair = lane[:, :, None] & lane[:, None, :] & ~np.eye(pool.shape[1], dtype=bool)[None]
    keep = ~(near & pair).any(axis=(1, 2))
    assert keep.sum() >= P // 2
    return pool[keep], pd[keep], pv[keep], self_ids[keep], vecs


def _run_both(pool, pd, pv, sid, r, metric_ip):
    want = np.asarray(j_prune(jnp.asarray(pool), jnp.asarray(pd), jnp.asarray(pv),
                              jnp.asarray(sid), ALPHA, r, metric_ip=metric_ip))
    got = t_prune(torch.from_numpy(pool), torch.from_numpy(pd), torch.from_numpy(pv),
                  torch.from_numpy(sid), ALPHA, r, metric_ip=metric_ip).numpy()
    return got, want


@pytest.mark.parametrize('dups', [False, True])
@pytest.mark.parametrize('metric_ip', [False, True])
@pytest.mark.parametrize('l', [8, 40, 96])
def test_prune_ids_equal_jax(l, metric_ip, dups):
    pool, pd, pv, sid, _ = _pools(l, metric_ip, dups)
    r = min(l, 16)
    got, want = _run_both(pool, pd, pv, sid, r, metric_ip)
    assert got.dtype == np.int32 and got.shape == want.shape == (len(pool), r)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('saturate', [False, True])
def test_prune_saturate_switch(saturate):
    pool, pd, pv, sid, _ = _pools(40, False, True)
    got = t_prune(torch.from_numpy(pool), torch.from_numpy(pd), torch.from_numpy(pv),
                  torch.from_numpy(sid), ALPHA, 16, saturate=saturate).numpy()
    want = np.asarray(j_prune(jnp.asarray(pool), jnp.asarray(pd), jnp.asarray(pv),
                              jnp.asarray(sid), ALPHA, 16, saturate=saturate))
    np.testing.assert_array_equal(got, want)
    if not saturate:
        # without saturation only the selected members are kept
        assert (got < 0).any()


def _np_robust_prune(pool_ids, pool_d, vecs, self_id, alpha, r):
    """The documented contract step by step (the oracle of the JAX package's
    own test, `native/vamana.cpp` robust_prune + saturation)."""
    items = sorted(
        {int(i): float(d) for i, d in zip(pool_ids, pool_d) if i >= 0 and i != self_id}.items(),
        key=lambda kv: kv[1],
    )
    ids = [i for i, _ in items]
    dists = {i: d for i, d in items}
    removed, out = set(), []
    for i in ids:
        if i in removed or len(out) >= r:
            continue
        out.append(i)
        for j in ids:
            if j in removed or j in out:
                continue
            d_sj = ((vecs[i].astype(np.float64) - vecs[j]) ** 2).sum()
            if alpha * d_sj <= dists[j]:
                removed.add(j)
    for i in ids:  # saturate
        if len(out) >= r:
            break
        if i not in out:
            out.append(i)
    return out


@pytest.mark.parametrize('l', [8, 40, 96])
def test_prune_equals_numpy_oracle(l):
    """Membership and order equal the oracle's (squared L2)."""
    pool, pd, pv, sid, vecs = _pools(l, False, True, seed=3)
    r = min(l, 16)
    got = t_prune(torch.from_numpy(pool), torch.from_numpy(pd), torch.from_numpy(pv),
                  torch.from_numpy(sid), ALPHA, r).numpy()
    for i in range(len(pool)):
        want = _np_robust_prune(pool[i], pd[i], vecs, sid[i], ALPHA, r)
        assert [int(v) for v in got[i] if v >= 0] == want, i
        assert (got[i][len(want):] == -1).all()
