"""A filtered ``beam_vec`` (`csrc/beam_vec.cu` on `csrc/beam.cuh`, a
predicate byte a row) on the card: the kernel against its plain twin
``_beam_vec_ref`` with the same predicate and against the eager loop on the
card, bit for bit on integer rows (ids, distances, iterations), at 30, 50
and 80% of rows passing; the traversal (its iterations) as without the
predicate.  Every test is marked ``cuda`` and skips without a card; on the
card:

    python -m pytest -m cuda tests/test_torch_beam_vec_filtered_card.py

Rows and queries are small integers, so every distance is exact in float32
(and the rows in bf16) in any summation order."""
import numpy as np
import pytest
import torch

from annlite_torch.ops import BIG
from annlite_torch.ops import beam as tb

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason='needs a CUDA card: the kernel has no CPU mode')]

SELECTIVITIES = [0.3, 0.5, 0.8]


def _graph(n, d, r, q, e, seed=0):
    """Integer rows and queries, a random degree-r adjacency with 10% -1
    pads, e entries a query (a -1 in query 0, a duplicate in query 2)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.1] = -1
    qs = rng.integers(-3, 4, (q, d)).astype(np.float32)
    entry = rng.integers(0, n, (q, e)).astype(np.int32)
    entry[0, 0] = -1
    entry[2, -1] = entry[2, 0]
    return adj, x, qs, entry


def _check(adj, x, qs, entry, passes, euclid, L, B, k, iters=None, bf16=False):
    a, v, q, ent = (torch.from_numpy(t).cuda() for t in (adj, x, qs, entry))
    if bf16:
        v = v.to(torch.bfloat16)
    p = torch.from_numpy(passes).cuda()
    b = min(B, L)
    it = tb._resolve_iters(iters, L, b)
    d, ids, its = tb.beam_vec_kernel(a, ent, v, q, euclid, k, L, b, it, p)
    torch.cuda.synchronize()
    score = tb.make_vector_scorer(v, q, euclid)
    d_e, ids_e = tb._beam_loop(a, ent, L, b, it, k, score, passes=p)
    assert torch.equal(ids, ids_e) and torch.equal(d, d_e)
    d_t, ids_t, its_t = tb._beam_vec_ref(a.cpu(), ent.cpu(), v.cpu(), q.cpu(), euclid, L, b,
                                         it, k, p.cpu())
    assert torch.equal(ids.cpu(), ids_t) and torch.equal(d.cpu(), d_t)
    _, _, its_plain = tb.beam_vec_kernel(a, ent, v, q, euclid, L, L, b, it)
    assert torch.equal(its, its_plain)  # the walk is the one without the predicate
    real = ids.cpu().numpy()
    real = real[real != tb.NO_ID]
    assert passes[real].all()
    return d, ids


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('euclid', [True, False])
@pytest.mark.parametrize('selectivity', SELECTIVITIES)
def test_filtered_kernel_equals_twin_and_eager_loop(bf16, euclid, selectivity):
    adj, x, qs, entry = _graph(3000, 32, 24, 33, 8)
    passes = np.random.default_rng(1).random(3000) < selectivity
    d, _ = _check(adj, x, qs, entry, passes, euclid, 50, 16, 10, bf16=bf16)
    assert (d < BIG).all()  # every list full


@pytest.mark.parametrize('L,B,k,iters', [(32, 4, 32, 3), (16, 1, 5, 40), (1024, 8, 100, 12),
                                         (2048, 64, 2048, 8)])
def test_filtered_plan_edges(L, B, k, iters):
    """Two, four and eight sort keys a thread; a result list as wide as the
    traversal's; a budget that cuts the walk short."""
    adj, x, qs, entry = _graph(5000, 32, 32, 9, 8, seed=L)
    passes = np.random.default_rng(L).random(5000) < 0.5
    _check(adj, x, qs, entry, passes, True, L, B, k, iters)


def test_filtered_short_mask_and_few_passing_rows():
    """A mask shorter than the rows (the rest fail) that passes 6 rows: the
    lists hold the passing rows scored, then (BIG, NO_ID)."""
    adj, x, qs, entry = _graph(3000, 16, 24, 17, 8, seed=4)
    passes = np.zeros(2500, dtype=bool)
    passes[[0, 7, 99, 1000, 2222, 2499]] = True
    d, ids = _check(adj, x, qs, entry, passes, True, 64, 16, 10)
    assert (ids[:, 6:] == tb.NO_ID).all() and (d[:, 6:] == BIG).all()
