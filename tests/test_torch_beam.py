"""annlite_torch.ops.beam (and K8's plain version) against
annlite_tpu.ops.beam on one shared adjacency.

Vectors, queries and tables are small integers or dyadic values, so every
distance, dot product and table sum is exact in float32 in any order: the
two packages must then return equal ids and distances, ties included (one
ulp from another summation order could change which node expands and
diverge the traversal).  Cosine data gets a stated tolerance instead."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch.index.vamana_lib import VamanaGraph
from annlite_torch.ops import adc as tadc
from annlite_torch.ops import beam as tb
from annlite_tpu.ops import adc as jadc
from annlite_tpu.ops import beam as jb

N, D, R, Q = 700, 16, 12, 7
BIG = np.float32(3.4e38)


@pytest.fixture(scope='module')
def graph():
    """Integer rows, one single-threaded build, the same adjacency for both
    packages; queries are integer points and entries random rows."""
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, (N, D)).astype(np.float32)
    g = VamanaGraph(D, max_degree=R, l_build=32)
    g.add(x, n_threads=1)
    q = rng.integers(-3, 4, (Q, D)).astype(np.float32)
    entry = rng.integers(0, N, (Q, 3)).astype(np.int32)
    return g.adjacency(), x, q, entry


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(*arrays):
    return [np.asarray(a) for a in arrays]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# (L, B, iters): the default budget; a budget that cuts the search short;
# a budget far beyond convergence, where the JAX loop stops early
SCHEDULES = [(32, 4, None), (16, 8, 3), (24, 4, 64), (8, 16, None)]


@pytest.mark.parametrize('euclid', [True, False])
@pytest.mark.parametrize('L,B,iters', SCHEDULES)
def test_beam_search_vectors_equal(graph, euclid, L, B, iters):
    adj, x, q, entry = graph
    want = jb.beam_search_vectors(jnp.asarray(adj), jnp.asarray(entry), jnp.asarray(x),
                                  jnp.asarray(q), euclid, k=L, L=L, B=B, iters=iters)
    got = tb.beam_search_vectors(_t(adj), _t(entry), _t(x), _t(q), euclid,
                                 k=L, L=L, B=B, iters=iters)
    _assert_equal(got, want)


def test_early_stop_reads_the_condition_every_few_iterations(graph, monkeypatch):
    """The JAX loop stops at the first iteration without a frontier; the
    port reads that condition only every _CHECK_EVERY iterations.  With a
    budget far beyond convergence both stop early, and the extra iterations
    change nothing, whatever the reading interval."""
    adj, x, q, entry = graph
    L, B = 16, 8
    want = _np(*jb.beam_search_vectors(jnp.asarray(adj), jnp.asarray(entry),
                                       jnp.asarray(x), jnp.asarray(q), True,
                                       k=L, L=L, B=B, iters=200))
    calls = []
    real = tb._sort_by

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tb, '_sort_by', counting)
    for every in (1, 3, 4, 200):
        monkeypatch.setattr(tb, '_CHECK_EVERY', every)
        calls.clear()
        got = tb.beam_search_vectors(_t(adj), _t(entry), _t(x), _t(q), True,
                                     k=L, L=L, B=B, iters=200)
        _assert_equal(got, want)
        iterations = (len(calls) - 1) // 3  # the seed sort, then 3 per iteration
        if every == 1:
            converged = iterations
            assert converged < 200  # the loop stopped early
        else:
            assert converged <= iterations < converged + every


@pytest.mark.parametrize('code_dtype,k', [(np.uint8, 16), (np.uint16, 300)])
@pytest.mark.parametrize('L,B,iters', SCHEDULES[:3])
def test_beam_search_pq_equal(graph, code_dtype, k, L, B, iters):
    adj, _, _, entry = graph
    rng = np.random.default_rng(1)
    m = 4
    codes = rng.integers(0, k, (N, m)).astype(code_dtype)
    dtable = (rng.integers(0, 128, (Q, m, k)) / 8.0).astype(np.float32)
    want = jb.beam_search_pq(jnp.asarray(adj), jnp.asarray(entry[:, :1]), jnp.asarray(codes),
                             jnp.asarray(dtable), k=L, L=L, B=B, iters=iters)
    got = tb.beam_search_pq(_t(adj), _t(entry[:, :1]), _t(codes), _t(dtable),
                            k=L, L=L, B=B, iters=iters)
    _assert_equal(got, want)


def _int8_copy(x):
    from annlite_tpu.index.graph import _quantize_rows_int8 as jq

    from annlite_torch.index.graph import _quantize_rows_int8 as tq
    want = _np(*jq(jnp.asarray(x)))
    got = [t.numpy() for t in tq(_t(x))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the float32 row norms are summed in another order: rtol 1e-6
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    return want


def _assert_same_quality(got, want, x, q, euclid, k=10):
    """The int8 and packed scorers: XLA fuses their final multiply-add where
    PyTorch rounds twice, so scores may differ by an ulp and the traversal
    may break a tie the other way.  Held: the top-k distances at rtol 1e-5
    (atol 1e-5 near 0), and equal recall@k against a float32 brute force."""
    (gd, gi), (wd, wi) = _np(*got), _np(*want)
    np.testing.assert_allclose(gd[:, :k], wd[:, :k], rtol=1e-5, atol=1e-5)
    exact = ((q[:, None] - x[None]) ** 2).sum(-1) if euclid else -(q @ x.T)
    gt = np.argsort(exact, axis=1, kind='stable')[:, :k]
    rec = lambda ids: np.mean([len(set(a[:k]) & set(b)) for a, b in zip(ids, gt)])  # noqa: E731
    assert rec(gi) == rec(wi)


@pytest.mark.parametrize('euclid', [True, False])
def test_beam_search_int8_within_tolerance(graph, euclid):
    adj, x, q, entry = graph
    x8, sc, nm = _int8_copy(x)
    norms = nm if euclid else None
    want = jb.beam_search_int8(jnp.asarray(adj), jnp.asarray(entry), jnp.asarray(x8),
                               jnp.asarray(sc), None if norms is None else jnp.asarray(norms),
                               jnp.asarray(q), euclid, k=24, L=24, B=4)
    got = tb.beam_search_int8(_t(adj), _t(entry), _t(x8), _t(sc),
                              None if norms is None else _t(norms), _t(q), euclid,
                              k=24, L=24, B=4)
    _assert_same_quality(got, want, x, q, euclid)


@pytest.mark.parametrize('euclid', [True, False])
def test_pack_neighbors_and_packed_beam(graph, euclid):
    adj, x, q, entry = graph
    want_pack = [None if a is None else np.asarray(a)
                 for a in jb.pack_neighbors(adj, jnp.asarray(x), need_norms=euclid, chunk=256)]
    got_pack = tb.pack_neighbors(_t(adj), _t(x), need_norms=euclid, chunk=256)
    np.testing.assert_array_equal(got_pack[0].numpy(), want_pack[0])
    np.testing.assert_array_equal(got_pack[1].numpy(), want_pack[1])
    if euclid:  # integer squares: exact in any order
        np.testing.assert_array_equal(got_pack[2].numpy(), want_pack[2])
    pk, sc, nm = want_pack
    want = jb.beam_search_packed(jnp.asarray(adj), jnp.asarray(entry), jnp.asarray(pk),
                                 jnp.asarray(sc), None if nm is None else jnp.asarray(nm),
                                 jnp.asarray(x), jnp.asarray(q), euclid, k=24, L=24, B=4)
    got = tb.beam_search_packed(_t(adj), _t(entry), _t(pk), _t(sc),
                                None if nm is None else _t(nm), _t(x), _t(q), euclid,
                                k=24, L=24, B=4)
    _assert_same_quality(got, want, x, q, euclid)


def test_beam_search_vectors_bounded_equal(graph):
    adj, x, q, entry = graph
    want = jb.beam_search_vectors_bounded(jnp.asarray(adj), jnp.asarray(entry),
                                          jnp.asarray(x), jnp.asarray(q), jnp.int32(400),
                                          True, 16, 4, 12, 16)
    got = tb.beam_search_vectors_bounded(_t(adj), _t(entry), _t(x), _t(q), 400,
                                         True, 16, 4, 12, 16)
    _assert_equal(got, want)
    ids = np.asarray(got[1])
    assert ((ids < 400) | (ids == tb.NO_ID)).all()


def test_cosine_vectors_within_tolerance(graph):
    """Normalized rows are not exact in float32: distances at atol 1e-5,
    and the same recall against a brute force."""
    adj, x, q, entry = graph
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    jd, ji = _np(*jb.beam_search_vectors(jnp.asarray(adj), jnp.asarray(entry),
                                         jnp.asarray(xn), jnp.asarray(qn), False,
                                         k=10, L=32, B=4))
    td, ti = tb.beam_search_vectors(_t(adj), _t(entry), _t(xn), _t(qn), False,
                                    k=10, L=32, B=4)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-5)
    gt = np.argsort(-(qn @ xn.T), axis=1, kind='stable')[:, :10]
    rec = lambda ids: np.mean([len(set(a) & set(b)) for a, b in zip(ids, gt)])  # noqa: E731
    assert rec(ti.numpy()) == rec(ji)


def test_scorers_equal(graph):
    adj, x, q, _ = graph
    ids = np.array([[0, 5, -1, N, 7, tb.NO_ID]] * Q, dtype=np.int32)
    for euclid in (True, False):
        want = np.asarray(jb.make_vector_scorer(jnp.asarray(x), jnp.asarray(q), euclid)(
            jnp.asarray(ids)))
        got = tb.make_vector_scorer(_t(x), _t(q), euclid)(_t(ids)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:, [2, 3, 5]] == BIG).all()
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 16, (N, 4)).astype(np.uint8)
    dtable = (rng.integers(0, 128, (Q, 4, 16)) / 8.0).astype(np.float32)
    want = np.asarray(jb.make_pq_scorer(jnp.asarray(codes), jnp.asarray(dtable),
                                        use_pallas=False)(jnp.asarray(ids)))
    got = tb.make_pq_scorer(_t(codes), _t(dtable))(_t(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('code_dtype,k', [(np.uint8, 16), (np.uint16, 1024)])
def test_lut_pq_plain_version_against_jax_reference(code_dtype, k):
    """K8's plain version against ``adc_scores_per_query_ref`` on random
    float tables (atol 1e-4, as the JAX package's own test), and against a
    numpy loop over m; ids outside [0, N) score BIG."""
    rng = np.random.default_rng(3)
    q, c, m, n = 5, 37, 8, 300
    dtable = rng.uniform(0, 10, (q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (n, m)).astype(code_dtype)
    ids = rng.integers(0, n, (q, c)).astype(np.int32)
    ids[:, :3] = [-1, n, tb.NO_ID]
    safe = np.where((ids >= 0) & (ids < n), ids, 0)
    want = np.asarray(jadc.adc_scores_per_query_ref(dtable, codes[safe]))
    got = tadc.lut_pq_scores(_t(ids), _t(codes), _t(dtable)).numpy()
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=1e-4)
    assert (got[:, :3] == BIG).all()
    loop = np.zeros((q, c), np.float32)
    for j in range(m):  # K8's order, 0..M-1, in float32
        loop = loop + dtable[np.arange(q)[:, None], j, codes[safe][:, :, j].astype(np.int64)]
    np.testing.assert_array_equal(got[:, 3:], loop[:, 3:])
    per_query = tadc.adc_scores_per_query(_t(dtable), _t(codes[safe])).numpy()
    np.testing.assert_array_equal(per_query[:, 3:], got[:, 3:])
    np.testing.assert_allclose(
        per_query, np.asarray(jadc.adc_scores_per_query(dtable, codes[safe],
                                                        use_pallas=False)), atol=1e-4)
    np.testing.assert_array_equal(tadc.adc_scores_per_query_ref(
        _t(dtable), _t(codes[safe])).numpy(), per_query)


def test_corpus_ceiling():
    with pytest.raises(ValueError):
        tb._check_corpus_fits(tb.NO_ID)
    tb._check_corpus_fits(tb.NO_ID - 1)
    assert tb.NO_ID == jb.NO_ID and tb.BIG == jb.BIG
    assert tb._resolve_iters(None, 128, 8) == jb._resolve_iters(None, 128, 8) == 32
