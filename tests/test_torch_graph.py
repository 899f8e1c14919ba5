"""annlite_torch.index.graph against annlite_tpu.index.graph on one graph.

The JAX index is built once with one thread (deterministic); its
``state_arrays()`` go into the port through ``graph_index_from_jax_state``.
Rows, queries and PQ codebooks are small integers, so every distance and
table sum is exact in float32 in any order, and both packages return equal
ids and distances in the traversal modes whose scores are exact; cosine data
and the int8 and packed scorers get stated tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest

from annlite_torch.convert import graph_index_from_jax_state, pq_codec_from_jax_state
from annlite_torch.index import graph as tg
from annlite_tpu.codecs import PQCodec as JPQCodec
from annlite_tpu.enums import Metric
from annlite_tpu.index import graph as jg

N, D = 900, 16
KW = dict(max_degree=12, l_build=32, ef_search=32, beam_width=4,
          n_entry_samples=64, entry_width=4)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-6, 7, (8, D))
    x = (centers[rng.integers(0, 8, N)] + rng.integers(-2, 3, (N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 8, 6)] + rng.integers(-2, 3, (6, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope='module')
def built():
    x, q = _data()
    j = jg.GraphIndex(D, metric=Metric.EUCLIDEAN, n_threads=1, **KW)
    j.add_with_ids(x, np.arange(N))
    return x, q, j.state_arrays()


@pytest.fixture(scope='module')
def codecs():
    """A PQ codec with integer codebooks in both packages (exact tables)."""
    jpq = JPQCodec(D, n_subvectors=4, n_clusters=16, metric=Metric.EUCLIDEAN)
    jpq._codebooks = np.random.default_rng(5).integers(-6, 7, (4, 16, 4)).astype(np.float32)
    jpq._is_trained = True
    st = jpq._state()
    return jpq, pq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')


def _pair(built, codecs=None, metric='euclidean', **kw):
    x, q, state = built
    jpq, tpq = codecs if codecs else (None, None)
    j = jg.GraphIndex(D, metric=Metric.from_string(metric), pq_codec=jpq, n_threads=1,
                      **KW, **kw)
    # the JAX index keeps the alive array it is given: each gets its own
    j.load_state_arrays({k: np.array(v) for k, v in state.items()})
    t = graph_index_from_jax_state(state, tpq, metric=metric, n_threads=1, device='cpu',
                                   **KW, **kw)
    return j, t


def _eq(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


# (traverse, with a codec, rerank): traversal on the float32 rows; PQ table
# traversal at rerank 0 and with an exact rerank over the bf16 copy; vector
# traversal over the bf16 copy with and without a rerank
EXACT_MODES = [('auto', False, 0), ('pq', True, 0), ('pq', True, 20), ('auto', True, 20),
               ('vectors', True, 0)]


@pytest.mark.parametrize('traverse,with_pq,rerank', EXACT_MODES)
def test_search_equal_in_exact_modes(built, codecs, traverse, with_pq, rerank):
    j, t = _pair(built, codecs if with_pq else None, traverse=traverse, rerank=rerank)
    q = built[1]
    if with_pq:
        x = built[0]
        np.testing.assert_array_equal(t.pq_codec.encode(x), j.pq_codec.encode(x))
    _eq(t.search(q, limit=10), j.search(q, limit=10))
    assert t._pq_traverse() == j._pq_traverse() == (traverse == 'pq')
    _eq(t.search(q[:1], limit=3), j.search(q[:1], limit=3))


@pytest.mark.parametrize('traverse', ['int8', 'packed'])
def test_search_int8_and_packed_within_tolerance(built, traverse):
    """int8-scored traversal may break a tie the other way (XLA fuses the
    scorer's last multiply-add); the exact rerank returns float32 distances:
    equal at rtol 1e-6, and the same recall@10 as the JAX index."""
    j, t = _pair(built, traverse=traverse)
    x, q, _ = built
    (td, ti), (jd, ji) = t.search(q, limit=10), j.search(q, limit=10)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1, kind='stable')[:, :10]
    rec = lambda ids: np.mean([len(set(a) & set(b)) for a, b in zip(ids, gt)])  # noqa: E731
    assert rec(ti) == rec(ji)


def test_cosine_within_tolerance(built):
    x, q, state = built
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    j = jg.GraphIndex(D, metric=Metric.COSINE, n_threads=1, **KW)
    j.load_state_arrays(dict(state, vectors=xn))
    t = graph_index_from_jax_state(dict(state, vectors=xn), metric='cosine', device='cpu',
                                   **KW)
    (td, ti), (jd, ji) = t.search(q, limit=10), j.search(q, limit=10)
    np.testing.assert_allclose(td, jd, atol=1e-5)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ xn.T), axis=1, kind='stable')[:, :10]
    rec = lambda ids: np.mean([len(set(a) & set(b)) for a, b in zip(ids, gt)])  # noqa: E731
    assert rec(ti) == rec(ji)


@pytest.mark.parametrize('selectivity', [0.5, 0.1])
def test_mask_branches_equal(built, selectivity):
    """At 50% the mask is applied at selection after traversal; at 10%
    (below filter_fallback_selectivity 0.25) a masked exact scan runs."""
    j, t = _pair(built)
    q = built[1]
    mask = np.random.default_rng(7).random(N) < selectivity
    td, ti = t.search(q, limit=10, mask=mask)
    _eq((td, ti), j.search(q, limit=10, mask=mask))
    assert mask[ti[td < 1e37]].all()


def test_deletes_updates_and_appends_equal(built):
    j, t = _pair(built)
    x, q, _ = built
    dead = np.unique(j.search(q, limit=10)[1][:, :2])
    j.delete_rows(dead)
    t.delete_rows(dead)
    assert t.n_deleted == j.n_deleted and t.dead_fraction == j.dead_fraction
    d, ids = t.search(q, limit=10)
    assert not np.isin(ids, dead).any()
    _eq((d, ids), j.search(q, limit=10))
    rows = np.array([3, 50, 400], dtype=np.int32)
    newv = (x[rows] + 3.0).astype(np.float32)
    j.update_with_ids(newv, rows)
    t.update_with_ids(newv, rows)
    np.testing.assert_array_equal(t._graph.adjacency(), j._graph.adjacency())
    _eq(t.search(newv, limit=5), j.search(newv, limit=5))
    assert list(t.search(newv, limit=1)[1][:, 0]) == list(rows)
    extra = (x[:40] + 1.0).astype(np.float32)
    j.add_with_ids(extra, np.arange(N, N + 40))
    t.add_with_ids(extra, np.arange(N, N + 40))
    assert t.size == j.size == N + 40
    np.testing.assert_array_equal(t._graph.adjacency(), j._graph.adjacency())
    _eq(t.search(q, limit=10), j.search(q, limit=10))
    with pytest.raises(ValueError):
        t.add_with_ids(extra, np.arange(5, 45))
    with pytest.raises(ValueError):
        t.update_with_ids(extra[:1], np.array([t.size]))


@pytest.mark.parametrize('traverse,with_pq,rerank', EXACT_MODES[:3])
def test_device_searcher_matches_search_and_jax(built, codecs, traverse, with_pq, rerank):
    j, t = _pair(built, codecs if with_pq else None, traverse=traverse, rerank=rerank)
    q = built[1]
    t.delete_rows([0, 1, 2])
    j.delete_rows([0, 1, 2])
    td, ti = (a.numpy() for a in t.device_searcher(limit=10)(q))
    _eq((td, ti), t.search(q, limit=10))
    _eq((td, ti), (np.asarray(a) for a in j.device_searcher(limit=10)(jnp.asarray(q))))
    # the searcher keeps the state it was built on
    run = t.device_searcher(limit=10)
    t.delete_rows(ti[:, 0])
    np.testing.assert_array_equal(run(q)[1].numpy(), ti)
    assert not np.isin(t.device_searcher(limit=10)(q)[1].numpy(), ti[:, 0]).any()


def test_check_integrity_equal(built):
    j, t = _pair(built)
    t.delete_rows([1, 2])
    j.delete_rows([1, 2])
    rep = t.check_integrity()
    assert rep == j.check_integrity() and rep['ok']
    assert tg.GraphIndex(D, device='cpu').check_integrity() == {'n': 0, 'ok': True}
    adj = np.full((8, 3), -1, np.int32)
    for i in range(4):  # two disjoint 4-cliques
        adj[i] = [k for k in range(4) if k != i]
        adj[4 + i] = [4 + k for k in range(4) if k != i]
    part = tg.graph_integrity_report(adj, medoid=0, n=8)
    assert part == jg.graph_integrity_report(adj, medoid=0, n=8) and not part['ok']


@pytest.mark.parametrize('metric_ip', [False, True])
def test_consolidate_adjacency_equal(built, metric_ip):
    x, _, state = built
    rng = np.random.default_rng(9)
    slack = rng.integers(-1, N, (N, 6)).astype(np.int32)
    wide = np.concatenate([state['adjacency'], slack], axis=1)
    np.testing.assert_array_equal(
        tg.consolidate_adjacency(x, wide, 12, metric_ip=metric_ip),
        jg.consolidate_adjacency(x, wide, 12, metric_ip=metric_ip))


def test_wide_state_is_consolidated_on_load(built):
    """A W-wide adjacency (the JAX device build's snapshot) loads into both
    host builders through the same consolidation."""
    x, q, state = built
    slack = np.random.default_rng(9).integers(-1, N, (N, 6)).astype(np.int32)
    wide = dict(state, adjacency=np.concatenate([state['adjacency'], slack], axis=1))
    _, t = _pair((x, q, wide))
    j = jg.GraphIndex(D, metric=Metric.EUCLIDEAN, n_threads=1, **KW)
    j.load_state_arrays(wide)
    np.testing.assert_array_equal(t._graph.adjacency(), j._graph.adjacency())
    _eq(t.search(q, limit=10), j.search(q, limit=10))


def test_port_state_loads_into_jax(built):
    _, t = _pair(built)
    q = built[1]
    t.delete_rows([5, 6])
    j = jg.GraphIndex(D, metric=Metric.EUCLIDEAN, n_threads=1, **KW)
    j.load_state_arrays(t.state_arrays())
    assert j.n_deleted == 2
    _eq(t.search(q, limit=10), j.search(q, limit=10))


def test_small_and_empty_indexes():
    t = tg.GraphIndex(D, metric='euclidean', device='cpu', **KW)
    d, ids = t.search(np.zeros((2, D), np.float32), limit=5)
    assert d.shape == (2, 0) and ids.shape == (2, 0)
    x, _ = _data()
    t.add_with_ids(x[:3], np.arange(3))
    d, ids = t.search(x[:3], limit=5)
    assert list(ids[:, 0]) == [0, 1, 2] and (d[:, 3:] > 1e37).all()


def test_unported_options_raise():
    with pytest.raises(ValueError, match='build_mode'):
        tg.GraphIndex(D, build_mode='gpu', device='cpu')
    with pytest.raises(ValueError):
        tg.GraphIndex(D, traverse='nope', device='cpu')
