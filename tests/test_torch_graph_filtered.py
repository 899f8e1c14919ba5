"""A filtered graph search with the predicate inside the vector traversal.

At or above ``filter_fallback_selectivity`` the port's ``GraphIndex`` hands
its mask to ``beam_search_vectors``: every row is still scored and
expanded, and only passing rows enter the result list, so each list comes
back full.  The JAX package filters the ``ef`` list after the traversal
(post-filter), which leaves short lists; the port's answers are held to the
brute force inside the filter instead, and to recall no lower than the
post-filter's on the same graph.  The eager loop (the CPU path) and the
plain twin of the kernel (``_beam_ref``) must agree bit for bit; with no
mask nothing changes.  Rows and queries are small integers, so every
distance is exact in float32 in any order."""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch import profile
from annlite_torch.convert import graph_index_from_jax_state
from annlite_torch.index import graph as tg
from annlite_torch.index.vamana_lib import VamanaGraph
from annlite_torch.ops import BIG
from annlite_torch.ops import beam as tb
from annlite_tpu.enums import Metric
from annlite_tpu.index import graph as jg
from annlite_tpu.ops import beam as jb

ROOT = Path(__file__).resolve().parents[1]
N, D, NQ = 2000, 16, 48
KW = dict(max_degree=12, l_build=32, ef_search=16, beam_width=4,
          n_entry_samples=64, entry_width=4)
SELECTIVITIES = [0.3, 0.5, 0.8]


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-6, 7, (16, D))
    x = (centers[rng.integers(0, 16, N)] + rng.integers(-2, 3, (N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 16, NQ)] + rng.integers(-2, 3, (NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope='module')
def built():
    """The JAX index built once with one thread, and its state."""
    x, q = _data()
    j = jg.GraphIndex(D, metric=Metric.EUCLIDEAN, n_threads=1, **KW)
    j.add_with_ids(x, np.arange(N))
    return x, q, j.state_arrays()


def _pair(built):
    x, q, state = built
    j = jg.GraphIndex(D, metric=Metric.EUCLIDEAN, n_threads=1, **KW)
    j.load_state_arrays({k: np.array(v) for k, v in state.items()})
    t = graph_index_from_jax_state(state, metric='euclidean', n_threads=1, device='cpu', **KW)
    return j, t


def _mask(sel, seed=7):
    return np.random.default_rng(seed).random(N) < sel


def _exact(x, q):
    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1, dtype=np.float32)


def _recall(ids, d, x, q, mask, limit=10):
    """Mean share of each answer inside the exact ``limit``-th distance among
    the passing rows."""
    ex = np.where(mask[None, :], _exact(x, q), np.inf)
    kth = np.sort(ex, axis=1)[:, limit - 1]
    hits = [(ex[i, r[dd < 1e37]] <= kth[i]).sum() for i, (r, dd) in enumerate(zip(ids, d))]
    return float(np.mean(hits)) / limit


def _post_filter(t, q, mask, limit=10):
    """The parent's answer on the same graph: the unfiltered traversal's
    ``ef`` list with the failing rows dropped (``_mask_candidates``)."""
    s = t._sync_device()
    qt = torch.from_numpy(q)
    ef = max(t.ef_search, 4 * limit)
    entry = tg._sample_entries(s.entry_vecs, s.entry_ids, qt, True, min(t.entry_width, ef))
    d, ids = tb.beam_search_vectors(s.adj, entry, s.vectors, qt, True, k=ef, L=ef,
                                    B=t.beam_width)
    d, ids = tg._mask_candidates(d, ids, torch.from_numpy(mask))
    return d[:, :limit].numpy(), ids[:, :limit].numpy()


@pytest.mark.parametrize('selectivity', SELECTIVITIES)
def test_filtered_traversal_full_lists_exact_distances(built, selectivity):
    """(a) Every query gets ``limit`` rows, each passing, each at its exact
    float32 distance, sorted; recall inside the filter no lower than the
    post-filter's on the same graph, whose lists may come back short."""
    x, q, _ = built
    _, t = _pair(built)
    mask = _mask(selectivity)
    d, ids = t.search(q, limit=10, mask=mask)
    assert d.shape == ids.shape == (NQ, 10)
    assert (d < 1e37).all() and (ids >= 0).all() and (ids < N).all()
    assert mask[ids].all()
    assert all(len(set(r)) == 10 for r in ids)
    np.testing.assert_array_equal(d, np.take_along_axis(_exact(x, q), ids, axis=1))
    assert (np.diff(d, axis=1) >= 0).all()
    pd, pids = _post_filter(t, q, mask)
    assert _recall(ids, d, x, q, mask) >= _recall(pids, pd, x, q, mask)


def test_post_filter_leaves_short_lists_the_traversal_fills(built):
    """At 30% an ``ef`` of 16 keeps about 5 passing rows of its list: the
    post-filter leaves short lists, the filtered traversal none."""
    x, q, _ = built
    _, t = _pair(built)
    mask = _mask(0.3)
    pd, _ = _post_filter(t, q, mask)
    assert ((pd < 1e37).sum(1) < 10).any()
    d, _ = t.search(q, limit=10, mask=mask)
    assert ((d < 1e37).sum(1) == 10).all()


@pytest.fixture(scope='module')
def graph():
    """Integer rows and queries, one single-threaded build, entries of width 3."""
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, (700, D)).astype(np.float32)
    g = VamanaGraph(D, max_degree=12, l_build=32)
    g.add(x, n_threads=1)
    q = rng.integers(-3, 4, (7, D)).astype(np.float32)
    entry = rng.integers(0, 700, (7, 3)).astype(np.int32)
    entry[0, 1] = -1  # an invalid entry beside valid ones
    return g.adjacency(), x, q, entry


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('euclid', [True, False])
@pytest.mark.parametrize('selectivity', SELECTIVITIES)
@pytest.mark.parametrize('L,B,k', [(32, 4, 10), (24, 8, 24), (16, 4, 5)])
def test_twin_equals_the_eager_loop_with_the_predicate(graph, bf16, euclid, selectivity, L, B,
                                                       k):
    """(b) ``_beam_ref`` (the kernel's plain twin) and ``_beam_loop`` (the
    CPU path) under the same predicate: ids and distances bit for bit, the
    (BIG, NO_ID) padding included."""
    adj, x, q, entry = graph
    rows = _t(x).to(torch.bfloat16) if bf16 else _t(x)
    passes = torch.from_numpy(np.random.default_rng(3).random(700) < selectivity)
    its = tb._resolve_iters(None, L, B)
    want = tb.beam_search_vectors(_t(adj), _t(entry), rows, _t(q), euclid, k=k, L=L, B=B,
                                  passes=passes)
    got = tb._beam_vec_ref(_t(adj), _t(entry), rows, _t(q), euclid, L, B, its, k, passes)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    ok = got[1].numpy() != tb.NO_ID
    assert passes.numpy()[got[1].numpy()[ok]].all()


def test_twin_pads_when_few_rows_pass(graph):
    """(b) A predicate that passes 4 rows, one of them beyond a shorter mask:
    the lists hold the passing rows the walk scored, then (BIG, NO_ID)."""
    adj, x, q, entry = graph
    passes = torch.zeros(650, dtype=torch.bool)
    passes[[3, 40, 200, 649]] = True
    want = tb.beam_search_vectors(_t(adj), _t(entry), _t(x), _t(q), True, k=8, L=32, B=4,
                                  passes=passes)
    got = tb._beam_vec_ref(_t(adj), _t(entry), _t(x), _t(q), True, 32, 4,
                           tb._resolve_iters(None, 32, 4), 8, passes)
    for a, b in zip(got[:2], want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ids, d = got[1].numpy(), got[0].numpy()
    assert (ids[:, 4:] == tb.NO_ID).all() and (d[:, 4:] == np.float32(BIG)).all()
    assert np.isin(ids[ids != tb.NO_ID], [3, 40, 200, 649]).all()


@pytest.mark.parametrize('selectivity', SELECTIVITIES)
def test_filtered_equals_post_filter_where_the_list_holds_enough(graph, selectivity):
    """(b) The traversal's list is the best L rows of every row scored, in
    (distance, id) order after the first merge: where it holds ``k`` passing
    rows, the filtered result is exactly its passing prefix."""
    adj, x, q, entry = graph
    passes = torch.from_numpy(np.random.default_rng(5).random(700) < selectivity)
    d, ids = tb.beam_search_vectors(_t(adj), _t(entry), _t(x), _t(q), True, k=32, L=32, B=4)
    fd, fids = tb.beam_search_vectors(_t(adj), _t(entry), _t(x), _t(q), True, k=5, L=32, B=4,
                                      passes=passes)
    pd, pids = tg._mask_candidates(d, ids, passes)
    full = (pd < BIG / 2).sum(1) >= 5
    assert full.any()
    assert torch.equal(fids[full], pids[full, :5]) and torch.equal(fd[full], pd[full, :5])


@pytest.mark.parametrize('L,B,iters', [(32, 4, None), (16, 8, 3), (8, 16, None)])
def test_no_mask_traversal_unchanged(graph, L, B, iters):
    """(c) Without a predicate the CPU path and the twin answer as the JAX
    traversal does (the answer before the predicate existed), k = L."""
    adj, x, q, entry = graph
    b = min(B, L)
    want = jb.beam_search_vectors(jnp.asarray(adj), jnp.asarray(entry), jnp.asarray(x),
                                  jnp.asarray(q), True, k=L, L=L, B=B, iters=iters)
    its = tb._resolve_iters(iters, L, b)
    got = tb.beam_search_vectors(_t(adj), _t(entry), _t(x), _t(q), True, k=L, L=L, B=B,
                                 iters=iters)
    twin = tb._beam_vec_ref(_t(adj), _t(entry), _t(x), _t(q), True, L, b, its, L)
    for g in (got, twin[:2]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(want[1]))


def test_no_mask_search_unchanged(built):
    """(c) A graph search with no mask, and with a mask every row passes,
    answers as the JAX index on one graph, and counts no filtered query."""
    _, q, _ = built
    j, t = _pair(built)
    c0 = profile.snapshot()['counters']
    want = [np.asarray(a) for a in j.search(q, limit=10)]
    for mask in (None, np.ones(N, dtype=bool)):
        got = t.search(q, limit=10, mask=mask)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    c1 = profile.snapshot()['counters']
    for name in ('graph.filtered_queries', 'graph.fallback_queries'):
        assert c1.get(name, 0) == c0.get(name, 0)


@pytest.mark.parametrize('selectivity,path', [(0.1, 'fallback'), (0.5, 'filtered'),
                                              (None, 'plain')])
def test_span_and_counters_once_per_search(built, selectivity, path):
    """(d) A search below the fallback selectivity opens
    ``annlite.index.fallback`` once, inside ``annlite.index.dispatch``, and
    counts its queries in ``graph.fallback_queries``; one above it counts
    them in ``graph.filtered_queries``; one without a mask neither.  The
    request counters land on the request's root span."""
    _, q, _ = built
    _, t = _pair(built)
    mask = None if selectivity is None else _mask(selectivity)
    before = profile.snapshot()
    with profile.span('annlite.search'):
        t.search(q, limit=10, mask=mask)
    after = profile.snapshot()

    def delta(name):
        return after['counters'].get(name, 0) - before['counters'].get(name, 0)

    spans = after['spans'].get('annlite.index.fallback', {'count': 0})['count'] - \
        before['spans'].get('annlite.index.fallback', {'count': 0})['count']
    assert spans == (path == 'fallback')
    assert delta('graph.fallback_queries') == (NQ if path == 'fallback' else 0)
    assert delta('graph.filtered_queries') == (NQ if path == 'filtered' else 0)
    rec = profile.records()
    root = np.flatnonzero(rec['root'] & (rec['name'] == 'annlite.search'))[-1]
    assert rec['graph.fallback_queries'][root] == (NQ if path == 'fallback' else 0)
    assert rec['graph.filtered_queries'][root] == (NQ if path == 'filtered' else 0)
    if path == 'fallback':
        mine = rec['request'] == rec['seq'][root]
        fb = np.flatnonzero(mine & (rec['name'] == 'annlite.index.fallback'))
        assert len(fb) == 1
        parent = rec['name'][np.searchsorted(rec['seq'], rec['parent'][fb[0]])]
        assert parent == 'annlite.index.dispatch'


def test_new_cell_configuration_and_traffic_found_by_name():
    """(e) ``deep96.filtered64`` is found by name in ``BENCHMARK.json``, with
    the configuration and traffic the harness reads, and runs end to end at
    a tiny size on the CPU, correct, with no short list, its warm-up taking
    both paths; the new metrics' readers and the roofline are found by name."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness import Bench, configure, run_cell

    bench = Bench(ROOT / 'BENCHMARK.json')
    cell = bench.cell('deep96.filtered64')
    config, mix = configure(bench, cell)
    assert config['name'] == cell['config'] == 'deep-image-96-angular-filtered-graph'
    assert config['annlite'] == {'n_dim': 96, 'metric': 'cosine', 'index_type': 'graph',
                                 'graph_build_mode': 'device', 'max_degree': 32,
                                 'ef_construction': 200, 'ef_search': 50,
                                 'columns': [['price', 'float']]}
    assert config['n_docs'] == 262144 and config['data']['kwargs'] == {'d': 96}
    assert config['limits']['recall_at_10'] >= 0.95 and config['control'] == 'tf32'
    assert mix['filter'] == {'column': 'price', 'op': '$lt', 'values': [5, 15, 20, 30, 50, 80]}
    assert (mix['call'], mix['batch'], mix['limit'], mix['profile_requests']) == \
        ('search_numpy', 64, 10, 36)
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for m in ('index_fallback_ms.qps', 'fallback_queries_per_req.qps', 'beam_vec_roofline.qps'):
        entry = next(e for e in spec['per_layer'] if e['name'] == m)
        assert 'deep96.filtered64' in entry['workloads']
        assert callable(bench.reader('metrics', m).read)
    assert {m['name'] for m in bench.end_to_end(cell)} == \
        {'qps', 'recall_at_10', 'peak_device_gib', 'setup_s'}
    rf = bench.roofline('beam_vec')
    nbytes, ops = rf.bytes_ops(64, 50, 96, 4, 1, 10)
    assert nbytes == 64 * (4 * 96 + 50 * (96 * 4 + 1 + 4) + 80) and ops == 2.0 * 64 * 50 * 96
    tiny = {'n_docs': 3000, 'ingest_batch': 1000,
            'traffic': {'pool': 200, 'warmup_requests': 6, 'profile_requests': 6}}
    c0 = profile.snapshot()['counters']
    out = run_cell(bench, 'deep96.filtered64', 2**31 + 7, 0.5, False, device='cpu',
                   overrides=tiny)
    c1 = profile.snapshot()['counters']
    assert out['correct'] and out['failed'] == 0 and out['attempted'] >= 1
    assert out['detail']['faults']['short'] == 0
    # the warm-up sends every cap once: both paths ran
    for name in ('graph.fallback_queries', 'graph.filtered_queries'):
        assert c1.get(name, 0) - c0.get(name, 0) >= 3 * 64
