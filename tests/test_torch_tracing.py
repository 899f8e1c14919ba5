"""The port's tracer (`annlite_torch/profile.py`) on small flat and graph
stores on the CPU: the spans of a search and of an ingest, their nesting and
request ids, their place in a ``torch.profiler`` trace, threads, the loop's
iteration counter, switching it off, and the ring's bound."""
import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from annlite_torch import AnnLite, profile
from annlite_torch.doc import Doc
from annlite_torch.ops import beam

N, D = 2000, 16


def _store(tmp_path, kind):
    x = np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)
    kw = dict(index_type='graph', graph_build_mode='device') if kind == 'graph' else {}
    ann = AnnLite(D, metric='euclidean', columns=[('price', float)],
                  data_path=str(tmp_path / kind), device='cpu', **kw)
    for lo in range(0, N, 1000):
        ann.index([Doc(id=str(i), embedding=x[i], tags={'price': float(i)})
                   for i in range(lo, lo + 1000)])
    return ann, x


@pytest.fixture(scope='module', params=['flat', 'graph'])
def store(request, tmp_path_factory):
    ann, x = _store(tmp_path_factory.mktemp('tracing'), request.param)
    ann.search_numpy(x[:4], limit=5)  # the first search uploads the rows
    yield request.param, ann, x
    ann.close()


def _mark() -> int:
    seq = profile.records()['seq']
    return int(seq[-1]) if len(seq) else -1


def _since(mark: int):
    rec = profile.records()
    keep = rec['seq'] > mark
    return {k: (v[keep] if isinstance(v, np.ndarray) else v) for k, v in rec.items()}


def _parents(rec):
    """Name of each record's parent ('' for a root)."""
    pos = {int(s): i for i, s in enumerate(rec['seq'])}
    return [rec['name'][pos[int(p)]] if p >= 0 else '' for p in rec['parent']]


def _requests(rec):
    """(name, parent name) pairs of each request, by root seq."""
    out = {}
    for name, parent, req in zip(rec['name'], _parents(rec), rec['request']):
        out.setdefault(int(req), Counter())[(name, parent)] += 1
    return out


# the spans of one search_numpy call; the waits vary with the index
SEARCH_SPANS = {('annlite.search', ''): 1, ('annlite.filter', 'annlite.search'): 1,
                ('annlite.index', 'annlite.search'): 1,
                ('annlite.index.prep', 'annlite.index'): 1,
                ('annlite.index.dispatch', 'annlite.index'): 1,
                ('annlite.index.wait', 'annlite.index'): 1,      # the results' copy
                ('annlite.index.wait', 'annlite.index.prep'): 2,  # mask and query uploads
                ('annlite.storage.idmap', 'annlite.search'): 1}


def _expected(kind, ann, rec, root, limit=5):
    want = Counter(SEARCH_SPANS)
    if kind == 'graph':
        # the loop's termination checks, at iterations 0, 4, 8, ...: one more
        # than it ran through, unless it spent its budget
        idx = ann._container.index
        ef = max(idx.ef_search, 4 * limit)
        budget = beam._resolve_iters(None, ef, min(idx.beam_width, ef))
        ran = int(rec['graph.iters'][root])
        checks = -(-ran // 4) if ran == budget else ran // 4 + 1
        want[('annlite.index.wait', 'annlite.index.dispatch')] = checks
    return want


def test_search_spans_nest_and_share_the_request(store):
    kind, ann, x = store
    mark = _mark()
    for lo in (0, 8):
        ann.search_numpy(x[lo:lo + 8], limit=5)
    rec = _since(mark)
    roots = np.flatnonzero(rec['root'])
    assert list(rec['name'][roots]) == ['annlite.search'] * 2
    assert not rec['profiled'].any()
    reqs = _requests(rec)
    assert sorted(reqs) == sorted(rec['seq'][roots].tolist())
    for r in roots:
        assert reqs[int(rec['seq'][r])] == _expected(kind, ann, rec, r)
        assert rec['host_syncs'][r] == sum(n for (name, _), n in reqs[int(rec['seq'][r])].items()
                                           if name == 'annlite.index.wait')
    # every child inside its parent's interval
    pos = {int(s): i for i, s in enumerate(rec['seq'])}
    for i, p in enumerate(rec['parent']):
        if p >= 0:
            j = pos[int(p)]
            assert rec['t0'][j] <= rec['t0'][i] <= rec['t1'][i] <= rec['t1'][j]


def test_self_times_sum_to_the_root(store):
    _, ann, x = store
    mark = _mark()
    ann.search_numpy(x[:16], limit=10)
    rec = _since(mark)
    dur = rec['t1'] - rec['t0']
    pos = {int(s): i for i, s in enumerate(rec['seq'])}
    child = np.zeros_like(dur)
    for i, p in enumerate(rec['parent']):
        if p >= 0:
            child[pos[int(p)]] += dur[i]
    self_ns = dur - child
    assert (self_ns >= 0).all()
    root = np.flatnonzero(rec['root'])[0]
    assert self_ns.sum() == pytest.approx(dur[root], rel=0.01)


def test_counters_of_a_search(store):
    kind, ann, x = store
    mark = _mark()
    ann.search_numpy(x[:8], limit=5)
    rec = _since(mark)
    root = np.flatnonzero(rec['root'])[0]
    n_pad = ann._container.index._buf.device_view().shape[0] if kind == 'flat' else N
    # the flat index uploads an int8 mask over its padded rows, the graph a
    # bool mask over its rows (the container passes the alive bitmap), and
    # both the float32 queries
    assert rec['h2d_bytes'][root] == n_pad + 8 * D * 4
    assert (rec['graph.iters'][root] > 0) == (kind == 'graph')


def test_ingest_spans(tmp_path):
    mark = _mark()
    ann, _ = _store(tmp_path, 'graph')
    ann.close()
    rec = _since(mark)
    roots = np.flatnonzero(rec['root'])
    assert list(rec['name'][roots]) == ['annlite.ingest'] * 2
    names = Counter(zip(rec['name'], _parents(rec)))
    assert names[('annlite.ingest.store', 'annlite.ingest')] == 6  # 3 tables a call
    assert names[('annlite.ingest.index', 'annlite.ingest')] == 2
    stages = {n for (n, p) in names if p == 'annlite.ingest.index'}
    assert {'annlite.build.upload', 'annlite.build.intra', 'annlite.build.prune',
            'annlite.build.backedges', 'annlite.build.push',
            'annlite.build.repair'} <= stages
    assert ('annlite.build.pools', 'annlite.ingest.index') in names  # the second call


def test_spans_enter_the_profiler_trace(store, tmp_path):
    kind, ann, x = store
    mark = _mark()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        for lo in (0, 4):
            ann.search_numpy(x[lo:lo + 4], limit=5)
    rec = _since(mark)
    roots = np.flatnonzero(rec['root'])
    assert len(roots) == 2 and rec['profiled'][roots].all()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())['traceEvents']
          if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
          and str(e.get('name', '')).startswith('annlite.')]
    # each span once, nested as in the ring: an event's parent is the
    # innermost other event that encloses it
    ev.sort(key=lambda e: (e['ts'], -e['dur']))
    pairs = Counter()
    for i, e in enumerate(ev):
        enc = [f for f in ev[:i] if f['ts'] <= e['ts'] and e['ts'] + e['dur'] <= f['ts'] + f['dur']]
        pairs[(e['name'], enc[-1]['name'] if enc else '')] += 1
    assert pairs == Counter(zip(rec['name'], _parents(rec)))


def test_no_record_function_without_the_profiler(store, monkeypatch):
    _, ann, x = store
    entered = []
    monkeypatch.setattr(profile, 'record_function', lambda name: entered.append(name))
    mark = _mark()
    ann.search_numpy(x[:4], limit=5)
    assert entered == []
    assert len(_since(mark)['seq']) > 0


def test_threads_keep_their_own_stacks(store):
    """More threads than cores search at once, switching often: no span is
    parented across threads and no count is lost."""
    kind, ann, x = store
    n_threads, per = 12, 3
    mark = _mark()
    before = profile.snapshot()['spans']['annlite.search']['count']
    barrier = threading.Barrier(n_threads)
    errors = []

    def worker(lo):
        try:
            barrier.wait(timeout=60)
            for i in range(per):
                ann.search_numpy(x[lo + i:lo + i + 4], limit=5)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(10 * k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    n = n_threads * per
    assert profile.snapshot()['spans']['annlite.search']['count'] == before + n
    rec = _since(mark)
    roots = np.flatnonzero(rec['root'])
    assert len(roots) == n
    # the requests overlapped in time, and each has exactly one search's spans
    t0, t1 = rec['t0'][roots], rec['t1'][roots]
    assert any(t0[i] < t1[j] and t0[j] < t1[i] for i in range(n) for j in range(i))
    reqs = _requests(rec)
    for r in roots:
        assert reqs[int(rec['seq'][r])] == _expected(kind, ann, rec, r)


@pytest.mark.parametrize('iters', [2, 5, 64])
def test_graph_iters_counts_the_loop(iters):
    """``graph.iters`` is the iterations ``_beam_loop`` ran: the budget, or
    fewer where it left early (its score function runs once for the seed
    and once an iteration)."""
    rng = np.random.default_rng(3)
    n, r = 500, 8
    vecs = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    adj = torch.from_numpy(rng.integers(0, n, (n, r)).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((4, D)).astype(np.float32))
    entry = torch.zeros((4, 1), dtype=torch.int32)
    base = beam.make_vector_scorer(vecs, q, True)
    calls = []

    def score(ids):
        calls.append(1)
        return base(ids)

    before = profile.snapshot()['counters'].get('graph.iters', 0)
    beam._beam_loop(adj, entry, 16, 4, iters, 10, score)
    ran = profile.snapshot()['counters']['graph.iters'] - before
    assert ran == len(calls) - 1
    assert ran == iters if iters < 64 else 0 < ran < 64


def test_disabled_tracer_records_nothing(store):
    _, ann, x = store
    mark = _mark()
    before = profile.snapshot()
    was = profile.set_enabled(False)
    try:
        ann.search_numpy(x[:4], limit=5)
    finally:
        profile.set_enabled(was)
    assert len(_since(mark)['seq']) == 0
    assert profile.snapshot() == before
    ann.search_numpy(x[:4], limit=5)
    assert len(_since(mark)['seq']) > 0


def test_ring_stays_within_its_bound():
    tr = profile.Tracer(capacity=64)
    for i in range(1000):
        with tr.span('root'):
            with tr.span('child'):
                tr.count('host_syncs')
                assert tr.current() == ['root', 'child']
    assert tr.current() == []
    rec = tr.records()
    assert len(rec['seq']) == 64 and rec['first'] == 2000 - 64
    assert list(rec['seq']) == list(range(2000 - 64, 2000))
    assert tr.nbytes() == 64 * (5 * 8 + 2 + 1 + 8 * len(profile.REQUEST_COUNTERS))
    assert tr.snapshot()['spans']['child']['count'] == 1000
    assert tr.snapshot()['counters'] == {'host_syncs': 1000}
    roots = rec['root']
    assert (rec['host_syncs'][roots] == 1).all()
    # the program's ring: at most 16 MiB of host memory
    assert profile._TRACER.nbytes() <= 16 * 2**20


def test_first_search_uploads_the_rows_inside_a_wait(tmp_path):
    """After an ingest the flat index's rows reach the device at the first
    search, inside a wait under ``annlite.index.prep``, counted in
    ``h2d_bytes``."""
    ann, x = _store(tmp_path, 'flat')
    try:
        mark = _mark()
        ann.search_numpy(x[:8], limit=5)
        rec = _since(mark)
        root = np.flatnonzero(rec['root'])[0]
        waits = Counter(p for n, p in zip(rec['name'], _parents(rec)) if n == profile.WAIT)
        # the mask and the query, and one for each of the 4 buffers the
        # searcher reads (float32 rows, norms, int8 rows, scales)
        assert waits == {'annlite.index.prep': 6, 'annlite.index': 1}
        rows = ann._container.index._buf.device_view().shape[0]
        assert rec['h2d_bytes'][root] == rows * (D * 4 + 4 + D + 4) + rows + 8 * D * 4
    finally:
        ann.close()


def test_kernel_build_is_a_span(tmp_path, monkeypatch):
    """``annlite.kernels.build`` around the compilers, ``kernels_built`` the
    libraries they made (a stand-in compiler writes each output)."""
    from annlite_torch.ops import _ext

    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_ext, '_nvcc', lambda: str(nvcc))
    monkeypatch.setattr(_ext, 'BUILD_ROOT', tmp_path / 'build')
    before = profile.snapshot()
    libs = _ext.build()
    assert all(p.exists() for p in libs.values())
    _ext.build()  # built: nothing to do, no span
    after = profile.snapshot()
    n0 = before['spans'].get('annlite.kernels.build', {'count': 0})['count']
    assert after['spans']['annlite.kernels.build']['count'] == n0 + 1
    assert (after['counters']['kernels_built'] - before['counters'].get('kernels_built', 0)
            == len(_ext.SIGNATURES))
