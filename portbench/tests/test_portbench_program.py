"""The readers of the program's own spans and counters (``program.py``,
``metrics/*``) on a synthetic ring: which requests they read, their values,
and None without a card's trace, without a tracer, or once the ring dropped
the run's records; then a traced CPU run whose metric set is unchanged."""
import numpy as np
import pytest

from portbench import program
from portbench.harness import Bench, Context, run_cell

NEW = ('facade_span_ms.qps', 'storage_span_ms.qps', 'index_span_ms.qps', 'index_prep_ms.qps',
       'index_dispatch_ms.qps', 'index_wait_ms.qps', 'host_syncs_per_req.qps',
       'h2d_kib_per_req.qps', 'graph_iters_per_req.qps', 'ingest_store_s.setup_s',
       'ingest_index_s.setup_s')
COUNTERS = ('host_syncs', 'h2d_bytes', 'graph.iters')
MS = 1_000_000  # ns


class Ring:
    """Records in the layout of ``annlite_torch.profile.records()``."""

    def __init__(self):
        self.rows = []

    def add(self, name, t0, t1, parent=None, profiled=False, **counters):
        seq = len(self.rows)
        req = seq if parent is None else self.rows[parent]['request']
        self.rows.append({'seq': seq, 'name': name, 't0': t0, 't1': t1,
                          'parent': -1 if parent is None else parent, 'request': req,
                          'root': parent is None, 'profiled': profiled,
                          **{c: counters.get(c.replace('.', '_'), 0) for c in COUNTERS}})
        return seq

    def search(self, t, scale=1, profiled=False):
        """One request of ``10 * scale`` ms: facade 1, filter 1, index 6
        (prep 2 with a wait of 1, dispatch 2 with a wait of 1, a wait of 1),
        id map 2; 3 syncs, 448 KiB up, 12 iterations."""
        s = scale * MS
        r = self.add('annlite.search', t, t + 10 * s, profiled=profiled,
                     host_syncs=3, h2d_bytes=448 * 1024, graph_iters=12)
        self.add('annlite.filter', t, t + s, r)
        i = self.add('annlite.index', t + s, t + 7 * s, r)
        p = self.add('annlite.index.prep', t + s, t + 3 * s, i)
        self.add('annlite.index.wait', t + 2 * s, t + 3 * s, p)
        d = self.add('annlite.index.dispatch', t + 3 * s, t + 5 * s, i)
        self.add('annlite.index.wait', t + 4 * s, t + 5 * s, d)
        self.add('annlite.index.wait', t + 5 * s, t + 7 * s - s, i)
        self.add('annlite.storage.idmap', t + 7 * s, t + 9 * s, r)
        return t + 10 * s

    def ingest(self, t, store_s, index_s):
        r = self.add('annlite.ingest', t, t + int((store_s + index_s) * 1e9) + 1)
        self.add('annlite.ingest.store', t, t + int(store_s * 1e9), r)
        self.add('annlite.ingest.index', t + int(store_s * 1e9),
                 t + int((store_s + index_s) * 1e9), r)
        return t + int((store_s + index_s) * 1e9) + 1

    def records(self, first=0):
        out = {k: np.array([row[k] for row in self.rows]) for k in self.rows[0]}
        out['name'] = out['name'].astype(object)
        out['first'] = first
        return out


def _run_ring(n_window=3):
    """A run: two ingest calls, a warm-up of two (20 ms), the window (10 ms
    each), two profiled requests (30 ms); an earlier run's search before."""
    g = Ring()
    t = g.search(0, scale=5)
    t = g.ingest(t, 2.0, 3.0)
    t = g.ingest(t, 1.0, 4.0)
    for _ in range(2):
        t = g.search(t, scale=2)
    for _ in range(n_window):
        t = g.search(t)
    for _ in range(2):
        t = g.search(t, scale=3, profiled=True)
    return g


def _ctx(n_window=3, trace=True):
    tr = {'busy_s': 1.0, 'window_s': 2.0} if trace else None
    return Context(Bench(), {}, {}, {}, [{}] * n_window, [0.01] * n_window, tr)


def _read(name, ctx):
    return Bench().reader('metrics', name).read(ctx)


@pytest.fixture
def ring(monkeypatch):
    g = _run_ring()
    state = {'first': 0}
    monkeypatch.setattr(program, 'ring', lambda: g.records(state['first']))
    return state


def test_readers_take_the_window_and_the_ingest(ring):
    ctx = _ctx()
    want = {'facade_span_ms.qps': 1.0, 'storage_span_ms.qps': 2.0, 'index_span_ms.qps': 6.0,
            'index_prep_ms.qps': 1.0, 'index_dispatch_ms.qps': 1.0, 'index_wait_ms.qps': 3.0,
            'host_syncs_per_req.qps': 3.0, 'h2d_kib_per_req.qps': 448.0,
            'graph_iters_per_req.qps': 12.0, 'ingest_store_s.setup_s': 3.0,
            'ingest_index_s.setup_s': 7.0}
    got = {m: _read(m, ctx) for m in NEW}
    assert got == pytest.approx(want)
    # prep, dispatch and the waits cover the index span but for its own time
    assert got['index_prep_ms.qps'] + got['index_dispatch_ms.qps'] + \
        got['index_wait_ms.qps'] == pytest.approx(5.0)


def test_window_is_the_last_unprofiled_searches(ring):
    w = program.window(_ctx(4))  # one warm-up request joins the window
    assert w.n == 4
    assert w.ms_per_request('annlite.search') == pytest.approx((20 + 3 * 10) / 4)


@pytest.mark.parametrize('name', NEW)
def test_none_without_a_device_trace(ring, name):
    assert _read(name, _ctx(trace=False)) is None


@pytest.mark.parametrize('name', NEW)
def test_none_once_the_ring_dropped_the_run(ring, monkeypatch, name):
    g = Ring()  # only the last two window requests are left
    t = g.search(0)
    g.search(t)
    monkeypatch.setattr(program, 'ring', lambda: g.records(first=40))
    assert _read(name, _ctx()) is None


def test_ingest_none_when_the_ring_may_have_cut_it(monkeypatch):
    g = Ring()  # the ring starts inside the ingest block
    t = g.ingest(0, 1.0, 1.0)
    for _ in range(3):
        t = g.search(t)
    monkeypatch.setattr(program, 'ring', lambda: g.records(first=7))
    assert _read('ingest_store_s.setup_s', _ctx()) is None
    assert _read('index_span_ms.qps', _ctx()) == pytest.approx(6.0)
    monkeypatch.setattr(program, 'ring', lambda: g.records(first=0))  # nothing dropped
    assert _read('ingest_store_s.setup_s', _ctx()) == pytest.approx(1.0)


def test_none_without_the_tracer(monkeypatch):
    from annlite_torch import profile

    monkeypatch.delattr(profile, 'records')
    assert program.ring() is None
    assert all(_read(m, _ctx()) is None for m in NEW)


def test_traced_graph_run_on_cpu_keeps_its_metric_set():
    """No card, no trace: the new readers leave the line as it was."""
    tiny = {'n_docs': 3000, 'ingest_batch': 1000,
            'traffic': {'pool': 200, 'warmup_requests': 2, 'profile_requests': 2}}
    out = run_cell(Bench(), 'graph128.batch64', 2**31 + 7, 0.3, True, device='cpu',
                   overrides=tiny)
    assert out['correct']
    assert set(out['metrics']) == {'facade_ms.qps', 'storage_ms.qps', 'index_ms.qps'}
