"""annlite_torch's serving layer against annlite_tpu's on identical docs: the
executor's endpoints, the HTTP and gRPC front ends (real sockets), the shard
gateway, the micro-batcher and the CLI (every case of `tests/test_executor.py`).
The port runs with device='cpu', JAX on the CPU.  Servers bind ephemeral
ports (the port's read back the bound port; the JAX ones take a port a
socket found free), and every server and executor stops in ``finally``."""
import asyncio
import json
import shutil
import socket
import sys
import threading
import time
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import msgpack
import numpy as np
import pytest

import annlite_torch.doc as tdoc
import annlite_torch.serving.__main__ as tcli
import annlite_tpu.doc as jdoc
import annlite_tpu.serving.__main__ as jcli
from annlite_torch.ops import _ext
from annlite_torch.serving import AnnLiteIndexer as TIndexer
from annlite_torch.serving import Gateway as TGateway
from annlite_torch.serving import Server as TServer
from annlite_torch.serving.artifact_server import ArtifactServer as TArtifactServer
from annlite_torch.serving.batcher import QueryBatcher as TBatcher
from annlite_torch.serving.gateway import ShardError as TShardError
from annlite_torch.serving.grpc_server import GrpcClient as TGrpcClient
from annlite_torch.serving.grpc_server import GrpcServer as TGrpcServer
from annlite_tpu.serving import AnnLiteIndexer as JIndexer
from annlite_tpu.serving import Gateway as JGateway
from annlite_tpu.serving import Server as JServer
from annlite_tpu.serving.batcher import QueryBatcher as JBatcher
from annlite_tpu.serving.gateway import ShardError as JShardError
from annlite_tpu.serving.grpc_server import GrpcClient as JGrpcClient
from annlite_tpu.serving.grpc_server import GrpcServer as JGrpcServer

D = 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _x(n, seed=0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal((n, D)) + offset).astype(np.float32)


def _docs(mod, x, start=0, tags=True):
    return [mod.Doc(id=f'doc{start + i}', embedding=x[i],
                    tags={'i': start + i} if tags else {})
            for i in range(len(x))]


def _json_docs(x, start=0, tags=True):
    out = []
    for i in range(len(x)):
        d = {'id': f'doc{start + i}', 'embedding': x[i].tolist()}
        if tags:
            d['tags'] = {'i': start + i}
        out.append(d)
    return out


def _same_matches(t_matches, j_matches):
    """Same ids in the same order; scores allclose at rtol 1e-5 (both
    packages rerank in float32).  Takes lists of ``Doc`` or of JSON maps."""
    get = lambda m, k: getattr(m, k) if hasattr(m, k) else m[k]
    assert [get(m, 'id') for m in t_matches] == [get(m, 'id') for m in j_matches]
    np.testing.assert_allclose([get(m, 'score') for m in t_matches],
                               [get(m, 'score') for m in j_matches], rtol=1e-5, atol=1e-6)


def _same_results(t_docs, j_docs):
    assert len(t_docs) == len(j_docs)
    for a, b in zip(t_docs, j_docs):
        _same_matches(a.matches if hasattr(a, 'matches') else a['matches'],
                      b.matches if hasattr(b, 'matches') else b['matches'])


STATUS_KEYS = ('total_docs', 'index_size', 'n_cells', 'n_dim', 'metric', 'is_trained',
               'params_hash', 'shard_id', 'buffer_size', 'quarantined_docs')


def _same_status(ts, js):
    assert {k: ts[k] for k in STATUS_KEYS} == {k: js[k] for k in STATUS_KEYS}
    assert [d['id'] for d in ts['dead_letter']] == [d['id'] for d in js['dead_letter']]


@pytest.fixture
def pair(tmp_path):
    t = TIndexer(n_dim=D, data_path=str(tmp_path / 't'), columns=[('i', int)], device='cpu')
    try:
        j = JIndexer(n_dim=D, data_path=str(tmp_path / 'j'), columns=[('i', int)])
    except BaseException:
        t.close()
        raise
    try:
        yield t, j
    finally:
        t.close()
        j.close()


def test_async_buffer_indexing(pair):
    t, j = pair
    x = _x(50)
    t.index(_docs(tdoc, x))
    j.index(_docs(jdoc, x))
    t.flush()
    j.flush()
    st = t.status()
    assert st['total_docs'] == 50
    assert st['buffer_size'] == 0
    _same_status(st, j.status())


def test_update_delete_refused_while_buffered(pair):
    x = _x(4)
    for ex, mod in zip(pair, (tdoc, jdoc)):
        # hold the lock the index loop uses so the buffer can't drain
        with ex._index_lock:
            ex._data_buffer.extend(_docs(mod, x[:3]))
            with pytest.raises(RuntimeError):
                ex.update(_docs(mod, x[3:]))
            with pytest.raises(RuntimeError):
                ex.delete(parameters={'ids': ['doc0']})
            ex._data_buffer.clear()


def test_search_and_filter_endpoints(pair):
    t, j = pair
    x = _x(30)
    t.index(_docs(tdoc, x))
    j.index(_docs(jdoc, x))
    t.flush()
    j.flush()
    tq = [tdoc.Doc(id=f'q{i}', embedding=x[i] + 0.01) for i in range(6)]
    jq = [jdoc.Doc(id=f'q{i}', embedding=x[i] + 0.01) for i in range(6)]
    tres = t.search(tq, parameters={'limit': 10})
    _same_results(tres, j.search(jq, parameters={'limit': 10}))
    assert tres[3].matches[0].id == 'doc3'
    flt = {'filter': {'i': {'$lt': 5}}, 'limit': 100}
    out = t.filter(parameters=flt)
    assert len(out) == 5
    assert [d.id for d in out] == [d.id for d in j.filter(parameters=flt)]
    filled = t.fill_embedding([tdoc.Doc(id='doc7')])
    assert filled[0].embedding is not None
    assert filled[0].embedding.tobytes() == j.fill_embedding([jdoc.Doc(id='doc7')])[0].embedding.tobytes()
    assert filled[0].embedding.tobytes() == x[7].tobytes()
    flt = {'filter': {'i': {'$gte': 20}}, 'limit': 5}
    tres = t.search(tq, parameters=flt)
    _same_results(tres, j.search(jq, parameters=flt))
    assert all(m.tags['i'] >= 20 for d in tres for m in d.matches)


def _post(base, ep, payload, timeout=30):
    req = urllib.request.Request(base + ep, data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def _get(base, ep, timeout=30):
    return json.loads(urllib.request.urlopen(base + ep, timeout=timeout).read())


class _ServerPair:
    """The port's HTTP server (port 0) and the JAX package's (a free port),
    each over its own executor; ``post``/``get`` return both replies."""

    def __init__(self, tmp_path, name, **kw):
        self.servers = []
        try:
            t = TIndexer(n_dim=D, data_path=str(tmp_path / f'{name}_t'), device='cpu', **kw)
            self.servers.append(TServer(t, port=0).start())
            j = JIndexer(n_dim=D, data_path=str(tmp_path / f'{name}_j'), **kw)
            self.servers.append(JServer(j, port=_free_port()).start())
        except BaseException:
            self.stop()
            raise
        self.bases = [f'http://127.0.0.1:{s.port}' for s in self.servers]

    def post(self, ep, payload):
        return [_post(b, ep, payload) for b in self.bases]

    def get(self, ep):
        return [_get(b, ep) for b in self.bases]

    def flush(self):
        for s in self.servers:
            s.executor.flush()

    def stop(self):
        for s in self.servers:
            s.stop()


def test_http_server_roundtrip(tmp_path):
    srv = _ServerPair(tmp_path, 'srv', columns=[('i', int)])
    try:
        docs = _json_docs(_x(20))
        srv.post('/index', {'docs': docs})
        srv.flush()
        ts, js = srv.get('/status')
        assert ts['total_docs'] == 20
        _same_status(ts, js)
        t, j = srv.post('/search', {'docs': [docs[4]], 'parameters': {'limit': 10}})
        assert t['results'][0]['matches'][0]['id'] == 'doc4'
        _same_results(t['results'], j['results'])
        t, j = srv.post('/filter', {'parameters': {'filter': {'i': {'$gte': 18}}, 'limit': 10}})
        assert {d['id'] for d in t['docs']} == {'doc18', 'doc19'}
        assert t == j
        srv.post('/delete', {'parameters': {'ids': ['doc4']}})
        t, j = srv.post('/search', {'docs': [docs[4]], 'parameters': {'limit': 10}})
        assert all(m['id'] != 'doc4' for m in t['results'][0]['matches'])
        _same_results(t['results'], j['results'])
    finally:
        srv.stop()


def _shards(tmp_path, cls, server_cls, ws, n, ports, **kw):
    servers = []
    try:
        for si in range(n):
            extra = {'device': 'cpu'} if cls is TIndexer else {}
            ex = cls(n_dim=D, workspace=str(tmp_path / ws), shard_id=si, shards=n, **extra, **kw)
            servers.append(server_cls(ex, port=ports(si)).start())
    except BaseException:
        for s in servers:
            s.stop()
        raise
    return servers


def _port_shards(tmp_path, n, ws='ws_t', **kw):
    return _shards(tmp_path, TIndexer, TServer, ws, n, lambda si: 0, **kw)


def _jax_shards(tmp_path, n, ws='ws_j', **kw):
    return _shards(tmp_path, JIndexer, JServer, ws, n, lambda si: _free_port(), **kw)


def _urls(servers):
    return [f'http://127.0.0.1:{s.port}' for s in servers]


def test_sharded_gateway(tmp_path):
    """3 real HTTP shard servers + gateway scatter/gather, in each package:
    the port's gateway over the port's shards equals the JAX pair."""
    servers = []
    try:
        servers += _port_shards(tmp_path, 3, columns=[('i', int)])
        servers += _jax_shards(tmp_path, 3, columns=[('i', int)])
        gws = [TGateway(_urls(servers[:3])), JGateway(_urls(servers[3:]))]
        docs = _json_docs(_x(30))
        for gw in gws:
            # scatter writes in 3 chunks -> different shards
            for i in range(0, 30, 10):
                gw.index(docs[i: i + 10])
        for s in servers:
            s.executor.flush()
        st = [gw.status() for gw in gws]
        assert st[0]['total_docs'] == st[1]['total_docs'] == 30  # sum over shards
        assert [s['total_docs'] for s in st[0]['shards']] == [10, 10, 10]
        for a, b in zip(st[0]['shards'], st[1]['shards']):
            _same_status(a, b)
        # broadcast search returns the global best, merged by score
        t, j = [gw.search([docs[17], docs[3]], parameters={'limit': 10}) for gw in gws]
        assert t[0]['matches'][0]['id'] == 'doc17'
        _same_results(t, j)
        for gw in gws:
            gw.delete(['doc17'])
        t, j = [gw.search([docs[17]], parameters={'limit': 10}) for gw in gws]
        assert all(m['id'] != 'doc17' for m in t[0]['matches'])
        _same_results(t, j)
        t, j = [gw.filter({'filter': {'i': {'$lt': 4}}, 'limit': 10}) for gw in gws]
        assert sorted(d['id'] for d in t) == sorted(d['id'] for d in j) == [
            'doc0', 'doc1', 'doc2', 'doc3']
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize('cls', [TIndexer, JIndexer], ids=['torch', 'jax'])
def test_executor_requires_n_dim(cls):
    with pytest.raises(ValueError):
        cls()


@pytest.mark.parametrize('cls', [TIndexer, JIndexer], ids=['torch', 'jax'])
def test_shards_forbid_data_path(tmp_path, cls):
    with pytest.raises(ValueError):
        cls(n_dim=D, shards=2, data_path=str(tmp_path / 'x'))


def test_grpc_roundtrip(tmp_path):
    """Unary gRPC transport (msgpack payloads) over a real channel, in each
    package, and each client against the other package's server: the same
    replies."""
    x = _x(25)
    servers = []
    try:
        t_ex = TIndexer(n_dim=D, data_path=str(tmp_path / 'grpc_t'), columns=[('i', int)],
                        device='cpu')
        servers.append(TGrpcServer(t_ex, port=0).start())
        j_ex = JIndexer(n_dim=D, data_path=str(tmp_path / 'grpc_j'), columns=[('i', int)])
        servers.append(JGrpcServer(j_ex, port=_free_port()).start())
        t_addr, j_addr = servers[0].address, servers[1].address
        t_client, j_client = TGrpcClient(t_addr), JGrpcClient(j_addr)
        try:
            t_client.index(_docs(tdoc, x))
            j_client.index(_docs(jdoc, x))
            t_ex.flush()
            j_ex.flush()
            st = t_client.status()
            assert st['total_docs'] == 25
            _same_status(st, j_client.status())
            q = x[6] + 0.01
            t = t_client.search([tdoc.Doc(id='q', embedding=q)], parameters={'limit': 10})
            j = j_client.search([jdoc.Doc(id='q', embedding=q)], parameters={'limit': 10})
            assert t['results'][0]['matches'][0]['id'] == 'doc6'
            _same_results(t['results'], j['results'])
            # each client speaks to the other package's server
            cross_t = JGrpcClient(t_addr)
            cross_j = TGrpcClient(j_addr)
            try:
                assert cross_t.search([jdoc.Doc(id='q', embedding=q)],
                                      parameters={'limit': 10}) == t
                assert cross_j.search([tdoc.Doc(id='q', embedding=q)],
                                      parameters={'limit': 10}) == j
            finally:
                cross_t.close()
                cross_j.close()
            t_client.delete(['doc6'])
            j_client.delete(['doc6'])
            t = t_client.search([tdoc.Doc(id='q', embedding=q)], parameters={'limit': 10})
            j = j_client.search([jdoc.Doc(id='q', embedding=q)], parameters={'limit': 10})
            assert all(m['id'] != 'doc6' for m in t['results'][0]['matches'])
            _same_results(t['results'], j['results'])
            # filter endpoint carries embeddings back, bit for bit
            req = {'parameters': {'filter': {'i': {'$lt': 2}}, 'limit': 10}}
            t, j = t_client.call('Filter', req), j_client.call('Filter', req)
            assert {d['id'] for d in t['docs']} == {'doc0', 'doc1'}
            assert 'emb' in t['docs'][0]
            assert t == j
        finally:
            t_client.close()
            j_client.close()
    finally:
        for s in servers:
            s.stop()


def test_http_concurrent_search_batching(tmp_path):
    """Concurrent /search requests with equal parameters share device
    dispatches (serving/batcher.py) and each gets its own results: those of
    the JAX executor's search of the same query."""
    x = _x(50)
    j = JIndexer(n_dim=D, data_path=str(tmp_path / 'ref_j'))
    ex = TIndexer(n_dim=D, data_path=str(tmp_path / 'srv_b'), device='cpu')
    server = TServer(ex, port=0).start()
    try:
        base = f'http://127.0.0.1:{server.port}'
        docs = _json_docs(x, tags=False)
        _post(base, '/index', {'docs': docs})
        j.index(_docs(jdoc, x, tags=False))
        ex.flush()
        j.flush()

        def one(i):
            r = _post(base, '/search', {'docs': [docs[i]], 'parameters': {'limit': 10}},
                      timeout=60)
            return r['results'][0]['matches']

        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(one, range(32)))
        assert [m[0]['id'] for m in got] == [f'doc{i}' for i in range(32)]
        want = j.search([jdoc.Doc(id=f'q{i}', embedding=x[i]) for i in range(32)],
                        parameters={'limit': 10})
        for g, w in zip(got, want):
            _same_matches(g, w.matches)
        st = _get(base, '/status')
        assert st['batcher']['batched_requests'] == 32
        # timing-dependent: 32 sequential completions CAN legally produce 32
        # dispatches; coalescing is proven in test_batcher_coalesces_under_load
        assert st['batcher']['device_dispatches'] <= 32
    finally:
        server.stop()
        j.close()


def test_http_status_reports_the_tracer(tmp_path):
    """/status carries the process's span totals and counters under
    ``tracing``: after a search, ``annlite.search`` with its count."""
    ex = TIndexer(n_dim=D, data_path=str(tmp_path / 'srv_t'), device='cpu')
    server = TServer(ex, port=0).start()
    try:
        base = f'http://127.0.0.1:{server.port}'
        docs = _json_docs(_x(20), tags=False)
        _post(base, '/index', {'docs': docs})
        ex.flush()
        _post(base, '/search', {'docs': docs[:2], 'parameters': {'limit': 5}})
        st = _get(base, '/status')
        assert st['total_docs'] == 20
        spans = st['tracing']['spans']
        assert spans['annlite.search']['count'] >= 1
        assert spans['annlite.search']['total_ns'] > 0
        assert st['tracing']['counters']['host_syncs'] >= 1
    finally:
        server.stop()


@pytest.mark.parametrize('cls', [TBatcher, JBatcher], ids=['torch', 'jax'])
def test_batcher_coalesces_under_load(cls):
    """8 concurrent submits with identical parameters and max_batch=8 share
    exactly ONE dispatch (the window closes when the pending-query count
    reaches max_batch, so no timing assumptions)."""
    calls = []

    def search_fn(docs, params):
        calls.append(len(docs))
        return [f'r{i}' for i in range(len(docs))]

    async def main():
        b = cls(search_fn, max_batch=8, max_wait_ms=5000.0)
        outs = await asyncio.gather(*(b.submit([f'd{i}'], {'limit': 3}) for i in range(8)))
        assert [o for out in outs for o in out] == [f'r{i}' for i in range(8)]
        assert b.n_dispatches == 1
        assert b.stats == {'batched_requests': 8, 'device_dispatches': 1}
        assert calls == [8]
        await b.close()

    asyncio.run(main())


@pytest.mark.parametrize('cls', [TBatcher, JBatcher], ids=['torch', 'jax'])
def test_batcher_worker_survives_failures(cls):
    """A failing search_fn fails its waiters but leaves the worker alive."""
    state = {'fail': True}

    def search_fn(docs, params):
        if state['fail']:
            raise RuntimeError('boom')
        return list(docs)

    async def main():
        b = cls(search_fn, max_batch=4, max_wait_ms=50.0)
        results = await asyncio.gather(b.submit(['a'], None), b.submit(['b'], None),
                                       return_exceptions=True)
        assert all(isinstance(r, RuntimeError) for r in results)
        state['fail'] = False
        assert await b.submit(['c'], None) == ['c']
        await b.close()

    asyncio.run(main())


def test_batcher_groups_by_parameters():
    """Requests with different parameters never share a dispatch: two
    groups, two dispatches, each request's own rows, in both packages."""
    outs = {}
    for name, cls in (('torch', TBatcher), ('jax', JBatcher)):
        calls = []

        def search_fn(docs, params, calls=calls):
            calls.append((len(docs), params['limit']))
            return [f'{d}@{params["limit"]}' for d in docs]

        async def main(cls=cls):
            b = cls(search_fn, max_batch=6, max_wait_ms=5000.0)
            out = await asyncio.gather(*(b.submit([f'd{i}'], {'limit': 3 + i % 2})
                                         for i in range(6)))
            assert b.n_dispatches == 2
            await b.close()
            return out

        outs[name] = (asyncio.run(main()), sorted(calls))
    assert outs['torch'] == outs['jax']
    assert outs['torch'][1] == [(3, 3), (3, 4)]


def test_poison_doc_quarantined_loop_alive(tmp_path):
    """A bad doc (wrong embedding dim) must not kill the ingest loop: the
    batch retries per doc, the poison lands in the dead-letter list, and
    index/flush keep working afterwards, as in the JAX executor."""
    x = _x(13)
    bad = np.random.default_rng(1).standard_normal(D + 3).astype(np.float32)
    t = TIndexer(n_dim=D, data_path=str(tmp_path / 'poison_t'), device='cpu')
    j = JIndexer(n_dim=D, data_path=str(tmp_path / 'poison_j'))
    try:
        for ex, mod in ((t, tdoc), (j, jdoc)):
            ex.index(_docs(mod, x[:5]) + [mod.Doc(id='bad', embedding=bad)]
                     + _docs(mod, x[5:10], start=5))
            ex.flush()
        st = t.status()
        assert st['total_docs'] == 10
        assert st['quarantined_docs'] == 1
        assert st['dead_letter'][0]['id'] == 'bad'
        _same_status(st, j.status())
        assert t._index_thread.is_alive()
        # subsequent ingest still works
        for ex, mod in ((t, tdoc), (j, jdoc)):
            ex.index(_docs(mod, x[10:], start=10))
            ex.flush()
        assert t.status()['total_docs'] == 13
        tres = t.search([tdoc.Doc(id='q', embedding=x[0])], parameters={'limit': 10})
        assert tres[0].matches
        _same_results(tres, j.search([jdoc.Doc(id='q', embedding=x[0])],
                                     parameters={'limit': 10}))
    finally:
        t.close()
        j.close()


def test_gateway_partial_failure_isolation(tmp_path):
    """A dead shard fails writes loudly (ShardError names it) but reads
    still serve from the healthy shards; the port's gateway and the JAX one,
    over the same two live port shards, give the same replies."""
    servers = _port_shards(tmp_path, 2, ws='ws')
    try:
        dead = f'http://127.0.0.1:{_free_port()}'  # nothing listens here
        urls = _urls(servers) + [dead]
        t_gw, j_gw = TGateway(urls, timeout=5.0), JGateway(urls, timeout=5.0)
        docs = _json_docs(_x(10), tags=False)
        # scatter writes round-robin land on live shards 0, 1
        t_gw.index(docs[:5])
        t_gw.index(docs[5:])
        for s in servers:
            s.executor.flush()
        st = t_gw.status()
        assert st['total_docs'] == 10
        assert dead in st.get('failed_shards', {})
        j_st = j_gw.status()
        assert st['total_docs'] == j_st['total_docs']
        assert set(st['failed_shards']) == set(j_st['failed_shards'])
        res = t_gw.search([docs[3]], parameters={'limit': 5})
        assert res[0]['matches'][0]['id'] == 'doc3'
        assert res == j_gw.search([docs[3]], parameters={'limit': 5})
        # strict write broadcast raises, naming the dead shard
        with pytest.raises(TShardError) as ei:
            t_gw.delete(['doc3'])
        assert dead in ei.value.failures
        with pytest.raises(JShardError) as ei:
            j_gw.delete(['doc3'])
        assert dead in ei.value.failures
    finally:
        for s in servers:
            s.stop()


def test_gateway_remote_backup_restore_roundtrip(tmp_path):
    """Gateway-coordinated multi-shard backup to a real artifact server
    (port 0), then clear + restore: per-shard doc counts and search results
    survive the round-trip, and equal the JAX executors' over the same
    docs."""
    art = TArtifactServer(tmp_path / 'artifacts', port=0).start()
    servers = []
    j = JIndexer(n_dim=D, data_path=str(tmp_path / 'ref_j'))
    try:
        servers = _port_shards(tmp_path, 3, ws='ws')
        gw = TGateway(_urls(servers))
        x = _x(30)
        docs = _json_docs(x, tags=False)
        for i in range(0, 30, 10):
            gw.index(docs[i: i + 10])
        j.index(_docs(jdoc, x, tags=False))
        for s in servers:
            s.executor.flush()
        j.flush()
        assert gw.status()['total_docs'] == 30
        before = gw.search([docs[17]], parameters={'limit': 10})

        gw.backup('snap1', remote=art.url)
        # each shard uploaded under its suffixed name
        assert sorted(p.name for p in (tmp_path / 'artifacts').iterdir()) == [
            f'snap1_shard_{i}' for i in range(3)]

        gw.clear()
        assert gw.status()['total_docs'] == 0
        # wipe the local backup dirs so restore must pull from the remote
        for si in range(3):
            shutil.rmtree(tmp_path / 'ws' / f'shard_{si}' / 'backups', ignore_errors=True)

        gw.restore('snap1', remote=art.url)
        st = gw.status()
        assert st['total_docs'] == 30
        assert [s['total_docs'] for s in st['shards']] == [10, 10, 10]
        res = gw.search([docs[17]], parameters={'limit': 10})
        assert res[0]['matches'][0]['id'] == 'doc17'
        assert res == before
        _same_results(res, j.search([jdoc.Doc(id='q', embedding=x[17])],
                                    parameters={'limit': 10}))
    finally:
        for s in servers:
            s.stop()
        art.stop()
        j.close()


def test_cli_config_file_merge(tmp_path, monkeypatch):
    """`python -m annlite_torch.serving --config cfg.yml` seeds defaults from
    the YAML params: section and CLI flags override them, as in the JAX CLI;
    a ``device`` key reaches the executor's keywords."""
    cfg = tmp_path / 'config.yml'
    cfg.write_text('executor: AnnLiteIndexer\n'
                   'params:\n'
                   '  n_dim: 64\n'
                   '  metric: euclidean\n'
                   '  port: 9000\n')
    seen = {'torch': {}, 'jax': {}}
    monkeypatch.setattr(tcli, 'serve', lambda **kw: seen['torch'].update(kw))
    monkeypatch.setattr(jcli, 'serve', lambda **kw: seen['jax'].update(kw))
    for name, cli in (('torch', tcli), ('jax', jcli)):
        cli.main(['--config', str(cfg), '--port', '9001'])
    assert seen['torch'] == seen['jax']
    assert seen['torch']['n_dim'] == 64
    assert seen['torch']['metric'] == 'euclidean'
    assert seen['torch']['port'] == 9001          # CLI wins over config
    assert seen['torch']['index_type'] == 'auto'  # untouched default
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit):
            cli.main([])  # n_dim missing everywhere

    cfg.write_text('params:\n  n_dim: 8\n  device: cpu\n')
    seen['torch'].clear()
    tcli.main(['--config', str(cfg)])
    assert seen['torch']['device'] == 'cpu'


def test_cli_config_serves_on_cpu(tmp_path, monkeypatch):
    """A config with ``device: cpu`` builds a working executor: the keys of
    ``params`` reach ``AnnLite`` through the executor's keywords."""
    import annlite_torch.serving.http as thttp

    cfg = tmp_path / 'config.yml'
    cfg.write_text(f'params:\n  n_dim: {D}\n  device: cpu\n  workspace: {tmp_path / "ws"}\n'
                   '  index_type: auto\n  rerank: 0\n')
    made = []

    def run_app(app, host, port):
        made.append((host, port))

    monkeypatch.setattr(thttp.web, 'run_app', run_app)
    orig = thttp.AnnLiteIndexer
    executors = []
    monkeypatch.setattr(thttp, 'AnnLiteIndexer',
                        lambda **kw: executors.append(orig(**kw)) or executors[-1])
    try:
        tcli.main(['--config', str(cfg), '--port', '0'])
        assert made == [('0.0.0.0', 0)]
        ex = executors[0]
        assert ex._index.device.type == 'cpu'
        x = _x(5)
        ex.index(_docs(tdoc, x))
        ex.flush()
        assert ex.status()['total_docs'] == 5
    finally:
        for ex in executors:
            ex.close()


def test_http_update_endpoint_inplace(tmp_path):
    """HTTP /update round-trip: the new embedding + tags serve immediately
    and (flat index, single cell) the row count stays flat, in both
    packages, with the same replies."""
    srv = _ServerPair(tmp_path, 'updsrv', columns=[('i', int)])
    try:
        rng = np.random.default_rng(3)
        docs = _json_docs(_x(20))
        srv.post('/index', {'docs': docs})
        srv.flush()
        tbl = srv.servers[0].executor._index._container.cell_table
        rows_before = tbl.query_all(f'SELECT COUNT(*) FROM {tbl.name}')[0][0]
        moved = {'id': 'doc3', 'embedding': (rng.standard_normal(D) + 9).tolist(),
                 'tags': {'i': 333}}
        srv.post('/update', {'docs': [moved]})
        rows_after = tbl.query_all(f'SELECT COUNT(*) FROM {tbl.name}')[0][0]
        assert rows_after == rows_before  # in place: no dead-row growth
        t, j = srv.post('/search', {'docs': [moved], 'parameters': {'limit': 10}})
        assert t['results'][0]['matches'][0]['id'] == 'doc3'
        _same_results(t['results'], j['results'])
        t, j = srv.post('/filter', {'parameters': {'filter': {'i': {'$eq': 333}}, 'limit': 5}})
        assert {d['id'] for d in t['docs']} == {'doc3'}
        assert t == j
        t, j = srv.post('/fill_embedding', {'docs': [{'id': 'doc3'}]})
        assert t == j
        assert t['docs'][0]['embedding'] == np.asarray(moved['embedding'], np.float32).tolist()
    finally:
        srv.stop()


def test_http_backup_restore_endpoints(tmp_path):
    """/backup to an artifact server and /restore into a fresh executor over
    HTTP: same status and same search replies as before."""
    art = TArtifactServer(tmp_path / 'store', port=0).start()
    servers = []
    try:
        for name in ('a', 'b'):
            ex = TIndexer(n_dim=D, data_path=str(tmp_path / name), device='cpu')
            servers.append(TServer(ex, port=0).start())
        a, b = [f'http://127.0.0.1:{s.port}' for s in servers]
        docs = _json_docs(_x(40), tags=False)
        _post(a, '/index', {'docs': docs})
        r = _post(a, '/backup', {'parameters': {'target_name': 'bk', 'remote': art.url}})
        assert r['status'] == 'ok' and r['path'].endswith('bk_shard_0')
        assert _post(b, '/restore', {'parameters': {'source_name': 'bk',
                                                    'remote': art.url}}) == {'status': 'ok'}
        assert _get(b, '/status')['total_docs'] == 40
        q = {'docs': docs[:3], 'parameters': {'limit': 10}}
        assert _post(b, '/search', q) == _post(a, '/search', q)
        _post(b, '/clear', {})
        assert _get(b, '/status')['total_docs'] == 0
    finally:
        for s in servers:
            s.stop()
        art.stop()


def test_search_during_restore_sees_one_store(tmp_path):
    """Searches on a thread while the executor restores one archive after
    another: each reply is the whole of the old store's or the whole of the
    new store's (ids and scores), never the old index mapped through the
    restored cell table."""
    store = str(tmp_path / 'store')
    old = TIndexer(n_dim=D, data_path=str(tmp_path / 'old'), device='cpu')
    new = TIndexer(n_dim=D, data_path=str(tmp_path / 'new'), device='cpu')
    stop = threading.Event()
    replies, errors = [], []
    try:
        old.index(_docs(tdoc, _x(2000, seed=1), start=5000, tags=False))
        new.index(_docs(tdoc, _x(2000, seed=2), tags=False))
        q = _x(8, seed=3)
        expect = []
        for ex, name in ((old, 'old'), (new, 'new')):
            ex.backup({'target_name': name, 'remote': store})
            res = ex.search(_docs(tdoc, q, start=90000, tags=False), {'limit': 10})
            expect.append([[(m.id, m.score) for m in d.matches] for d in res])

        def searcher():
            try:
                while not stop.is_set():
                    res = old.search(_docs(tdoc, q, start=90000, tags=False), {'limit': 10})
                    replies.append([[(m.id, m.score) for m in d.matches] for d in res])
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=searcher)
        t.start()
        try:
            for name in ('new', 'old') * 4:
                old.restore({'source_name': name, 'remote': store})
        finally:
            stop.set()
            t.join()
        assert not errors
        assert len(replies) > 0
        assert all(r in expect for r in replies)
        res = old.search(_docs(tdoc, q, start=90000, tags=False), {'limit': 10})
        assert [[(m.id, m.score) for m in d.matches] for d in res] == expect[0]
    finally:
        stop.set()
        old.close()
        new.close()


# ----------------------------- the gRPC wire -----------------------------

_EMB = np.arange(D, dtype=np.float32).tobytes()
WIRE_PAYLOADS = {
    'empty': {},
    'index': {'docs': [{'id': 'doc0', 'tags': {'i': 0, 'price': 1.5, 'brand': 'a'},
                        'emb': _EMB, 'emb_shape': [D]}]},
    'search': {'docs': [{'id': 'q', 'tags': {}, 'emb': _EMB, 'emb_shape': [D]}],
               'parameters': {'limit': 10, 'filter': {'$and': [
                   {'price': {'$lt': 50.0}}, {'brand': {'$in': ['a', 'b']}}]},
                   'include_metadata': True}},
    'search_reply': {'results': [{'id': 'q', 'tags': {}, 'matches': [
        {'id': f'doc{i}', 'tags': {'i': i, 'neg': -i - 40, 'big': 2 ** 40 + i},
         'score': 0.125 * i - 3.0} for i in range(20)]}]},
    'delete': {'parameters': {'ids': [f'doc{i}' for i in range(300)],
                              'raise_errors_on_not_found': False}},
    'status_reply': {'total_docs': 70000, 'index_size': 70000, 'n_cells': 1, 'n_dim': D,
                     'metric': 'COSINE', 'is_trained': True, 'params_hash': 'ff7d0e6e436fb0cc',
                     'data_path': '/ws/' + 'x' * 300, 'shard_id': 0, 'buffer_size': 0,
                     'quarantined_docs': 1, 'dead_letter': [
                         {'id': 'bad', 'error': "ValueError('inputs must be a 2D array')"},
                         {'id': None, 'error': 'é' * 40}],
                     'nested': {f'k{i}': [i, -i, None, [float(i)]] for i in range(20)}},
    'filter_reply': {'docs': [{'id': f'doc{i}', 'tags': {'i': i}, 'emb': bytes(range(256)) * 300,
                               'emb_shape': [19200]} for i in range(2)]},
    'backup': {'parameters': {'target_name': 'snap1', 'remote': 'http://127.0.0.1:1'}},
    'backup_reply': {'status': 'ok', 'path': '/ws/shard_0/backups/snap1_shard_0'},
    'ints': {'v': [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
                   -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
             'b': [True, False, None], 'f': [0.0, -0.0, 1e300, -2.5e-300, float('inf')],
             's': ['', 'a' * 31, 'a' * 32, 'a' * 255, 'a' * 256, 'a' * 65536],
             'bin': [b'', b'x' * 255, b'x' * 256, b'x' * 65536]},
}


@pytest.mark.parametrize('name', sorted(WIRE_PAYLOADS))
def test_grpc_wire_equals_msgpack(name):
    """The port's ``packb``/``unpackb`` on every gRPC payload shape: the bytes
    of ``msgpack.packb(use_bin_type=True)``, decoded as ``unpackb(raw=False)``
    decodes them."""
    payload = WIRE_PAYLOADS[name]
    raw = msgpack.packb(payload, use_bin_type=True)
    assert tdoc.packb(payload) == raw
    got, want = tdoc.unpackb(raw), msgpack.unpackb(raw, raw=False)
    assert got == want
    assert repr(got) == repr(want)  # the same types, str as str and bin as bytes
    # a float32 from a foreign packer decodes as msgpack does
    raw32 = msgpack.packb({'s': 0.1}, use_single_float=True)
    assert tdoc.unpackb(raw32) == msgpack.unpackb(raw32, raw=False)


# ----------------------------- the kernel loader -----------------------------


def test_kernel_library_loads_once_across_threads(monkeypatch):
    """Request threads that reach an unbuilt library at once: one builds and
    loads it, the others wait and get the same library."""
    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return {n: Path(f'lib{n}.so') for n in _ext.SIGNATURES}

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, fn):
            f = types.SimpleNamespace()
            object.__setattr__(self, fn, f)
            return f

    monkeypatch.setattr(_ext, '_loaded', {})
    monkeypatch.setattr(_ext, 'build', fake_build)
    monkeypatch.setattr(_ext.ctypes, 'CDLL', FakeLib)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            libs = list(pool.map(lambda _: _ext.library('gather'), range(64)))
    finally:
        sys.setswitchinterval(interval)
    assert len(builds) == 1
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].annlite_gather_rerank.restype is _ext.ctypes.c_int
