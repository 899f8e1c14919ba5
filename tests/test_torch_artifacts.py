"""annlite_torch's artifacts, utils and profile modules and the facade's
get_docs, backup and restore against annlite_tpu's on identical inputs (every
case of `tests/test_utils_artifacts.py`, and `utils` and `profile` of
`tests/test_misc.py`).  Archives cross between the packages in both
directions, locally and through an artifact server on an ephemeral port; the
port runs with device='cpu', JAX on the CPU."""
import json
import zipfile

import numpy as np
import pytest

import annlite_torch.artifacts as tart
import annlite_torch.doc as tdoc
import annlite_torch.utils as tutils
import annlite_tpu.artifacts as jart
import annlite_tpu.doc as jdoc
import annlite_tpu.utils as jutils
from annlite_torch.index_api import AnnLite as TAnnLite
from annlite_torch.profile import device_trace, time_context, time_profile
from annlite_torch.serving.artifact_server import ArtifactServer as TArtifactServer
from annlite_tpu.index_api import AnnLite as JAnnLite
from annlite_tpu.serving.artifact_server import ArtifactServer as JArtifactServer
from torch_parity import assert_topk_close


# ----------------------------- utils -----------------------------


def test_precision_recall():
    for u in (tutils, jutils):
        assert u.precision(['a', 'b', 'c'], ['a', 'c'], 2) == 0.5
        assert u.recall(['a', 'b', 'c'], ['a', 'c'], 3) == 1.0
        assert u.precision([], ['a'], 5) == 0.0
        assert u.recall(['a'], [], 5) == 0.0
        assert u.precision(['a'], ['a'], 0) == 0.0
        out = u.evaluate([['a', 'b']], [['a']], eval_at=2)
        assert out['precision'] == 0.5 and out['recall'] == 1.0
    rng = np.random.default_rng(0)
    pred = [[str(v) for v in rng.integers(0, 20, 10)] for _ in range(8)]
    rel = [[str(v) for v in rng.integers(0, 20, 5)] for _ in range(8)]
    for at in (None, 1, 5, 10):
        assert tutils.evaluate(pred, rel, at) == jutils.evaluate(pred, rel, at)


def test_recall_at_k():
    pred = np.array([[1, 2, 3], [4, 5, 6]])
    gt = np.array([[1, 9, 3], [6, 5, 4]])
    assert tutils.recall_at_k(pred, gt, 3) == pytest.approx((2 / 3 + 1.0) / 2)
    rng = np.random.default_rng(1)
    pred, gt = rng.integers(0, 50, (16, 10)), rng.integers(0, 50, (16, 10))
    for k in (1, 5, 10):
        assert tutils.recall_at_k(pred, gt, k) == jutils.recall_at_k(pred, gt, k)


def test_docs_with_tags():
    docs = tutils.docs_with_tags(10, 8)
    assert len(docs) == 10
    assert all('price' in d.tags and 'category' in d.tags for d in docs)
    assert docs[0].embedding.shape == (8,)
    assert isinstance(docs[0], tdoc.Doc)
    ref = jutils.docs_with_tags(10, 8)
    for a, b in zip(docs, ref):
        assert a.id == b.id and a.tags == b.tags
        assert a.embedding.tobytes() == b.embedding.tobytes()
        assert a.to_bytes() == b.to_bytes()


# ----------------------------- profile -----------------------------


def test_time_profile_writes_report(tmp_path):
    out = tmp_path / 'f.prof'

    @time_profile(output_file=str(out))
    def work():
        return sum(range(1000))

    assert work() == sum(range(1000))
    assert out.exists()
    assert (tmp_path / 'f.prof.txt').exists()


def test_time_context(capsys):
    with time_context('block'):
        pass
    assert 'block took' in capsys.readouterr().out


def test_device_trace_writes_chrome_trace(tmp_path):
    import torch

    with device_trace(str(tmp_path / 'trace')) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / 'trace' / 'trace.json').read_text())
    assert trace['traceEvents']
    assert any('mm' in e.key for e in prof.key_averages())


# ----------------------------- artifacts -----------------------------


def test_split_merge_roundtrip(tmp_path):
    big = tmp_path / 'big.bin'
    data = np.random.default_rng(0).bytes(1000)
    big.write_bytes(data)
    parts = tart.split_file(big, 300, tmp_path / 'parts')
    assert len(parts) == 4
    jparts = jart.split_file(big, 300, tmp_path / 'jparts')
    assert [p.name for p in parts] == [p.name for p in jparts]
    assert [p.read_bytes() for p in parts] == [p.read_bytes() for p in jparts]
    merged = tart.merge_files(parts, tmp_path / 'merged.bin')
    assert merged.read_bytes() == data


def _backup_dir(tmp_path):
    src = tmp_path / 'backup'
    (src / 'model').mkdir(parents=True)
    (src / 'snapshot').mkdir(parents=True)
    (src / 'model' / 'pq.npz').write_bytes(b'model-bytes' * 100)
    (src / 'snapshot' / 'cells.db').write_bytes(b'cells' * 1000)
    (src / 'docs.db').write_bytes(np.random.default_rng(1).bytes(5000))
    return src


def _layout(transport, name):
    """The store's manifest: each artifact's metadata but its time, its file
    name, and the names and bytes inside its zip."""
    out = []
    for a in transport.list(name):
        meta = {k: v for k, v in a.items() if k not in ('ts', '_path')}
        path = a['_path']
        with zipfile.ZipFile(path) as z:
            inner = [(i.filename, z.read(i)) for i in z.infolist()]
        out.append((path.rsplit('/', 1)[1], meta, inner))
    return out


def test_uploader_merger_roundtrip(tmp_path):
    src = _backup_dir(tmp_path)
    transport = tart.LocalTransport(tmp_path / 'remote')
    up = tart.Uploader(transport, size_limit_mb=1)
    uploaded = up.upload_directory('backup1', src)
    assert len(uploaded) == 3
    assert transport.exists('backup1')
    # skip-if-exists
    assert up.upload_directory('backup1', src) == []

    out = tart.Merger(transport).restore_directory('backup1', tmp_path / 'restored')
    assert (out / 'model' / 'pq.npz').read_bytes() == b'model-bytes' * 100
    assert (out / 'docs.db').read_bytes() == (src / 'docs.db').read_bytes()

    # the JAX package's uploader writes the same layout: metadata, part
    # names, checksums and artifact types
    jt = jart.LocalTransport(tmp_path / 'jremote')
    jart.Uploader(jt, size_limit_mb=1).upload_directory('backup1', src)
    assert _layout(transport, 'backup1') == _layout(jt, 'backup1')


@pytest.mark.parametrize('direction', ['torch_to_jax', 'jax_to_torch'])
def test_uploader_splits_large_files(tmp_path, direction):
    """A 3 MB file in 1 MB parts, uploaded by one package and merged by the
    other."""
    up_mod, merge_mod = (tart, jart) if direction == 'torch_to_jax' else (jart, tart)
    src = tmp_path / 'backup'
    src.mkdir()
    big = np.random.default_rng(2).bytes(3 * 1024 * 1024)
    (src / 'big.bin').write_bytes(big)
    transport = up_mod.LocalTransport(tmp_path / 'remote')
    up_mod.Uploader(transport, size_limit_mb=1).upload_directory('b2', src)
    arts = transport.list('b2')
    assert len(arts) == 3  # 3 parts
    assert [a['part'] for a in arts] == [f'big.bin.part{i:04d}' for i in range(3)]
    out = merge_mod.Merger(merge_mod.LocalTransport(tmp_path / 'remote')).restore_directory(
        'b2', tmp_path / 'restored')
    assert (out / 'big.bin').read_bytes() == big


def test_merger_missing_raises(tmp_path):
    transport = tart.LocalTransport(tmp_path / 'remote')
    with pytest.raises(FileNotFoundError):
        tart.Merger(transport).restore_directory('ghost', tmp_path / 'x')


@pytest.mark.parametrize('server', ['torch', 'jax'])
def test_http_transport_roundtrip(tmp_path, server):
    """HttpTransport against a real artifact server on an ephemeral port
    (the port's, and the JAX package's): upload (with splitting), list,
    exists, download/merge, delete."""
    cls = TArtifactServer if server == 'torch' else JArtifactServer
    srv = cls(tmp_path / 'store', port=0).start()
    try:
        t = tart.make_transport(srv.url)
        assert isinstance(t, tart.HttpTransport)
        assert isinstance(tart.make_transport(tmp_path / 'local'), tart.LocalTransport)
        src = tmp_path / 'backup'
        (src / 'model').mkdir(parents=True)
        (src / 'model' / 'pq.npz').write_bytes(b'model-bytes' * 100)
        big = np.random.default_rng(2).bytes(3_000_000)
        (src / 'docs.db').write_bytes(big)

        assert not t.exists('b1')
        up = tart.Uploader(t, size_limit_mb=1)  # forces docs.db to split
        uploaded = up.upload_directory('b1', src)
        assert len(uploaded) >= 4  # 1 model + 3 split parts
        assert t.exists('b1')
        arts = t.list('b1')
        assert {a['type'] for a in arts} == {'model', 'file'}
        # the JAX transport reads the same listing
        jt = jart.make_transport(srv.url)
        assert [{k: v for k, v in a.items()} for a in jt.list('b1')] == arts

        out = tart.Merger(t).restore_directory('b1', tmp_path / 'restored')
        assert (out / 'docs.db').read_bytes() == big
        assert (out / 'model' / 'pq.npz').read_bytes() == b'model-bytes' * 100
        out = jart.Merger(jt).restore_directory('b1', tmp_path / 'jrestored')
        assert (out / 'docs.db').read_bytes() == big

        t.delete('b1')
        assert not t.exists('b1')
    finally:
        srv.stop()


# ----------------------------- the facade -----------------------------

N, D = 300, 16
COLUMNS = [('price', float)]


def _x(n=N, seed=5):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _index(ann, mod, x):
    ann.index([mod.Doc(id=f'd{i}', embedding=x[i], tags={'price': float(i)})
               for i in range(len(x))])


def _num(ids):
    return np.array([[int(s[1:]) for s in row] for row in ids])


def _same_search(t, j, q, limit=10):
    (td, ti), (jd, ji) = t.search_numpy(q, limit=limit), j.search_numpy(q, limit=limit)
    assert_topk_close(np.asarray(td), _num(ti), np.asarray(jd), _num(ji))
    return ti, ji


def test_unknown_keywords_accepted(tmp_path):
    """F1: the port's facade accepts and ignores keywords it does not know,
    as the JAX facade does; ``device`` is still read, and an unknown keyword
    is never read as the device."""
    from annlite_torch.serving import AnnLiteIndexer

    t = TAnnLite(8, data_path=tmp_path / 't', foo=1, device='cpu')
    j = JAnnLite(8, data_path=tmp_path / 'j', foo=1)
    t2 = TAnnLite(8, data_path=tmp_path / 't2', dev='cuda', cuda=True, device='cpu')
    ex = AnnLiteIndexer(n_dim=8, data_path=str(tmp_path / 'ex'), foo=1, device='cpu')
    try:
        assert t.device.type == t2.device.type == 'cpu'
        assert ex._index.device.type == 'cpu'
        assert t.params_hash == j.params_hash
        x = _x(4, seed=0)[:, :8]
        _index(t, tdoc, x)
        _index(j, jdoc, x)
        assert t.search_numpy(x, limit=1)[1] == [['d0'], ['d1'], ['d2'], ['d3']]
    finally:
        for ann in (t, j, t2, ex):
            ann.close()


def test_facade_backup_restore_over_http(tmp_path):
    """AnnLite.backup -> HTTP artifact server -> AnnLite.restore on a fresh
    data_path: doc-count parity and identical top-10 results, in the port,
    equal to the JAX facade's on the same docs."""
    x = _x()
    srv = TArtifactServer(tmp_path / 'store', port=0).start()
    try:
        a = TAnnLite(n_dim=D, metric='euclidean', index_type='flat', columns=COLUMNS,
                     data_path=str(tmp_path / 'src'), device='cpu')
        _index(a, tdoc, x)
        d_a, ids_a = a.search_numpy(x[:8], limit=10)
        a.backup(target_name='http-bk', remote=srv.url)
        a.close()

        b = TAnnLite(n_dim=D, metric='euclidean', index_type='flat', columns=COLUMNS,
                     data_path=str(tmp_path / 'dst'), device='cpu')
        b.restore(source_name='http-bk', remote=srv.url)
        assert b.total_docs == N
        d_b, ids_b = b.search_numpy(x[:8], limit=10)
        assert ids_b == ids_a
        np.testing.assert_allclose(np.asarray(d_b), np.asarray(d_a), rtol=1e-5)
        j = JAnnLite(n_dim=D, metric='euclidean', index_type='flat', columns=COLUMNS,
                     data_path=str(tmp_path / 'jax'))
        _index(j, jdoc, x)
        ti, ji = _same_search(b, j, x[:8])
        assert ti == [list(r) for r in ji]
        assert [d.id for d in b.get_docs(filter={'price': {'$lt': 3.0}})] == ['d0', 'd1', 'd2']
        b.close()
        j.close()
    finally:
        srv.stop()


def test_get_docs_equal_jax(tmp_path):
    x = _x()
    t = TAnnLite(D, columns=COLUMNS, data_path=tmp_path / 't', device='cpu')
    j = JAnnLite(D, columns=COLUMNS, data_path=tmp_path / 'j')
    try:
        _index(t, tdoc, x)
        _index(j, jdoc, x)
        for kw in ({}, {'filter': {'price': {'$gte': 290.0}}, 'limit': 20},
                   {'limit': 5, 'offset': 7, 'order_by': 'price', 'ascending': False}):
            td, jd = t.get_docs(**kw), j.get_docs(**kw)
            assert [d.id for d in td] == [d.id for d in jd]
            assert [d.tags for d in td] == [d.tags for d in jd]
    finally:
        t.close()
        j.close()


# the flat index (int8 scan) and the PQ scan, as the packages' defaults pick
# them; the PQ facade reranks 50 ADC candidates in float32
CONFIGS = {
    'flat_int8': dict(metric='euclidean'),
    'pq_scan': dict(metric='euclidean', n_subvectors=4, n_clusters=32, rerank=50),
}


@pytest.mark.parametrize('transport', ['local', 'http'])
@pytest.mark.parametrize('kind', sorted(CONFIGS))
@pytest.mark.parametrize('direction', ['jax_to_torch', 'torch_to_jax'])
def test_archive_crosses_packages(tmp_path, direction, kind, transport):
    """An archive written by one package's ``AnnLite.backup`` restores into
    the other's facade on a fresh data_path: the same docs, the same top-10
    ids, distances at rtol 1e-5."""
    cfg = CONFIGS[kind]
    make_t = lambda p: TAnnLite(D, data_path=p, device='cpu', **cfg)
    make_j = lambda p: JAnnLite(D, data_path=p, **cfg)
    (make_w, wdoc), (make_r, _) = (((make_j, jdoc), (make_t, tdoc))
                                   if direction == 'jax_to_torch'
                                   else ((make_t, tdoc), (make_j, jdoc)))
    x = _x()
    q = x[:8] + 0.01
    srv = TArtifactServer(tmp_path / 'store', port=0).start() if transport == 'http' else None
    remote = srv.url if srv else str(tmp_path / 'remote')
    try:
        w = make_w(tmp_path / 'src')
        if 'n_subvectors' in cfg:
            w.train(x)
        _index(w, wdoc, x)
        w.backup(target_name='bk', remote=remote)
        r = make_r(tmp_path / 'dst')
        assert r.total_docs == 0
        r.restore(source_name='bk', remote=remote)
        assert r.total_docs == w.total_docs == N
        assert r.is_trained
        ri, _ = _same_search(r, w, q)
        assert [row[0] for row in ri] == [f'd{i}' for i in range(8)]
        assert r.get_doc_by_id('d5').embedding.tobytes() == x[5].tobytes()
        w.close()
        r.close()
    finally:
        if srv:
            srv.stop()


def test_searcher_taken_before_restore_refuses(tmp_path):
    """A ``serving_searcher`` (or ``device_searcher``) taken before
    ``restore`` would hold the old index's rows while the doc ids come from
    the restored table; it raises instead, and a new one serves the restored
    rows."""
    x, y = _x(), _x(seed=9)
    remote = str(tmp_path / 'remote')
    a = TAnnLite(D, metric='euclidean', data_path=tmp_path / 'a', device='cpu')
    b = TAnnLite(D, metric='euclidean', data_path=tmp_path / 'b', device='cpu')
    try:
        _index(a, tdoc, x)
        a.backup(target_name='bk', remote=remote)
        _index(b, tdoc, y)
        serve, run = b.serving_searcher(limit=10), b.device_searcher(limit=10)
        assert [ids[0] for ids in serve(y[:4])[1]] == ['d0', 'd1', 'd2', 'd3']
        b.restore(source_name='bk', remote=remote)
        with pytest.raises(RuntimeError, match='replaced'):
            serve(x[:4])
        with pytest.raises(RuntimeError, match='replaced'):
            run(x[:4])
        d, ids = b.serving_searcher(limit=10)(x[:8])
        d_a, ids_a = a.search_numpy(x[:8], limit=10)
        assert ids == ids_a
        np.testing.assert_allclose(d, np.asarray(d_a), rtol=1e-5)
    finally:
        a.close()
        b.close()
