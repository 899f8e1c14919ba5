"""annlite_torch's PQ-scan and IVF-PQ indexes and the codec-backed AnnLite
against annlite_tpu's on identical inputs (the port on device='cpu', JAX on
the CPU).  Both packages compute with one set of codebooks: fitted by the
JAX package and carried across by ``convert.py`` or the model directory."""
import warnings

import numpy as np
import pytest

import annlite_torch.doc as tdoc
import annlite_tpu.doc as jdoc
from annlite_torch.convert import (ivf_pq_index_from_jax_state, pq_codec_from_jax_state,
                                   pq_scan_index_from_jax_state)
from annlite_torch.index.ivf_pq import IVFPQIndex as TIVF
from annlite_torch.index.pq_scan import PQScanIndex as TPQScan
from annlite_torch.index_api import AnnLite as TAnnLite
from annlite_tpu.codecs import PQCodec as JPQ
from annlite_tpu.index.ivf_pq import IVFPQIndex as JIVF
from annlite_tpu.index.pq_scan import PQScanIndex as JPQScan
from annlite_tpu.index_api import AnnLite as JAnnLite
from torch_parity import assert_topk_close

D, M, K, N = 32, 8, 64, 3000
COLUMNS = [('price', float)]


def _clustered(n, seed=0, n_centers=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, D)).astype(np.float32) * 3
    labels = rng.integers(0, n_centers, n)
    return (centers[labels] + rng.standard_normal((n, D)).astype(np.float32)).astype(
        np.float32), labels


@pytest.fixture(scope='module')
def data():
    x, labels = _clustered(N)
    q = x[:6] + 0.05
    return x, labels, q


@pytest.fixture(scope='module')
def codecs(data):
    """A JAX PQ fit per metric and the port's codec on the same codebooks."""
    x = data[0]
    out = {}
    for metric in ('euclidean', 'cosine'):
        jpq = JPQ(D, n_subvectors=M, n_clusters=K, metric=metric, n_init=1).fit(x[:2048], iter=8)
        st = jpq._state()
        out[metric] = (jpq, pq_codec_from_jax_state(st['params'], st['arrays'], device='cpu'))
    return out


def _mask(masked, seed=3):
    if not masked:
        return None
    return np.random.default_rng(seed).random(N) < 0.5


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)  # the recall guard
        return fn(*a, **kw)


# ----------------------------- PQ scan -----------------------------


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('rerank', [0, 100])
@pytest.mark.parametrize('metric', ['euclidean', 'cosine'])
def test_pq_scan_from_jax_state_equal(data, codecs, metric, rerank, masked):
    x, _, q = data
    jpq, tpq = codecs[metric]
    j = JPQScan(D, jpq, rerank=rerank)
    _quiet(j.add_with_ids, x, np.arange(N))
    t = pq_scan_index_from_jax_state(j.state_arrays(), tpq, rerank=rerank, device='cpu')
    assert t.size == j.size == N
    mask = _mask(masked)
    td, ti = t.search(q, limit=10, mask=mask)
    jd, ji = j.search(q, limit=10, mask=mask)
    assert_topk_close(td, ti, jd, ji)
    if masked:
        assert mask[ti].all()


@pytest.mark.parametrize('rerank', [0, 100])
def test_pq_scan_state_arrays_byte_equal(data, codecs, rerank):
    """Same codes in: the same transposed codes and bf16-rounded rerank rows
    out, byte for byte."""
    x, _, q = data
    jpq, tpq = codecs['euclidean']
    codes = jpq.encode(x)
    j = JPQScan(D, jpq, rerank=rerank)
    t = TPQScan(D, tpq, rerank=rerank, device='cpu')
    for idx in (j, t):
        _quiet(idx.add_with_ids, x[:2000], np.arange(2000), codes=codes[:2000])
        _quiet(idx.add_with_ids, x[2000:], np.arange(2000, N), codes=codes[2000:])
    js, ts = j.state_arrays(), t.state_arrays()
    assert sorted(js) == sorted(ts)
    for name in js:
        assert ts[name].dtype == js[name].dtype and ts[name].shape == js[name].shape
        assert ts[name].tobytes() == js[name].tobytes(), name
    # the port's own encode gives the same codes on this data
    np.testing.assert_array_equal(tpq.encode(x), codes)
    # update in place, then reset
    for idx in (j, t):
        _quiet(idx.update_with_ids, x[:5] + 1.0, np.arange(5))
    assert_topk_close(*t.search(q, limit=10), *j.search(q, limit=10))
    t.reset()
    assert t.size == 0


def test_pq_scan_recall_guard_warns(codecs):
    """rerank=0 estimates the raw-ADC recall once at ingest and warns below
    the floor."""
    rng = np.random.default_rng(0)
    iso = rng.standard_normal((1024, D)).astype(np.float32)
    t = TPQScan(D, codecs['euclidean'][1], rerank=0, recall_floor=1.01, device='cpu')
    with pytest.warns(RuntimeWarning, match='raw-PQ recall'):
        t.add_with_ids(iso, np.arange(1024))


# ----------------------------- IVF-PQ -----------------------------


def _ivf_pair(x, labels, jpq, tpq, rerank, soft):
    n_cells = 6
    cells = labels % n_cells
    if soft:
        second = np.where(np.arange(N) % 3 == 0, (cells + 1) % n_cells, -1)
        cells = np.stack([cells, second], axis=1)
    j = JIVF(D, jpq, rerank=rerank, block_size=256)
    j.add_with_ids(x[:2000], np.arange(2000), cells=cells[:2000])
    j.add_with_ids(x[2000:], np.arange(2000, N), cells=cells[2000:])
    t = ivf_pq_index_from_jax_state(j.state_arrays(), tpq, rerank=rerank,
                                    block_size=256, device='cpu')
    return j, t


@pytest.mark.parametrize('soft', [False, True])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('rerank', [0, 100])
def test_ivf_pq_from_jax_state_equal(data, codecs, rerank, masked, soft):
    x, labels, q = data
    jpq, tpq = codecs['euclidean']
    j, t = _ivf_pair(x, labels, jpq, tpq, rerank, soft)
    assert t.size == j.size and t.capacity == j.capacity
    mask = _mask(masked)
    for cells in (None, np.array([[0, 2], [3, 3], [1, 5]])):
        td, ti = t.search(q, limit=10, mask=mask, cells=cells)
        jd, ji = j.search(q, limit=10, mask=mask, cells=cells)
        assert_topk_close(td, ti, jd, ji)
    # deletes reach the slot mask of both
    gone = np.arange(0, N, 4)
    for idx in (j, t):
        idx.delete_rows(gone)
    td, ti = t.search(q, limit=10)
    jd, ji = j.search(q, limit=10)
    assert_topk_close(td, ti, jd, ji)
    assert not np.isin(ti[td < 1e30], gone).any()
    # a state restored by either package holds the same arrays
    js, ts = j.state_arrays(), t.state_arrays()
    for name in js:
        assert ts[name].tobytes() == js[name].tobytes(), name


def test_ivf_pq_empty_selection(codecs):
    t = TIVF(D, codecs['euclidean'][1], device='cpu')
    t.add_with_ids(np.zeros((3, D), np.float32), np.arange(3), cells=np.array([1, 1, 2]))
    d, i = t.search(np.zeros((2, D), np.float32), limit=5, cells=np.array([7]))
    assert d.shape == (2, 0) and i.shape == (2, 0)


# ----------------------------- the facade -----------------------------


def _docs(mod, x, lo=0, hi=None):
    hi = len(x) if hi is None else hi
    return [mod.Doc(id=f'd{i}', embedding=x[i], tags={'price': float(i % 100)})
            for i in range(lo, hi)]


def _ragged_close(t, j):
    (td, ti), (jd, ji) = t, j
    assert [len(r) for r in ti] == [len(r) for r in ji]
    for a_d, a_i, b_d, b_i in zip(td, ti, jd, ji):
        if len(a_i):
            num = lambda ids: np.array([[int(s[1:]) for s in ids]])
            assert_topk_close(a_d[None], num(a_i), b_d[None], num(b_i))


FACADES = {
    'pq_scan': dict(n_subvectors=M, n_clusters=K, rerank=50),
    'ivf_pq': dict(n_cells=4, n_subvectors=M, n_clusters=K, n_probe=2, rerank=50),
}


@pytest.mark.parametrize('kind', sorted(FACADES))
def test_data_path_written_by_jax_opens_in_port_and_back(data, tmp_path, kind):
    x, _, q = data
    kw = dict(metric='euclidean', columns=COLUMNS, data_path=tmp_path / 'a', **FACADES[kind])
    j = JAnnLite(D, **kw)
    j.train(x[:1500])
    j.index(_docs(jdoc, x))
    j.delete(['d1', 'd2'])
    want = j.search_numpy(q, limit=10)
    want_f = j.search_numpy(q, filter={'price': {'$lt': 50.0}}, limit=10)
    j.dump()
    j.close()
    t = TAnnLite(D, device='cpu', **kw)
    assert t.is_trained and type(t._container.index).__name__ == type(j._container.index).__name__
    assert t.index_size == N - 2
    _ragged_close(t.search_numpy(q, limit=10), want)
    _ragged_close(t.search_numpy(q, filter={'price': {'$lt': 50.0}}, limit=10), want_f)
    # the reverse: the port writes, the JAX package reopens
    t.index([tdoc.Doc(id='new', embedding=x[0] + 5.0, tags={'price': 1.0})])
    t.update([tdoc.Doc(id='d7', embedding=x[7] + 0.5, tags={'price': 3.0})])
    t.dump()
    again = t.search_numpy(q, limit=10)
    t.close()
    j2 = JAnnLite(D, **kw)
    _ragged_close(j2.search_numpy(q, limit=10), again)
    assert j2.get_doc_by_id('d7').tags['price'] == 3.0
    assert j2.search_numpy(x[:1] + 5.0, limit=1)[1] == [['new']]
    j2.close()


@pytest.mark.parametrize('kind', sorted(FACADES))
def test_port_trains_indexes_and_serves_alone(data, tmp_path, kind):
    x, _, _ = data
    t = TAnnLite(D, metric='euclidean', columns=COLUMNS, data_path=tmp_path / 't',
                 device='cpu', **FACADES[kind])
    assert not t.is_trained and t._container is None
    with pytest.raises(RuntimeError, match='not trained'):
        t.index(_docs(tdoc, x, 0, 10))
    t.train(x[:1500])
    assert type(t._container.index).__name__ == ('IVFPQIndex' if kind == 'ivf_pq'
                                                   else 'PQScanIndex')
    t.index(_docs(tdoc, x))
    _, ids = t.search_numpy(x[:16], limit=1)
    assert [r[0] for r in ids] == [f'd{i}' for i in range(16)]
    flt = {'price': {'$lt': 30.0}}
    for matches in t.search_by_vectors(x[:4], filter=flt, limit=5, include_metadata=True):
        assert matches and all(m.tags['price'] < 30.0 for m in matches)
    t.delete([f'd{i}' for i in range(8)])
    _, ids = t.search_numpy(x[:8], limit=10)
    assert not {f'd{i}' for i in range(8)} & {i for r in ids for i in r}
    t.update([tdoc.Doc(id='d20', embedding=x[20] + 0.3, tags={'price': 1.0})])
    assert t.search_numpy(x[20:21] + 0.3, limit=1)[1] == [['d20']]
    codes = t.encode(x[:5])
    assert codes.shape == (5, M) and t.decode(codes).shape == (5, D)
    with pytest.raises(NotImplementedError, match='device-resident'):
        t.device_searcher()
    assert t.stat['is_trained'] and t.stat['index_size'] == t.index_size
    assert t.total_docs == N - 8
    t.close()


def test_partial_train_and_build_codebooks(data, tmp_path):
    x, _, _ = data
    t = TAnnLite(D, metric='cosine', n_cells=4, n_subvectors=M, n_clusters=K,
                 rerank=50, data_path=tmp_path / 'p', device='cpu')
    for lo in range(0, 1500, 500):
        t.partial_train(x[lo:lo + 500])
    assert not t.is_trained
    t.build_codebooks()
    assert t.is_trained and t._container is not None
    t.index(_docs(tdoc, x, 0, 500))
    assert t.search_numpy(x[:3], limit=1)[1] == [['d0'], ['d1'], ['d2']]
    t.close()
    # docs without a model: reopening trains the codecs from the doc store
    for p in (tmp_path / 'p').glob('parameters-*'):
        for f in p.iterdir():
            f.unlink()
    t2 = TAnnLite(D, metric='cosine', n_cells=4, n_subvectors=M, n_clusters=K,
                  rerank=50, data_path=tmp_path / 'p', device='cpu')
    assert t2.is_trained and t2.index_size == 500
    assert t2.search_numpy(x[:3], limit=1)[1] == [['d0'], ['d1'], ['d2']]
    t2.close()
