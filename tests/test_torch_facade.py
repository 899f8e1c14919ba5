"""annlite_torch's AnnLite facade and Doc against annlite_tpu's on identical
docs (the port on device='cpu', JAX on the CPU)."""
import numpy as np
import pytest

import annlite_torch.doc as tdoc
import annlite_tpu.doc as jdoc
from annlite_torch.index_api import AnnLite as TAnnLite
from annlite_tpu.index_api import AnnLite as JAnnLite
from torch_parity import assert_topk_close

D = 32
N = 600
COLUMNS = [('price', float), ('brand', str)]


def _docs(mod, x, prices, offset=0.0):
    return [mod.Doc(id=f'd{i}', embedding=x[i] + offset,
                    tags={'price': float(prices[i]), 'brand': 'ab'[i % 2]})
            for i in range(len(x))]


def _ragged_close(t, j):
    (td, ti), (jd, ji) = t, j
    assert [len(r) for r in ti] == [len(r) for r in ji]
    for a_d, a_i, b_d, b_i in zip(td, ti, jd, ji):
        if len(a_i):
            # ids compared through their numeric part
            num = lambda ids: np.array([[int(s[1:]) for s in ids]])
            assert_topk_close(a_d[None], num(a_i), b_d[None], num(b_i))


@pytest.fixture(params=['euclidean', 'cosine'])
def pair(request, tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    prices = rng.uniform(0, 100, N)
    t = TAnnLite(D, metric=request.param, columns=COLUMNS,
                 data_path=tmp_path / 't', device='cpu')
    j = JAnnLite(D, metric=request.param, columns=COLUMNS, data_path=tmp_path / 'j')
    t.index(_docs(tdoc, x, prices))
    j.index(_docs(jdoc, x, prices))
    yield t, j, x, prices
    t.close()
    j.close()


def test_search_numpy_equal_jax(pair):
    t, j, x, _ = pair
    q = x[:8] + 0.01
    _ragged_close(t.search_numpy(q, limit=10), j.search_numpy(q, limit=10))
    assert t.search_numpy(x[:16], limit=1)[1] == [[f'd{i}'] for i in range(16)]


def test_filtered_search_equal_jax(pair):
    t, j, x, prices = pair
    flt = {'$and': [{'price': {'$lt': 40.0}}, {'brand': {'$eq': 'a'}}]}
    q = x[:8]
    tr = t.search_numpy(q, filter=flt, limit=10)
    _ragged_close(tr, j.search_numpy(q, filter=flt, limit=10))
    for ids in tr[1]:
        for i in ids:
            k = int(i[1:])
            assert prices[k] < 40.0 and k % 2 == 0
    for matches in t.search_by_vectors(q, filter=flt, limit=5, include_metadata=True):
        assert all(m.tags['price'] < 40.0 for m in matches)


def test_update_delete_equal_jax(pair):
    t, j, x, prices = pair
    rng = np.random.default_rng(1)
    upd = rng.standard_normal((20, D)).astype(np.float32)
    for mod, ann in ((tdoc, t), (jdoc, j)):
        ann.update([mod.Doc(id=f'd{i}', embedding=upd[i - 100],
                            tags={'price': 1.0, 'brand': 'a'})
                    for i in range(100, 120)])
        ann.delete([f'd{i}' for i in range(200, 220)])
    assert t.total_docs == j.total_docs == N - 20
    q = np.concatenate([upd[:5], x[200:205], x[300:303]])
    tr = t.search_numpy(q, limit=10)
    _ragged_close(tr, j.search_numpy(q, limit=10))
    assert [r[0] for r in tr[1][:5]] == [f'd{i}' for i in range(100, 105)]
    gone = {f'd{i}' for i in range(200, 220)}
    assert not gone & {i for r in tr[1] for i in r}
    assert t.get_doc_by_id('d200') is None
    assert t.get_doc_by_id('d100').tags['price'] == 1.0
    assert [d.id for d in t.filter({'price': {'$eq': 1.0}}, limit=100)] == [
        d.id for d in j.filter({'price': {'$eq': 1.0}}, limit=100)]


def test_serving_searcher_equals_search_numpy(pair):
    t, j, x, _ = pair
    t.delete(['d3'])
    j.delete(['d3'])
    q = x[:8]
    d, ids = t.serving_searcher(limit=10)(q)
    sd, sids = t.search_numpy(q, limit=10)
    assert ids == sids
    np.testing.assert_array_equal(d, np.stack(sd))
    _ragged_close((list(d), ids), j.search_numpy(q, limit=10))
    rd, rows = t.device_searcher(limit=10)(q)
    assert t.rows_to_docids(rows) == ids
    # a user mask is fused with the alive bitmap
    user = np.zeros(N, bool)
    user[:50] = True
    _, mids = t.serving_searcher(limit=5, mask=user)(q)
    assert all(int(i[1:]) < 50 and i != 'd3' for r in mids for i in r)


def test_dump_reopen_and_cross_package(tmp_path):
    """A data_path dumped by either package reopens in the other with equal
    results."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, D)).astype(np.float32)
    prices = rng.uniform(0, 100, N)
    q = x[:6] + 0.01
    j = JAnnLite(D, metric='euclidean', columns=COLUMNS, data_path=tmp_path / 'a')
    j.index(_docs(jdoc, x, prices))
    j.delete(['d1'])
    want = j.search_numpy(q, limit=10)
    j.dump()
    j.close()
    t = TAnnLite(D, metric='euclidean', columns=COLUMNS, data_path=tmp_path / 'a',
                 device='cpu')
    assert t.index_size == N - 1
    got = t.search_numpy(q, limit=10)
    _ragged_close(got, want)
    assert t.get_doc_by_id('d5').tags == {'price': float(prices[5]), 'brand': 'b'}
    t.index([tdoc.Doc(id='new', embedding=x[0] + 5.0, tags={'price': 1.0})])
    t.dump()
    again = t.search_numpy(q, limit=10)
    t.close()
    t2 = TAnnLite(D, metric='euclidean', columns=COLUMNS, data_path=tmp_path / 'a',
                  device='cpu')
    back = t2.search_numpy(q, limit=10)
    assert back[1] == again[1]
    for a, b in zip(back[0], again[0]):
        np.testing.assert_array_equal(a, b)
    t2.close()
    j2 = JAnnLite(D, metric='euclidean', columns=COLUMNS, data_path=tmp_path / 'a')
    assert j2.search_numpy(x[:1] + 5.0, limit=1)[1] == [['new']]
    _ragged_close(j2.search_numpy(q, limit=10), again)
    j2.close()


def test_rebuild_from_doc_store_and_compact(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((200, D)).astype(np.float32)
    t = TAnnLite(D, metric='cosine', data_path=tmp_path / 'c', device='cpu')
    t.index(_docs(tdoc, x, np.zeros(200)))
    t.delete([f'd{i}' for i in range(50)])
    t.compact()
    assert t.index_size == 150 == t.stat['index_size']
    assert t.search_numpy(x[60:62], limit=1)[1] == [['d60'], ['d61']]
    t.close()
    # no snapshot: reopening rebuilds the index from the doc store
    t2 = TAnnLite(D, metric='cosine', data_path=tmp_path / 'c', device='cpu')
    assert t2.index_size == 150
    assert t2.search_numpy(x[60:62], limit=1)[1] == [['d60'], ['d61']]
    t2.clear()
    assert t2.total_docs == 0 and len(t2) == 0
    t2.close()


def test_params_hash_equal_jax(tmp_path):
    for metric in ('euclidean', 'cosine', 'inner_product'):
        t = TAnnLite(D, metric=metric, data_path=tmp_path / 't', device='cpu')
        j = JAnnLite(D, metric=metric, data_path=tmp_path / 'j')
        assert t.params_hash == j.params_hash
        t.close()
        j.close()


@pytest.mark.parametrize('kwargs', [
    {'n_components': 16}, {'n_subvectors': 8, 'use_opq': True},
    {'index_type': 'graph'}, {'index_type': 'sharded_pq'},
    {'index_type': 'sharded_flat'},
])
def test_unported_configurations_raise(tmp_path, kwargs):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        TAnnLite(D, data_path=tmp_path, device='cpu', **kwargs)


def test_read_only_and_dim_checks(tmp_path):
    t = TAnnLite(D, data_path=tmp_path, device='cpu', read_only=True)
    with pytest.raises(RuntimeError, match='read-only'):
        t.index([tdoc.Doc(id='a', embedding=np.zeros(D, np.float32))])
    with pytest.raises(ValueError, match='dimension'):
        t.search_numpy(np.zeros((1, D + 1), np.float32))
    t.close()


# ----------------------------- Doc serialization -----------------------------

TAGS = [
    {},
    {'s': 'x', 'long': 'y' * 40, 'longer': 'z' * 300, 'uni': 'héllo ✓'},
    {'i': 0, 'neg': -1, 'n32': -32, 'n33': -33, 'big': 2 ** 40, 'nbig': -2 ** 40,
     'u8': 200, 'u16': 60000, 'i16': -300, 'i32': -70000, 'u64': 2 ** 63 + 5,
     'i64': -2 ** 62},
    {'f': 1.5, 'nf': -0.0, 'inf': float('inf'), 'b': True, 'c': False, 'n': None},
    {'l': [1, 'a', 2.5, None, [True]], 'long_list': list(range(40)),
     'nested': {'k': {'j': [1, 2]}}, 'many': {str(i): i for i in range(20)}},
    {'np_i': np.int64(7), 'np_u': np.uint8(250), 'np_f32': np.float32(0.25),
     'np_f64': np.float64(3.5), 'np_b': np.bool_(True), 'np_arr': np.arange(3),
     'np_str': np.str_('s')},
]


@pytest.mark.parametrize('tags', TAGS, ids=range(len(TAGS)))
@pytest.mark.parametrize('emb', [None, 'f32', 'f16'])
def test_doc_bytes_equal_jax(tags, emb):
    e = None
    if emb is not None:
        e = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4).astype(emb.replace('f', 'float'))
    tb = tdoc.Doc(id='doc-1', embedding=e, tags=tags).to_bytes()
    jb = jdoc.Doc(id='doc-1', embedding=e, tags=tags).to_bytes()
    assert tb == jb
    # round trip across the two packages
    for data in (tb, jb):
        for mod in (tdoc, jdoc):
            back = mod.Doc.from_bytes(data)
            assert back.id == 'doc-1'
            assert back.tags == jdoc.Doc.from_bytes(jb).tags
            if e is None:
                assert back.embedding is None
            else:
                np.testing.assert_array_equal(back.embedding, e)
                assert back.embedding.dtype == e.dtype


def test_doc_rejects_unknown_types():
    with pytest.raises(TypeError):
        tdoc.Doc(id='a', tags={'x': object()}).to_bytes()
    with pytest.raises(ValueError):
        tdoc.unpackb(b'\xc1')
    with pytest.raises(ValueError):
        tdoc.unpackb(tdoc.packb({'a': 1}) + b'\x00')
