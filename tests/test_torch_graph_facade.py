"""AnnLite(index_type='graph') in annlite_torch (device='cpu') against the JAX
package's: CRUD, filters, check_integrity, auto-compaction, the serving
searchers, and a data_path written by either package opened by the other.

Rows and queries are small integers, so distances are exact in float32 and
the two packages' searches over one snapshot return the same doc ids."""
import warnings

import numpy as np
import pytest

import annlite_torch.doc as tdoc
import annlite_tpu.doc as jdoc
from annlite_torch.index.graph import GraphIndex as TGraph
from annlite_torch.index_api import AnnLite as TAnnLite
from annlite_tpu.index_api import AnnLite as JAnnLite

D, N = 32, 1200
COLUMNS = [('i', int)]


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(0)
    centers = rng.integers(-8, 9, (12, D))
    x = (centers[rng.integers(0, 12, N)] + rng.integers(-2, 3, (N, D))).astype(np.float32)
    return x


def _docs(mod, x, lo, hi):
    return [mod.Doc(id=f'd{i}', embedding=x[i], tags={'i': i}) for i in range(lo, hi)]


def _port(path, **kw):
    return TAnnLite(D, metric='euclidean', index_type='graph', columns=COLUMNS,
                    data_path=path, device='cpu', **kw)


def _jax(path, **kw):
    return JAnnLite(D, metric='euclidean', index_type='graph', columns=COLUMNS,
                    data_path=path, **kw)


def _fill(ann, mod, x, pq):
    if pq:
        ann.train(x[:1000])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)  # the raw-PQ recall guard
        ann.index(_docs(mod, x, 0, N))


# without a codec; with a PQ codec at rerank 0 (table traversal, K8's path)
CONFIGS = [{}, {'n_subvectors': 8, 'rerank': 0}]


@pytest.mark.parametrize('kw', CONFIGS, ids=['vectors', 'pq_rerank0'])
def test_crud_filters_and_integrity(tmp_path, data, kw):
    x = data
    ann = _port(tmp_path / 'a', **kw)
    _fill(ann, tdoc, x, bool(kw))
    assert ann.index_size == N
    _, ids = ann.search_numpy(x[:8], limit=10)
    if kw:  # raw PQ scores: each doc among its own top 10
        assert sum(f'd{i}' in ids[i] for i in range(8)) >= 7
    else:
        assert [r[0] for r in ids] == [f'd{i}' for i in range(8)]
    for matches in ann.search_by_vectors(x[:4], filter={'i': {'$lt': 300}}, limit=5,
                                         include_metadata=True):
        assert matches and all(m.tags['i'] < 300 for m in matches)
    # in-place update: the row stays, the doc moves
    moved = (x[600:604] + 0.5).astype(np.float32)
    ann.update([tdoc.Doc(id=f'd{i}', embedding=moved[j], tags={'i': i})
                for j, i in enumerate(range(4))])
    assert ann._container.index.size == N
    _, ids = ann.search_numpy(moved, limit=3)
    if not kw:
        assert [r[0] for r in ids] == ['d0', 'd1', 'd2', 'd3']
    gone = [f'd{i}' for i in range(100, 140)]
    ann.delete(gone)
    _, ids = ann.search_numpy(x[100:140], limit=10)
    assert not set(gone) & {i for row in ids for i in row}
    rep = ann.check_integrity()
    assert rep['ok'] and rep['n'] == N and abs(rep['dead_fraction'] - 40 / N) < 1e-9
    # the serving path: the graph takes no mask and tracks its deletes
    serve = ann.serving_searcher(limit=10)
    _, sids = serve(x[:32])
    assert sids == ann.search_numpy(x[:32], limit=10)[1]
    _, sids = serve(x[100:140])
    assert not set(gone) & {i for row in sids for i in row}
    with pytest.raises(ValueError, match='no mask'):
        ann.device_searcher(limit=5, mask=np.ones(N, bool))
    ann.close()


def test_auto_compact(tmp_path, data):
    x = data[:400]
    ann = TAnnLite(D, metric='euclidean', index_type='graph', device='cpu',
                   auto_compact_dead_fraction=0.25, data_path=tmp_path / 'ac')
    ann.index([tdoc.Doc(id=f'd{i}', embedding=x[i]) for i in range(400)])
    ann.delete([f'd{i}' for i in range(0, 60)])  # 15% dead: kept
    assert ann._container.index.n_deleted == 60
    ann.delete([f'd{i}' for i in range(60, 120)])  # 30% dead: compacted
    idx = ann._container.index
    assert idx.n_deleted == 0 and idx.size == 280
    _, ids = ann.search_numpy(x[150:152], limit=5)
    assert [r[0] for r in ids] == ['d150', 'd151']
    ann.close()


def test_knobs_reach_the_index(tmp_path):
    ann = TAnnLite(D, metric='euclidean', index_type='graph', device='cpu', max_degree=20,
                   ef_construction=40, ef_search=50, data_path=tmp_path / 'k')
    idx = ann._container.index
    assert isinstance(idx, TGraph)
    assert (idx.max_degree, idx.l_build, idx.ef_search, idx.build_mode) == (20, 40, 50, 'host')
    ann.close()
    ann = TAnnLite(D, index_type='graph', graph_build_mode='device', device='cpu',
                   data_path=tmp_path / 'd')
    assert ann._container.index.build_mode == 'device'
    ann.close()
    # the sharded graph takes the same knobs (one sub-graph per CPU shard)
    ann = TAnnLite(D, metric='euclidean', index_type='sharded_graph', device='cpu',
                   max_degree=20, ef_construction=40, ef_search=50,
                   graph_build_mode='device', data_path=tmp_path / 's')
    idx = ann._container.index
    assert type(idx).__name__ == 'ShardedGraphIndex'
    assert (idx.max_degree, idx.l_build, idx.ef_search, idx.build_mode, idx.n_shards) == (
        20, 40, 50, 'device', 8)
    ann.close()


@pytest.mark.parametrize('kw', CONFIGS, ids=['vectors', 'pq_rerank0'])
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_data_path_opens_in_the_other_package(tmp_path, data, kw, writer):
    """A snapshot (and codec file) written by one package restores in the
    other, with equal search results over the same graph."""
    x = data
    path = tmp_path / 'shared'
    make, mod = (_jax, jdoc) if writer == 'jax' else (_port, tdoc)
    src = make(path, **kw)
    _fill(src, mod, x, bool(kw))
    src.delete(['d5', 'd6'])
    d_src, ids_src = src.search_numpy(x[:16], limit=10)
    src.dump()
    src.close()
    other = _port(path, **kw) if writer == 'jax' else _jax(path, **kw)
    assert other.index_size == N - 2 and other._container.index.size == N
    assert other.check_integrity()['ok']
    d_o, ids_o = other.search_numpy(x[:16], limit=10)
    assert ids_o == ids_src
    for a, b in zip(d_o, d_src):
        if kw:  # fitted codebooks: the tables sum floats in another order
            np.testing.assert_allclose(a, b, rtol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)
    other.close()
