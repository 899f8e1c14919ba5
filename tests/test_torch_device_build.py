"""annlite_torch.index.device_build (the device Vamana build) and
``GraphIndex(build_mode='device')`` against their annlite_tpu counterparts,
by stage and as a whole, at the JAX package's test sizes (D = 32, 3,000
clustered rows; the port on the CPU, JAX on the CPU).

- intra-batch pools: ids equal wherever neighbouring distances differ by
  more than 1e-5 relative (both sides rank float32 sums of products of
  bf16-rounded rows, in different orders);
- back-edge stitching: the host adjacency bit-equal from the same adjacency
  and the same prune output, overflow re-prunes included;
- whole builds: invariants (degree, no self-loops, >= 99.9% reachable),
  recall@10 > 0.8 and within 0.03 of the JAX builder's on the same rows,
  incremental adds, ``load``, buffers handed out staying intact, duplicate
  ids in an update;
- ``GraphIndex``: search recall, state round-trips across build modes, and
  a JAX device-built state giving the JAX search's ids wherever
  neighbouring distances differ by more than 1e-5."""
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_close

from annlite_torch import profile
from annlite_torch.convert import graph_index_from_jax_state, pq_codec_from_jax_state
from annlite_torch.index.device_build import DeviceVamanaBuilder as TBuilder
from annlite_torch.index.graph import GraphIndex as TGraph
from annlite_torch.ops.beam import beam_search_vectors
from annlite_tpu.codecs import PQCodec as JPQ
from annlite_tpu.enums import Metric
from annlite_tpu.index.device_build import DeviceVamanaBuilder as JBuilder
from annlite_tpu.index.graph import GraphIndex as JGraph

D = 32
BKW = dict(max_degree=24, l_build=48, batch_size=1024)


def _clustered(seed=42, n=3000):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, D)).astype(np.float32) * 3
    return (centers[rng.integers(0, 8, n)] + rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope='module')
def x():
    return _clustered()


GKW = dict(max_degree=24, l_build=48, ef_search=64, build_batch_size=1024)


@pytest.fixture(scope='module')
def jax_graph(x):
    """One JAX device-mode GraphIndex over the 3,000 rows (its builder has
    the widths of BKW)."""
    j = JGraph(D, metric=Metric.EUCLIDEAN, build_mode='device', **GKW)
    j.add_with_ids(x, np.arange(len(x)))
    return j


@pytest.fixture(scope='module')
def builds(x, jax_graph):
    """One bulk build of the 3,000 rows in each package."""
    t = TBuilder(D, device='cpu', **BKW)
    t.add(x)
    return t, jax_graph._graph


def _bfs(adj, start):
    seen = np.zeros(len(adj), dtype=bool)
    seen[start] = True
    frontier = np.array([start])
    while len(frontier):
        nxt = adj[frontier].reshape(-1)
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen


def _invariants(adj, medoid, n, width):
    assert adj.shape == (n, width)
    valid = adj >= 0
    assert (adj[valid] < n).all()
    assert not (adj == np.arange(n)[:, None]).any()  # no self-loops
    for i in range(n):
        row = adj[i][valid[i]]
        assert len(set(row.tolist())) == len(row)
    assert _bfs(adj, medoid).mean() >= 0.999


def _recall(adj, medoid, x, nq=32):
    q = x[:nq]
    exact = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    entry = torch.full((nq, 1), medoid, dtype=torch.int32)
    _, ids = beam_search_vectors(torch.from_numpy(adj), entry, torch.from_numpy(x),
                                 torch.from_numpy(q), True, k=64, L=64, B=16)
    ids = ids.numpy()[:, :10]
    return np.mean([len(set(exact[i]) & set(ids[i].tolist())) / 10 for i in range(nq)])


# ------------------------------ stages ------------------------------


def _bf16_dists(x, idx, metric_ip):
    """Float64 distances of rows ``idx`` the way the intra stage scores them:
    products of the bf16-rounded rows, squared norms of the float32 rows."""
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    dots = np.einsum('pd,pkd->pk', xb, xb[np.clip(idx, 0, None)])
    if metric_ip:
        return 1.0 - dots
    n2 = (x.astype(np.float64) ** 2).sum(1)
    return n2[:, None] + n2[np.clip(idx, 0, None)] - 2.0 * dots


@pytest.mark.parametrize('metric_ip', [False, True])
def test_intra_pools_equal_jax(x, metric_ip):
    xb = x[:1500] / (np.linalg.norm(x[:1500], axis=1, keepdims=True) if metric_ip else 1.0)
    xb = xb.astype(np.float32)
    t = TBuilder(D, metric_ip=metric_ip, device='cpu', **BKW)._intra_pools(xb, 100)
    j = JBuilder(D, metric_ip=metric_ip, **BKW)._intra_pools(xb, 100)
    assert t.shape == j.shape == (1500, 24) and t.dtype == np.int32
    assert (t >= 100).all() and (t < 1600).all()
    dt, dj = _bf16_dists(xb, t - 100, metric_ip), _bf16_dists(xb, j - 100, metric_ip)
    # each side's list is sorted and equal in distance to 1e-5 relative
    scale = np.abs(dj).max()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5 * scale)
    for r in range(len(t)):
        padded = np.concatenate([[-np.inf], dj[r], [np.inf]])
        for c in range(t.shape[1]):
            if min(padded[c + 1] - padded[c], padded[c + 2] - padded[c + 1]) > 1e-5 * scale:
                assert t[r, c] == j[r, c], (r, c)


def test_intra_pools_small_batch_pads():
    """Fewer rows than neighbours: -1 pads, as the JAX stage gives."""
    xb = _clustered(n=6)
    t = TBuilder(D, device='cpu', **BKW)._intra_pools(xb, 10)
    j = JBuilder(D, **BKW)._intra_pools(xb, 10)
    np.testing.assert_array_equal(t, j)


BACK_KW = dict(BKW, max_degree=12, slack=4, l_build=32)


@pytest.fixture(scope='module')
def back_edge_case(x):
    """An adjacency of 2,000 rows with room for 400 more, and a prune output
    for the 400 (any graph and any output serve: both packages get the same)."""
    base = TBuilder(D, device='cpu', **BACK_KW)
    base.add(x[:2000])
    adj = np.full((2400, base.w), -1, dtype=np.int32)
    adj[:2000] = base.raw_adjacency()
    base.load(x[:2400], adj)
    new_ids = np.arange(2000, 2400, dtype=np.int32)
    out = base._device_prune(new_ids, np.concatenate(
        [base._intra_pools(x[2000:2400], 2000), base._graph_pools(x[2000:2400])], axis=1))
    return adj, new_ids, out


@pytest.mark.parametrize('mode', ['fresh_from', 'check_fresh'])
def test_back_edges_equal_jax(x, back_edge_case, mode):
    """Same adjacency, same prune output -> bit-equal host adjacency.  A
    narrow slack makes rows overflow, so the re-prune path runs."""
    adj, new_ids, out = back_edge_case
    t = TBuilder(D, device='cpu', **BACK_KW)
    j = JBuilder(D, **BACK_KW)
    t.load(x[:2400], adj)
    j.load(x[:2400], adj)
    for b in (t, j):
        b._adj_host[new_ids, : b.r] = out
    deg = (adj[:2000] >= 0).sum(1)
    tgt, cnt = np.unique(out[out >= 0], return_counts=True)
    assert (deg[tgt[tgt < 2000]] + cnt[tgt < 2000] > t.w).any()  # overflow happens
    kwargs = dict(fresh_from=2000) if mode == 'fresh_from' else dict(check_fresh=True)
    touched_t = t._apply_back_edges(new_ids, out, **kwargs)
    touched_j = j._apply_back_edges(new_ids, out, **kwargs)
    np.testing.assert_array_equal(touched_t, touched_j)
    np.testing.assert_array_equal(t._adj_host, j._adj_host)


def test_device_prune_equal_jax(builds):
    """The builder's prune (gather, distances, RobustPrune) on the same pools."""
    t, j = builds
    rows = np.arange(0, 3000, 7, dtype=np.int32)
    pool = np.concatenate([j.raw_adjacency()[rows], j._graph_pools(j.vectors[rows])], axis=1)
    np.testing.assert_array_equal(t._device_prune(rows, pool), j._device_prune(rows, pool))


# ---------------------------- whole builds ----------------------------


def test_build_invariants_and_recall(builds, x):
    t, j = builds
    assert t.size == len(x)
    adj = t.adjacency()
    _invariants(adj, t.medoid, len(x), 24)
    _invariants(t.raw_adjacency(), t.medoid, len(x), t.w)
    rec_t, rec_j = _recall(adj, t.medoid, x), _recall(j.adjacency(), j.medoid, x)
    assert rec_t > 0.8, rec_t
    assert abs(rec_t - rec_j) <= 0.03, (rec_t, rec_j)
    # each stage of each batch is a span of the tracer: two batches of 1,024
    # rows, the first without a graph to search, one repair
    before = profile.snapshot()['spans']
    TBuilder(D, device='cpu', **BKW).add(x[:2048])
    stages = {k[len('annlite.build.'):]: v['count'] - before.get(k, {'count': 0})['count']
              for k, v in profile.snapshot()['spans'].items() if k.startswith('annlite.build.')}
    assert stages == {'upload': 2, 'intra': 2, 'pools': 1, 'prune': 2, 'backedges': 2,
                      'push': 2, 'repair': 1}


def test_incremental_adds_match_bulk_invariants(x):
    b = TBuilder(D, max_degree=16, l_build=32, batch_size=512, device='cpu')
    b.add(x[:1500])
    b.add(x[1500:])
    assert b.size == len(x)
    _invariants(b.adjacency(), b.medoid, len(x), 16)
    _invariants(b.raw_adjacency(), b.medoid, len(x), b.w)


def test_load_roundtrip(x):
    b = TBuilder(D, max_degree=16, l_build=32, batch_size=512, device='cpu')
    b.add(x[:800])
    adj = b.adjacency()
    b2 = TBuilder(D, max_degree=16, l_build=32, batch_size=512, device='cpu')
    b2.load(x[:800], adj)
    assert b2.size == 800 and b2.medoid == b.medoid
    np.testing.assert_array_equal(b2.adjacency(), adj)
    b2.add(x[800:1200])  # a loaded graph takes further inserts
    assert b2.size == 1200
    _invariants(b2.raw_adjacency(), b2.medoid, 1200, b2.w)
    with pytest.raises(ValueError, match='wider'):
        b2.load(x[:10], np.full((10, b2.w + 1), -1, np.int32))


def test_handed_out_buffers_stay_intact(x):
    """Buffers device_arrays() handed out are never written in place: the
    next write to each goes to a clone, later ones in place."""
    b = TBuilder(D, max_degree=16, l_build=32, batch_size=1024, device='cpu')
    b.add(x[:1500])
    assert not b._escaped
    vecs0, adj0 = b.device_arrays()
    assert b._escaped
    v_snap, a_snap = vecs0.clone(), adj0.clone()
    b.add(x[1500:2000])
    assert not b._escaped
    assert torch.equal(vecs0, v_snap) and torch.equal(adj0, a_snap)
    assert b._vecs_dev is not vecs0 and b._adj_dev is not adj0
    vecs_mid = b._vecs_dev
    b.add(x[2000:2100])  # no hand-out since: written in place
    assert b._vecs_dev is vecs_mid
    vecs1, adj1 = b.device_arrays()
    v1, a1 = vecs1.clone(), adj1.clone()
    b.update(np.arange(8, dtype=np.int32), x[2100:2108])
    assert torch.equal(vecs1, v1) and torch.equal(adj1, a1)
    fresh, _ = b.device_arrays()
    np.testing.assert_array_equal(fresh[:8].numpy(), x[2100:2108])
    np.testing.assert_array_equal(b._vecs_pool_dev[:8].float().numpy(),
                                  torch.from_numpy(x[2100:2108]).bfloat16().float().numpy())


def test_update_duplicate_ids_last_wins(x):
    b = TBuilder(D, max_degree=16, l_build=32, batch_size=1024, device='cpu')
    b.add(x[:1000])
    b.update(np.array([3, 7, 3], dtype=np.int32), x[1000:1003])
    np.testing.assert_array_equal(b.vectors[3], x[1002])
    np.testing.assert_array_equal(b.vectors[7], x[1001])
    np.testing.assert_allclose(b._sum, b.vectors.sum(axis=0, dtype=np.float64), rtol=1e-5)
    np.testing.assert_array_equal(b._vecs_dev[3].numpy(), x[1002])
    with pytest.raises(ValueError, match='out of range'):
        b.update(np.array([1000], dtype=np.int32), x[:1])


def test_pools_chunk_scales_with_beam_and_width():
    assert TBuilder(128, device='cpu')._pools_chunk() == 16384
    assert TBuilder(256, device='cpu')._pools_chunk() == 8192
    assert TBuilder(128, beam_width=32, device='cpu')._pools_chunk() == 8192
    assert TBuilder(128, max_degree=64, device='cpu')._pools_chunk() == 8192
    assert TBuilder(4096, device='cpu')._pools_chunk() == 2048


# ---------------------------- GraphIndex ----------------------------

def _exact(q, x):
    return np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]


def test_graph_index_device_mode(x):
    idx = TGraph(D, metric='euclidean', build_mode='device', device='cpu', **GKW)
    idx.add_with_ids(x, np.arange(len(x)))
    assert idx.size == len(x) and idx.check_integrity()['ok']
    q = x[:10]
    d, ids = idx.search(q, limit=10)
    assert (np.diff(d, axis=1) >= -1e-4).all()
    exact = _exact(q, x)
    assert np.mean([len(set(exact[i]) & set(ids[i].tolist())) / 10 for i in range(10)]) > 0.8
    state = idx.state_arrays()
    assert state['adjacency'].shape[1] == idx._graph.w
    # device -> device: the same graph, the same results
    idx2 = TGraph(D, metric='euclidean', build_mode='device', device='cpu', **GKW)
    idx2.load_state_arrays(state)
    np.testing.assert_array_equal(idx2.search(q, limit=10)[1], ids)
    # device -> host: the W-wide graph consolidated to R columns
    host = TGraph(D, metric='euclidean', device='cpu', **GKW)
    host.load_state_arrays(state)
    assert host.state_arrays()['adjacency'].shape[1] == 24 and host.check_integrity()['ok']
    _, hids = host.search(q, limit=10)
    assert np.mean([len(set(exact[i]) & set(hids[i].tolist())) / 10 for i in range(10)]) > 0.8
    # host -> device, then inserts after the load
    dev = TGraph(D, metric='euclidean', build_mode='device', device='cpu', **GKW)
    dev.load_state_arrays(host.state_arrays())
    dev.add_with_ids(x[:100] + 0.01, np.arange(len(x), len(x) + 100))
    assert dev.size == len(x) + 100 and dev.check_integrity()['ok']


def test_graph_index_cosine_partial_batches(rng):
    """Cosine build with pad-heavy tail batches (self and pads masked by
    index, not by a distance value)."""
    centers = np.abs(rng.standard_normal((6, D))).astype(np.float32) * 3 + 1
    x = np.abs(centers[rng.integers(0, 6, 1500)]
               + 0.3 * rng.standard_normal((1500, D))).astype(np.float32)
    idx = TGraph(D, metric='cosine', build_mode='device', device='cpu', **GKW)
    idx.add_with_ids(x, np.arange(1500))
    q = x[:16]
    _, ids = idx.search(q, limit=10)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    exact = np.argsort(1.0 - xn[:16] @ xn.T, axis=1)[:, :10]
    assert np.mean([len(set(exact[i]) & set(ids[i].tolist())) / 10 for i in range(16)]) > 0.8


@pytest.mark.parametrize('with_pq', [False, True])
def test_jax_device_state_searches_equal(x, jax_graph, with_pq):
    """A JAX device-built graph (W-wide) opened through convert.py in
    device mode: the same ids as the JAX search wherever neighbouring
    distances differ by more than 1e-5."""
    jpq = tpq = None
    kw = {}
    if with_pq:
        jpq = JPQ(D, n_subvectors=8, n_clusters=32, metric='euclidean', n_init=1).fit(x, iter=8)
        st = jpq._state()
        tpq = pq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')
        kw = dict(rerank=40)
    state = jax_graph.state_arrays()
    j = JGraph(D, metric=Metric.EUCLIDEAN, build_mode='device', pq_codec=jpq, **GKW, **kw)
    j.load_state_arrays({k: np.array(v) for k, v in state.items()})
    t = graph_index_from_jax_state(state, tpq, metric='euclidean', build_mode='device',
                                   device='cpu', **GKW, **kw)
    np.testing.assert_array_equal(t.state_arrays()['adjacency'], state['adjacency'])
    assert t._graph.medoid == j._graph.medoid
    q = _clustered(seed=9, n=16)
    td, ti = t.search(q, limit=10)
    jd, ji = j.search(q, limit=10)
    assert_topk_close(td, ti, jd, ji)
    assert t.check_integrity() == j.check_integrity()


def test_streaming_append_patches_without_reencode(x):
    """A synced device-mode index with a codec: an append and an update
    patch the serving state (only new rows are encoded), search equals a
    freshly synced index, and a searcher built before the writes returns
    what it returned before."""
    pq = JPQ(D, n_subvectors=8, n_clusters=32, metric='euclidean', n_init=1).fit(x, iter=8)
    st = pq._state()
    tpq = pq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')
    idx = TGraph(D, metric='euclidean', build_mode='device', pq_codec=tpq, rerank=40,
                 device='cpu', **GKW)
    idx.add_with_ids(x[:2000], np.arange(2000))
    q = x[2500:2516]
    run = idx.device_searcher(limit=10)
    before = run(torch.from_numpy(q))
    calls = []
    encode = tpq.encode
    tpq.encode = lambda v: calls.append(len(v)) or encode(v)
    idx.add_with_ids(x[2000:], np.arange(2000, 3000))
    idx.update_with_ids(x[:4] + 0.5, np.array([10, 11, 12, 13]))
    tpq.encode = encode
    assert not idx._dirty and calls == [1000, 4]
    after = run(torch.from_numpy(q))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    s = idx._serving
    np.testing.assert_array_equal(s.codes.numpy(), tpq.encode(idx._vectors))
    got = idx.search(q, limit=10)
    idx._dirty = True
    want = idx.search(q, limit=10)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_int8_traversal_copy_rebuilt_after_update(x, jax_graph):
    """traverse='int8' on a synced device-built index: an in-place update
    rebuilds the int8 traversal copy, so updated rows are found at their new
    place.  The JAX index patches its serving state here and keeps the int8
    copy of the old rows (ROADMAP section 3), checked below as it stands."""
    kw = dict(GKW, traverse='int8')
    t = TGraph(D, metric='euclidean', build_mode='device', device='cpu', **kw)
    j = JGraph(D, metric=Metric.EUCLIDEAN, build_mode='device', **kw)
    state = jax_graph.state_arrays()
    for idx in (t, j):
        idx.load_state_arrays({k: np.array(v) for k, v in state.items()})
        idx.search(x[:4], limit=5)
    old8 = np.asarray(j._int8[0][:100]).copy()
    new = x[:100][::-1] + 3.0
    t.update_with_ids(new, np.arange(100))
    j.update_with_ids(new, np.arange(100))
    _, ids = t.search(new[:10], limit=1)
    assert list(ids[:, 0]) == list(range(10))
    assert t._sync_device().int8[0][:100].numpy().tolist() != old8.tolist()
    np.testing.assert_array_equal(np.asarray(j._int8[0][:100]), old8)  # stale in JAX
