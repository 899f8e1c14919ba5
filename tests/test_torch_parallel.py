"""annlite_torch.parallel against annlite_tpu.parallel at equal shard counts:
the JAX functions and classes on a mesh of the suite's first P virtual CPU
devices, the port's on ``make_mesh(P, device='cpu')``, on the same numpy
inputs from a seed.  Each test of `tests/test_parallel.py` has its twin
here, plus a shard with no probed IVF block, ties that straddle two shards
(the lower shard wins, as under ``lax.top_k``) and padding rows (N not a
multiple of P).

Tolerances are those of the port's tests of each path: ADC scores and the
flat scan's exact distances at rtol 1e-5 (`torch_parity.assert_topk_close`,
ids equal where neighbouring distances differ); the graphs and the tie tests
run on small integers, so their distances and ids are equal exactly, but for
the order inside an exact tie of the selective-filter scan, which the JAX
class leaves to ``np.argpartition`` (the port's goes to the lower row)."""
import warnings

import jax
import numpy as np
import pytest
import torch

import annlite_torch.doc as tdoc
import annlite_tpu.doc as jdoc
from annlite_torch import parallel as tp
from annlite_torch.convert import pq_codec_from_jax_state
from annlite_torch.index_api import AnnLite as TAnnLite
from annlite_tpu import parallel as jp
from annlite_tpu.codecs import PQCodec as JPQ
from annlite_tpu.enums import Metric
from annlite_tpu.index_api import AnnLite as JAnnLite
from torch_parity import assert_topk_close


def _meshes(p):
    if jax.device_count() < p:
        pytest.skip(f'needs >= {p} JAX devices (tests/conftest.py sets 8)')
    return jp.make_mesh(p), tp.make_mesh(p, device='cpu')


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _eq(t, j):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), _np(b))


def _eq_but_ties(t, j, q, rows, x, limit=10):
    """The filter scan's result: distances equal to the JAX class's exactly
    and ids wherever the neighbouring distances differ; ids and order equal
    to the brute force over ``rows``, ties to the lower row."""
    np.testing.assert_array_equal(t[0], j[0])
    assert_topk_close(*t, *j, gap=0.0)
    d2 = ((q[:, None, :] - x[rows][None]) ** 2).sum(-1)
    want = np.stack([rows[np.lexsort((rows, r))[:limit]] for r in d2])
    np.testing.assert_array_equal(t[1], want)


def _state_equal(t, j):
    """Two ``state_arrays()``: the same keys, integer arrays equal, float
    arrays within a float32 rounding (the packages normalize cosine rows in
    different orders)."""
    assert sorted(t) == sorted(j)
    for key in t:
        a, b = np.asarray(t[key]), np.asarray(j[key])
        if a.dtype.kind == 'f':
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(a, b)


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)  # the recall guard
        return fn(*a, **kw)


def test_make_mesh_shapes():
    assert tp.make_mesh(device='cpu').size == tp.mesh.CPU_SHARDS == 8
    m = tp.make_mesh(3, device='cpu')
    assert m.size == 3 and all(d.type == 'cpu' for d in m.devices)
    x = np.arange(10 * 2).reshape(10, 2)
    parts = tp.shard_rows(m, x, pad_value=-1)
    assert [t.shape for t in parts] == [(4, 2)] * 3
    np.testing.assert_array_equal(torch.cat(parts).numpy()[10:], -1)
    parts[0][0, 0] = 99  # a placed shard is a copy, not a view of the host array
    assert x[0, 0] == 0
    rep = tp.replicate(m, x)
    assert len(rep) == 3 and rep[0] is rep[2]


# ----------------------------- ADC -----------------------------


def _adc_pair(p, dtable, codes, mask, k):
    jm, tm = _meshes(p)
    ct = jp.shard_codes(jm, codes)
    j = jp.sharded_adc_topk(jm, jp.replicate(jm, dtable), ct,
                            jp.shard_mask(jm, mask, ct.shape[1]), k)
    tct = tp.shard_codes(tm, codes)
    t = tp.sharded_adc_topk(tm, torch.from_numpy(dtable), tct,
                            tp.shard_mask(tm, mask, tct[0].shape[1] * p), k)
    return t, j


@pytest.mark.parametrize('p', [2, 3, 8])
def test_sharded_adc_equal_jax(p):
    """N = 1000: padded to 1002 rows on 3 shards."""
    rng = np.random.default_rng(42)
    q, n, m, k = 4, 1000, 8, 16
    dtable = rng.uniform(0, 10, (q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (m, n)).astype(np.uint8)
    mask = rng.random(n) < 0.5
    (td, ti), (jd, ji) = _adc_pair(p, dtable, codes, mask, 10)
    assert_topk_close(td, ti, jd, ji)
    assert mask[ti.numpy()].all()


@pytest.mark.parametrize('p', [2, 4])
def test_sharded_adc_ties_straddle_shards(p):
    """Integer tables over 3 codewords: every score is exact and most are
    tied; the merge keeps the lower global row, as the single-device stable
    order does, in both packages."""
    rng = np.random.default_rng(7)
    q, n, m = 6, 1000, 4
    dtable = rng.integers(0, 3, (q, m, 3)).astype(np.float32)
    codes = rng.integers(0, 3, (m, n)).astype(np.uint8)
    mask = rng.random(n) < 0.9
    (td, ti), (jd, ji) = _adc_pair(p, dtable, codes, mask, 40)
    scores = sum(dtable[:, j, codes[j]] for j in range(m))
    scores[:, ~mask] = np.float32(3.4e38)
    want = np.argsort(scores, axis=1, kind='stable')[:, :40]
    _eq((ti, td), (want, np.take_along_axis(scores, want, 1)))
    _eq((ti, td), (ji, jd))
    local_n = -(-n // p)
    straddle = [len(set(ti[r].numpy()[td[r].numpy() == v] // local_n)) > 1
                for r in range(q) for v in np.unique(td[r].numpy())]
    assert any(straddle), 'no tie group spans two shards'


@pytest.mark.parametrize('n', [512, 500])
@pytest.mark.parametrize('p', [2, 8])
def test_sharded_lloyd_equal_jax(p, n):
    """One Lloyd step from the same centroids; N = 500 pads zero rows, which
    count as rows in both packages."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    c0 = x[:8].copy()
    jm, tm = _meshes(p)
    jc, ji = jp.sharded_lloyd_step(jm, jp.shard_rows(jm, x), jp.replicate(jm, c0))
    tc, ti = tp.sharded_lloyd_step(tm, tp.shard_rows(tm, x), torch.from_numpy(c0))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    if n == 512:  # unpadded: the single-device step
        from annlite_torch.codecs.kmeans import _lloyd_step

        c1, i1 = _lloyd_step(torch.from_numpy(x), torch.from_numpy(c0))
        np.testing.assert_allclose(tc.numpy(), c1.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(ti), float(i1), rtol=1e-5)


# ----------------------------- flat -----------------------------


@pytest.mark.parametrize('metric', ['euclidean', 'cosine'])
def test_sharded_flat_equal_jax(metric):
    """700 rows on 3 shards (padded to 702): searches, a mask and deletes."""
    rng = np.random.default_rng(42)
    n, d, k = 700, 24, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:5] + rng.standard_normal((5, d)).astype(np.float32) * 0.01
    jm, tm = _meshes(3)
    j = jp.ShardedFlatIndex(d, metric=Metric.from_string(metric), mesh=jm)
    t = tp.ShardedFlatIndex(d, metric=metric, mesh=tm)
    for idx in (j, t):
        idx.add_with_ids(x, np.arange(n))
    td, ti = t.search(q, limit=k)
    assert_topk_close(td, ti, *j.search(q, limit=k))
    mask = rng.random(n) < 0.3
    assert_topk_close(*t.search(q, limit=k, mask=mask), *j.search(q, limit=k, mask=mask))
    for idx in (j, t):
        idx.delete_rows(ti[0][:3])
    td2, ti2 = t.search(q[:1], limit=k)
    assert not set(ti2[0].tolist()) & set(ti[0][:3].tolist())
    assert_topk_close(td2, ti2, *j.search(q[:1], limit=k))
    _state_equal(t.state_arrays(), j.state_arrays())


def test_sharded_flat_matches_flat_index():
    """The port's ShardedFlatIndex agrees with its exact FlatIndex."""
    from annlite_torch.index.flat import FlatIndex

    rng = np.random.default_rng(42)
    n, d, k = 700, 24, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:5] + rng.standard_normal((5, d)).astype(np.float32) * 0.01
    sharded = tp.ShardedFlatIndex(d, metric='euclidean', device='cpu')
    assert sharded.n_shards == 8
    sharded.add_with_ids(x, np.arange(n))
    ref = FlatIndex(d, metric='euclidean', scan_mode='exact', device='cpu')
    ref.add_with_ids(x, np.arange(n))
    assert_topk_close(*sharded.search(q, limit=k), *ref.search(q, limit=k), gap=1e-4)


# ----------------------------- IVF-PQ -----------------------------


@pytest.fixture(scope='module')
def ivf_data():
    rng = np.random.default_rng(42)
    n, d = 3000, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    cells = rng.integers(0, 8, n).astype(np.int32)
    jpq = JPQ(d, n_subvectors=8, n_clusters=64, n_init=1).fit(x, iter=10)
    st = jpq._state()
    return x, cells, jpq, pq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')


def _ivf_pair(ivf_data, p, rerank=0):
    x, cells, jpq, tpq = ivf_data
    jm, tm = _meshes(p)
    j = jp.ShardedIVFPQIndex(x.shape[1], jpq, block_size=128, rerank=rerank, mesh=jm)
    t = tp.ShardedIVFPQIndex(x.shape[1], tpq, block_size=128, rerank=rerank, mesh=tm)
    for idx in (j, t):
        idx.add_with_ids(x, np.arange(len(x)), cells=cells)
    return j, t


@pytest.mark.parametrize('rerank', [0, 32])
@pytest.mark.parametrize('probe', [(1, 3, 5), (0, 1)])
def test_sharded_ivf_equal_jax(ivf_data, probe, rerank):
    """24 blocks on 4 shards; probing cells 0 and 1 leaves shards with no
    probed block (all-(-1) lists) that must return only BIG / -1."""
    x, cells, _, _ = ivf_data
    j, t = _ivf_pair(ivf_data, 4, rerank)
    probe = np.array(probe)
    q = x[:5]
    sel = t._store.select_blocks(probe).astype(np.int64)
    np.testing.assert_array_equal(t._sel_local(sel), j._sel_local(sel))
    if tuple(probe) == (0, 1):
        assert (t._sel_local(sel) < 0).all(axis=1).any()
    td, ti = t.search(q, limit=10, cells=probe)
    assert_topk_close(td, ti, *j.search(q, limit=10, cells=probe))
    assert set(cells[ti.ravel()]) <= set(probe.tolist())
    m = np.zeros(len(x), bool)
    m[: len(x) // 4] = True
    tdf, tif = t.search(q, limit=10, cells=probe, mask=m)
    assert_topk_close(tdf, tif, *j.search(q, limit=10, cells=probe, mask=m))
    assert m[tif[tif >= 0]].all()
    for idx in (j, t):
        idx.delete_rows(ti[0][:3])
    td2, ti2 = t.search(q[:1], limit=10, cells=probe)
    assert not set(ti2[0].tolist()) & set(ti[0][:3].tolist())
    assert_topk_close(td2, ti2, *j.search(q[:1], limit=10, cells=probe))


def test_sharded_ivf_shard_without_blocks_returns_nothing(ivf_data):
    """A search whose probed blocks all sit on one shard: the other shards'
    all-(-1) selections give BIG / -1 and the merge keeps the real rows."""
    x, cells, _, tpq = ivf_data
    t = tp.ShardedIVFPQIndex(16, tpq, block_size=128, n_devices=4, device='cpu')
    t.add_with_ids(x, np.arange(len(x)), cells=cells)
    cb, mb, rm, _ = t._sync_placed()
    sel = np.array([[0], [-1], [-1], [-1]], np.int32)
    dt = tpq.dist_mat(x[:2])
    d, rows = tp.sharded_ivf_topk(t.mesh, tp.shard_rows(t.mesh, sel), dt, cb, mb, rm, 200)
    live = rm[0][0][mb[0][0] > 0].numpy()
    assert sorted(rows[0][: len(live)].tolist()) == sorted(live.tolist())
    assert (rows[:, len(live):] == -1).all() and (d[:, len(live):] >= 3e38).all()


def test_sharded_ivf_cosine_rows_normalized_once(ivf_data):
    """Cosine rows are normalized once: the codes equal a single-device
    ``IVFPQIndex``'s of the same rows, and each rerank row is that index's
    normalized row, bit for bit."""
    from annlite_torch.index.ivf_pq import IVFPQIndex

    x, cells, _, _ = ivf_data
    x = 3.0 * x[:1000]
    jpq = JPQ(16, n_subvectors=8, n_clusters=16, metric=Metric.COSINE, n_init=1).fit(x, iter=5)
    st = jpq._state()
    tpq = pq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')
    t = tp.ShardedIVFPQIndex(16, tpq, block_size=128, rerank=8, n_devices=4, device='cpu')
    one = IVFPQIndex(16, tpq, block_size=128, rerank=8, device='cpu')
    preps = []
    prep = t._prep
    t._prep = lambda rows: preps.append(len(rows)) or prep(rows)
    for idx in (t, one):
        idx.add_with_ids(x, np.arange(1000), cells=cells[:1000])
    assert preps == [1000], 'the rows went through _prep more than once'
    np.testing.assert_array_equal(t._store.codes, one._store.codes)
    live = t._store.mask > 0
    np.testing.assert_array_equal(t._vec_blocks[live],
                                  one._prep(x)[t._store.row_map[live]])


@pytest.mark.parametrize('rerank', [0, 32])
def test_sharded_ivf_soft_assignment(ivf_data, rerank):
    """Rows stored in two cells (soft assignment): the rerank vectors go to
    every copy's slot and each row comes back once, as from the port's
    single-device IVFPQIndex on the same store.  The JAX class raises on
    such an ingest with a rerank and returns repeats without one (ROADMAP
    F3)."""
    from annlite_torch.index.ivf_pq import IVFPQIndex

    x, cells, _, tpq = ivf_data
    two = np.stack([cells, (cells + 1) % 8], axis=1)
    t = tp.ShardedIVFPQIndex(16, tpq, block_size=128, rerank=rerank, n_devices=4,
                             device='cpu')
    one = IVFPQIndex(16, tpq, block_size=128, rerank=rerank, device='cpu')
    for idx in (t, one):
        idx.add_with_ids(x, np.arange(len(x)), cells=two)
    probe = np.array([1, 2, 5])
    td, ti = t.search(x[:6], limit=10, cells=probe)
    assert all(len(set(r)) == len(r) for r in ti.tolist())
    assert_topk_close(td, ti, *one.search(x[:6], limit=10, cells=probe))


def test_sharded_ivf_rerank_snapshot(ivf_data):
    """The rerank path self-matches; the snapshot round-trips in the port and
    crosses to the JAX class and back."""
    x, cells, jpq, tpq = ivf_data
    j, t = _ivf_pair(ivf_data, 4, rerank=32)
    q = x[:8]
    td, ti = t.search(q, limit=5, cells=cells[:8])
    assert sum(ti[i][0] == i for i in range(8)) >= 7
    state = t.state_arrays()
    _state_equal(state, j.state_arrays())
    t2 = tp.ShardedIVFPQIndex(16, tpq, block_size=128, rerank=32, n_devices=4, device='cpu')
    t2.load_state_arrays(state)
    _eq(t2.search(q, limit=5, cells=cells[:8]), (td, ti))
    j2 = jp.ShardedIVFPQIndex(16, jpq, block_size=128, rerank=32, mesh=jp.make_mesh(4))
    j2.load_state_arrays(state)
    assert_topk_close(td, ti, *j2.search(q, limit=5, cells=cells[:8]))


# ----------------------------- graph -----------------------------

GKW = dict(max_degree=12, l_build=32, ef_search=32, beam_width=4, n_entry_samples=64,
           entry_width=4)


def _int_clusters(n, d, seed=0, n_centers=16):
    """Small-integer rows: every distance and table sum exact in float32."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-6, 7, (n_centers, d))
    return (centers[rng.integers(0, n_centers, n)]
            + rng.integers(-2, 3, (n, d))).astype(np.float32)


@pytest.fixture(scope='module')
def int_pq(graph_rows):
    """A PQ codec fitted by the JAX package on the graph rows, its codebooks
    rounded to integers (exact tables), in both packages."""
    jpq = JPQ(16, n_subvectors=8, n_clusters=16, metric=Metric.EUCLIDEAN, n_init=1)
    jpq.fit(graph_rows[0], iter=10)
    jpq._codebooks = np.round(jpq._codebooks).astype(np.float32)
    st = jpq._state()
    return jpq, pq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')


def _graph_pair(x, p, jpq=None, tpq=None, **kw):
    """The JAX sharded graph built on its mesh, its state loaded into the
    port at the same shard count."""
    jm, tm = _meshes(p)
    kw = dict(GKW, **kw)
    j = jp.ShardedGraphIndex(x.shape[1], metric=Metric.EUCLIDEAN, mesh=jm, pq_codec=jpq, **kw)
    j.add_with_ids(x, np.arange(len(x)))
    t = tp.ShardedGraphIndex(x.shape[1], metric='euclidean', mesh=tm, pq_codec=tpq, **kw)
    t.load_state_arrays(j.state_arrays())
    return j, t


@pytest.fixture(scope='module')
def graph_rows():
    x = _int_clusters(2000, 16)
    q = x[:16] + np.random.default_rng(1).integers(-1, 2, (16, 16)).astype(np.float32)
    return x, q


def test_sharded_graph_equal_jax(graph_rows):
    """Vector traversal: equal ids and distances; recall against brute force;
    deletes and a 50% mask, as in the JAX test."""
    x, q = graph_rows
    j, t = _graph_pair(x, 4)
    assert t.check_integrity()['ok'] and t.check_integrity()['n_shards'] == 4
    d, ids = t.search(q, limit=10)
    _eq((d, ids), j.search(q, limit=10))
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1, kind='stable')[:, :10]
    recall = np.mean([len(set(ids[i]) & set(truth[i])) / 10 for i in range(len(q))])
    assert recall >= 0.85
    for idx in (j, t):
        idx.delete_rows(ids[0][:2])
    _, ids2 = t.search(q[:1], limit=10)
    assert not set(ids2[0].tolist()) & set(ids[0][:2].tolist())
    _eq(t.search(q[:1], limit=10), j.search(q[:1], limit=10))
    m = (np.arange(len(x)) % 2) == 0
    df, idf = t.search(q[:4], limit=5, mask=m)
    assert (idf[idf >= 0] % 2 == 0).all()
    _eq((df, idf), j.search(q[:4], limit=5, mask=m))


@pytest.mark.parametrize('rerank', [0, 32])
def test_sharded_graph_pq_traversal_equal_jax(graph_rows, int_pq, rerank):
    """rerank 0 with a codec: each shard beams with the PQ tables over its
    own codes (beam_pq on the card); rerank 32 switches to the vector
    traversal over the bf16 copy and a shard-local exact rerank."""
    x, q = graph_rows
    jpq, tpq = int_pq
    j, t = _graph_pair(x[:1200], 3, jpq, tpq, rerank=rerank, ef_search=64)
    assert t._sync_placed()['use_pq'] == j._sync_placed()['use_pq'] == (rerank == 0)
    _, ids = t.search(x[:10], limit=5)
    _eq((_, ids), j.search(x[:10], limit=5))
    d2 = ((x[:10][:, None, :] - x[None, :1200]) ** 2).sum(-1)
    gt = np.argsort(d2, 1, kind='stable')[:, :5]
    rec = np.mean([len(set(ids[i]) & set(gt[i])) / 5 for i in range(10)])
    assert rec >= (0.5 if rerank == 0 else 0.9)


def test_sharded_graph_snapshot_crosses(graph_rows):
    x, q = graph_rows
    j, t = _graph_pair(x[:600], 8)
    state = t.state_arrays()
    _state_equal(state, j.state_arrays())
    t2 = tp.ShardedGraphIndex(16, metric='euclidean', device='cpu', **GKW)
    t2.load_state_arrays(state)
    assert t2.size == 600
    _eq(t2.search(q[:5], limit=5), t.search(q[:5], limit=5))
    j2 = jp.ShardedGraphIndex(16, metric=Metric.EUCLIDEAN, mesh=jp.make_mesh(8), **GKW)
    j2.load_state_arrays(state)
    _eq(j2.search(q[:5], limit=5), t.search(q[:5], limit=5))
    with pytest.raises(ValueError, match='8 shards, mesh has 3'):
        tp.ShardedGraphIndex(16, metric='euclidean', n_devices=3,
                             device='cpu').load_state_arrays(state)


def test_consolidate_adjacency_keeps_nearest():
    """W -> R consolidation keeps the R nearest neighbours wherever they
    sit, equal to the JAX function on the JAX test's input."""
    from annlite_torch.index.graph import consolidate_adjacency as tcons
    from annlite_tpu.index.graph import consolidate_adjacency as jcons

    v = np.random.default_rng(0).standard_normal((50, 8)).astype(np.float32)
    v[20] = v[0] + 0.01
    v[21] = v[0] + 0.02
    adj = np.full((50, 6), -1, np.int32)
    adj[0] = [10, 11, 12, 13, 20, 21]
    out = tcons(v, adj, r=4)
    assert out.shape == (50, 4) and 20 in out[0] and 21 in out[0]
    np.testing.assert_array_equal(out, jcons(v, adj, r=4))


def test_device_built_shards_load_into_host_mode(graph_rows):
    """A device-built sharded graph (W = R + slack columns) loaded by a
    host-mode index is consolidated to each row's R nearest, shard by shard,
    in both packages: equal adjacency and searches."""
    x, q = graph_rows
    x = x[:900]
    jm, tm = _meshes(3)
    dev = tp.ShardedGraphIndex(16, metric='euclidean', mesh=tm, build_mode='device', **GKW)
    dev.add_with_ids(x, np.arange(len(x)))
    state = dev.state_arrays()
    assert state['adjacency'].shape[2] > GKW['max_degree']
    t = tp.ShardedGraphIndex(16, metric='euclidean', mesh=tm, **GKW)
    j = jp.ShardedGraphIndex(16, metric=Metric.EUCLIDEAN, mesh=jm, **GKW)
    for idx in (t, j):
        idx.load_state_arrays(state)
    for s in range(3):
        np.testing.assert_array_equal(t._shard_adjacency(s), j._shards[s].adjacency())
    _eq(t.search(q, limit=10), j.search(q, limit=10))


def test_sharded_graph_tiny_shards():
    """20 rows over 4 shards leave fewer sampled nodes per shard than
    entry_width: the seeding clamps, in both packages."""
    x = _int_clusters(20, 16, seed=3)
    jm, tm = _meshes(4)
    j = jp.ShardedGraphIndex(16, metric=Metric.EUCLIDEAN, mesh=jm)
    j.add_with_ids(x, np.arange(20))
    t = tp.ShardedGraphIndex(16, metric='euclidean', mesh=tm)
    t.load_state_arrays(j.state_arrays())
    d, ids = t.search(x[:4], limit=3)
    assert ids.shape == (4, 3) and (ids[:, 0] == np.arange(4)).all()
    _eq((d, ids), j.search(x[:4], limit=3))


def test_sharded_graph_builds_alone():
    """The port's own host build: per-shard sub-graphs, self-hits."""
    x = _int_clusters(500, 16, seed=4)
    t = tp.ShardedGraphIndex(16, metric='euclidean', n_devices=3, device='cpu', **GKW)
    t.add_with_ids(x[:300], np.arange(300))
    t.add_with_ids(x[300:], np.arange(300, 500))
    with pytest.raises(ValueError, match='contiguous'):
        t.add_with_ids(x[:2], np.array([7, 8]))
    rep = t.check_integrity()
    assert rep['ok'] and [s['n'] for s in rep['shards']] == [167, 167, 166]
    d, ids = t.search(x[:10], limit=3)
    assert (ids[:, 0] == np.arange(10)).all() and (d[:, 0] == 0).all()


def test_sharded_graph_incremental_encode(graph_rows, int_pq):
    """A sync encodes only the rows appended since the last one."""
    x, _ = graph_rows
    tpq = int_pq[1]
    counted = {'rows': 0}
    orig = tpq.encode

    def counting_encode(arr):
        counted['rows'] += np.atleast_2d(arr).shape[0]
        return orig(arr)

    tpq.encode = counting_encode
    try:
        g = tp.ShardedGraphIndex(16, metric='euclidean', pq_codec=tpq, rerank=32, device='cpu')
        g.add_with_ids(x[:400], np.arange(400))
        g.search(x[:4], limit=5)
        assert counted['rows'] == 400
        g.add_with_ids(x[400:600], np.arange(400, 600))
        g.search(x[:4], limit=5)
        assert counted['rows'] == 600
    finally:
        del tpq.encode


def test_sharded_graph_pq_low_memory_no_vector_copy(graph_rows, int_pq):
    x, _ = graph_rows
    j, t = _graph_pair(x[:600], 8, *int_pq, rerank=0)
    pl = t._sync_placed()
    assert pl['use_pq'] and sum(v.shape[0] for v in pl['vecs']) == t.n_shards
    _eq(t.search(x[:5], limit=5), j.search(x[:5], limit=5))


def test_sharded_graph_selective_filter_fallback(graph_rows):
    """A 5% mask takes the exact scan over the passing rows."""
    x, _ = graph_rows
    x = x[:1000]
    j, t = _graph_pair(x, 8)
    rng = np.random.default_rng(42)
    keep = rng.choice(1000, size=50, replace=False)
    mask = np.zeros(1000, bool)
    mask[keep] = True
    q = x[:6]
    d_out, ids = t.search(q, limit=10, mask=mask)
    assert ids.shape == (6, 10) and mask[ids].all()
    d2 = ((q[:, None, :] - x[keep][None]) ** 2).sum(-1)
    want = keep[np.argsort(d2, axis=1, kind='stable')[:, :10]]
    np.testing.assert_array_equal(np.sort(ids, 1), np.sort(want, 1))
    _eq_but_ties((d_out, ids), j.search(q, limit=10, mask=mask), q, np.sort(keep), x)



@pytest.mark.parametrize('codec', ['none', 'pq_rerank0', 'pq_rerank8'])
def test_sharded_graph_filter_fallback_modes(graph_rows, int_pq, monkeypatch, codec):
    """The selective-filter scan with a deleted row, in each placement: the
    placed float32 rows scanned per shard and merged (never the host copies),
    or with a codec the passing rows' float32 copies; equal to the JAX
    class's host scan and to the brute force over the passing live rows."""
    x, _ = graph_rows
    x = x[:1000]
    kw = {} if codec == 'none' else dict(jpq=int_pq[0], tpq=int_pq[1],
                                          rerank=0 if codec == 'pq_rerank0' else 8)
    j, t = _graph_pair(x, 4, **kw)
    keep = np.random.default_rng(7).choice(1000, size=60, replace=False)
    mask = np.zeros(1000, bool)
    mask[keep] = True
    for ix in (j, t):
        ix.delete_rows(keep[:5])
    if codec == 'none':
        def host_copies(rows):
            raise AssertionError('the fallback read the host copies')
        monkeypatch.setattr(t, '_gather_rows', host_copies)
    q = x[:6] + 1.0
    res = t.search(q, limit=10, mask=mask)
    _eq_but_ties(res, j.search(q, limit=10, mask=mask), q, np.sort(keep[5:]), x)

# ----------------------------- the facade -----------------------------

D, N = 16, 1200
FACADES = {
    'sharded_pq': dict(n_subvectors=8, n_clusters=64),
    'sharded_flat': {},
    'sharded_ivf_pq': dict(n_subvectors=8, n_clusters=64, n_cells=8, n_probe=2, rerank=16),
    'sharded_graph': {},
}


def _facade_rows(seed=42):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, D)).astype(np.float32) * 4
    return (centers[rng.integers(0, 8, N)]
            + 0.2 * rng.standard_normal((N, D))).astype(np.float32)


def _docs(mod, x):
    return [mod.Doc(id=f'd{i}', embedding=x[i], tags={'i': i}) for i in range(len(x))]


def _ragged_close(t, j):
    (td, ti), (jd, ji) = t, j
    assert [len(r) for r in ti] == [len(r) for r in ji]
    for a_d, a_i, b_d, b_i in zip(td, ti, jd, ji):
        if len(a_i):
            num = lambda ids: np.array([[int(s[1:]) for s in ids]])
            assert_topk_close(a_d[None], num(a_i), b_d[None], num(b_i))


@pytest.mark.parametrize('kind', sorted(FACADES))
def test_port_facade_serves_sharded_kind(tmp_path, kind):
    """The port trains (where the kind has codecs), indexes, searches with a
    filter and deletes across its 8 CPU shards, as the JAX facade tests do."""
    x = _facade_rows()
    t = TAnnLite(n_dim=D, metric='euclidean', index_type=kind, columns=[('i', int)],
                 data_path=tmp_path / kind, device='cpu', **FACADES[kind])
    if FACADES[kind].get('n_subvectors'):
        t.train(x)
    idx = t._container.index
    assert type(idx).__module__ == 'annlite_torch.parallel.sharded_index'
    assert idx.n_shards == 8
    _quiet(t.index, _docs(tdoc, x))
    _, ids = t.search_numpy(x[:10], limit=5)
    assert sum(ids[i][0] == f'd{i}' for i in range(10)) >= 8
    r = t.search_by_vectors(x[:2], filter={'i': {'$lt': 100}}, limit=5, include_metadata=True)
    assert r[0] and all(m.tags['i'] < 100 for m in r[0])
    t.delete(['d0'])
    assert 'd0' not in t.search_numpy(x[:1], limit=5)[1][0]
    with pytest.raises(NotImplementedError, match='device-resident'):
        t.device_searcher()
    t.close()


@pytest.mark.parametrize('kind', sorted(FACADES))
def test_data_path_written_by_jax_opens_in_port_and_back(tmp_path, kind):
    """A JAX ``data_path`` holding each sharded kind (8 shards on both sides)
    opens and searches in the port with the JAX results; the port's snapshot
    after a delete and an append reopens in the JAX package."""
    x = _facade_rows()
    q = x[:6] + 0.05
    kw = dict(n_dim=D, metric='euclidean', index_type=kind, columns=[('i', int)],
              data_path=tmp_path / 'a', **FACADES[kind])
    j = JAnnLite(**kw)
    if FACADES[kind].get('n_subvectors'):
        j.train(x)
    _quiet(j.index, _docs(jdoc, x))
    j.delete(['d1', 'd2'])
    want = j.search_numpy(q, limit=10)
    want_f = j.search_numpy(q, filter={'i': {'$lt': 600}}, limit=10)
    j.dump()
    j.close()
    t = TAnnLite(device='cpu', **kw)
    assert type(t._container.index).__name__ == type(j._container.index).__name__
    _ragged_close(t.search_numpy(q, limit=10), want)
    _ragged_close(t.search_numpy(q, filter={'i': {'$lt': 600}}, limit=10), want_f)
    t.delete(['d3'])
    _quiet(t.index, [tdoc.Doc(id='new', embedding=x[0] + 5.0, tags={'i': -1})])
    t.dump()
    again = t.search_numpy(q, limit=10)
    t.close()
    j2 = JAnnLite(**kw)
    _ragged_close(j2.search_numpy(q, limit=10), again)
    assert j2.search_numpy(x[:1] + 5.0, limit=1)[1] == [['new']]
    j2.close()
