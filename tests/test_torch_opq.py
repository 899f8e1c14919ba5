"""annlite_torch.codecs.ProjectorCodec and OPQCodec against their
annlite_tpu counterparts on identical numpy inputs (the port on the CPU, JAX
on the CPU), and the facade's ``n_components`` and ``use_opq``.

The two packages draw different random initial centroids, so the OPQ codec
is compared from a JAX-trained state (codes bit-equal, tables within 1e-5 of
their scale) and the port's own fit by its properties: a non-increasing
``fit_trace``, an orthogonal rotation, and less reconstruction error than
plain PQ on anisotropic data."""
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_close

from annlite_torch import AnnLite as TAnnLite
from annlite_torch.codecs import OPQCodec as TOPQ
from annlite_torch.codecs import PQCodec as TPQ
from annlite_torch.codecs import ProjectorCodec as TProj
from annlite_torch.codecs.pq import _dist_mat_l2
from annlite_torch.codecs.pq import estimate_adc_self_recall as t_recall
from annlite_torch.convert import (graph_index_from_jax_state, opq_codec_from_jax_state,
                                   projector_codec_from_jax_state)
from annlite_torch.doc import Doc as TDoc
from annlite_tpu import AnnLite as JAnnLite
from annlite_tpu.codecs import OPQCodec as JOPQ
from annlite_tpu.codecs import ProjectorCodec as JProj
from annlite_tpu.codecs.pq import estimate_adc_self_recall as j_recall
from annlite_tpu.doc import Doc as JDoc
from annlite_tpu.enums import Metric
from annlite_tpu.index import graph as jg

D = 32


def _aniso(n, seed=0):
    """Correlated anisotropic rows: a random map of a normal core with
    decaying column scales (distinct principal variances)."""
    rng = np.random.default_rng(seed)
    core = rng.standard_normal((n, D)).astype(np.float32)
    mix = rng.standard_normal((D, D)).astype(np.float32) * np.linspace(2, 0.1, D)[None, :]
    return (core @ mix).astype(np.float32)


def _clustered(n, seed=0, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, 16, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.5).astype(np.float32)


# ----------------------------- projector -----------------------------


@pytest.mark.parametrize('n_components', [8, 32])
def test_projector_equals_jax(n_components):
    x = _aniso(2000)
    t = TProj(D, n_components=n_components, device='cpu').fit(x)
    j = JProj(D, n_components=n_components).fit(x)
    np.testing.assert_allclose(t.components, j.components, atol=1e-4)
    np.testing.assert_allclose(t.explained_variance, j.explained_variance,
                               rtol=1e-4, atol=1e-4 * j.explained_variance.max())
    np.testing.assert_allclose(t.explained_variance_ratio, j.explained_variance_ratio, atol=1e-5)
    np.testing.assert_allclose(t.mean, j.mean, atol=1e-5)
    np.testing.assert_allclose(t.var, j.var, rtol=1e-4)
    scale = np.abs(j.encode(x)).max()
    np.testing.assert_allclose(t.encode(x), j.encode(x), atol=1e-4 * scale)


def test_projector_partial_fit_equals_fit():
    x = _aniso(3000, seed=1)
    whole = TProj(D, n_components=8, device='cpu').fit(x)
    stream = TProj(D, n_components=8, device='cpu')
    for s in range(0, 3000, 700):
        stream.partial_fit(x[s:s + 700])
    assert stream._n == whole._n == 3000
    np.testing.assert_allclose(stream.components, whole.components, atol=1e-4)
    np.testing.assert_allclose(stream.explained_variance, whole.explained_variance, rtol=1e-4)


def test_projector_whiten_roundtrip():
    x = _aniso(1000, seed=2)
    p = TProj(D, n_components=D, whiten=True, device='cpu').fit(x)
    y = p.encode(x)
    # the smallest variances come from a float32 difference of moments: 1%
    np.testing.assert_allclose(y.var(axis=0, ddof=1), 1.0, rtol=1e-2)
    np.testing.assert_allclose(p.decode(y), x, atol=1e-4 * np.abs(x).max())
    torch.testing.assert_close(p.encode_tensor(torch.from_numpy(x)), torch.from_numpy(y))
    with pytest.raises(ValueError):
        TProj(D, n_components=D + 1, device='cpu')


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_projector_npz_cross_load(tmp_path, writer):
    x = _aniso(800, seed=3)
    path = tmp_path / 'projector.npz'
    if writer == 'jax':
        src = JProj(D, n_components=8).fit(x)
        src.dump(path)
        dst = TProj.load(path, device='cpu')
    else:
        src = TProj(D, n_components=8, device='cpu').fit(x)
        src.dump(path)
        dst = JProj.load(path)
    np.testing.assert_array_equal(dst.components, src.components)
    np.testing.assert_allclose(dst.encode(x), src.encode(x), atol=1e-5 * np.abs(x).max())
    st = JProj(D, n_components=8).fit(x)._state()
    conv = projector_codec_from_jax_state(st['params'], st['arrays'], device='cpu')
    np.testing.assert_array_equal(conv.components, st['arrays']['components'])


# ------------------------------- OPQ -------------------------------


@pytest.fixture(scope='module')
def jax_opq():
    x = _clustered(2048)
    return x, JOPQ(D, n_subvectors=8, n_clusters=32, metric='euclidean', n_init=1,
                   opq_iters=3).fit(x, iter=8)


def test_opq_from_jax_state_codes_and_tables(jax_opq):
    x, j = jax_opq
    st = j._state()
    t = opq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')
    assert isinstance(t, TOPQ) and t.opq_iters == 3
    np.testing.assert_array_equal(t.rotation, j.rotation)
    xe = _clustered(1500, seed=5)
    np.testing.assert_array_equal(t.encode(xe), j.encode(xe))
    codes = j.encode(xe[:200])
    np.testing.assert_allclose(t.decode(codes), j.decode(codes), atol=1e-5 * np.abs(xe).max())
    q = _clustered(7, seed=9)
    want = j.get_dist_mat(q)
    np.testing.assert_allclose(t.get_dist_mat(q), want, rtol=0, atol=1e-5 * want.max())


def test_opq_npz_cross_load(jax_opq, tmp_path):
    x, j = jax_opq
    j.dump(tmp_path / 'pq.npz')
    t = TOPQ.load(tmp_path / 'pq.npz', device='cpu')
    np.testing.assert_array_equal(t.encode(x), j.encode(x))
    t.dump(tmp_path / 'back.npz')
    back = JOPQ.load(tmp_path / 'back.npz')
    np.testing.assert_array_equal(back.rotation, j.rotation)
    np.testing.assert_array_equal(back.codebooks, j.codebooks)
    with pytest.raises(ValueError, match='does not hold a PQCodec'):
        TPQ.load(tmp_path / 'pq.npz', device='cpu')


def test_opq_fit_converges_and_beats_pq():
    x = _aniso(600)
    opq = TOPQ(D, n_subvectors=8, n_clusters=16, metric='euclidean', n_init=1,
               opq_iters=6, device='cpu').fit(x, iter=15)
    tr = opq.fit_trace
    assert len(tr) == 6
    assert all(tr[i + 1] <= tr[i] * 1.02 for i in range(5)), tr
    assert tr[-1] < tr[0]
    r = opq.rotation
    np.testing.assert_allclose(r @ r.T, np.eye(D), atol=1e-4)
    pq = TPQ(D, n_subvectors=8, n_clusters=16, metric='euclidean', n_init=1,
             device='cpu').fit(x, iter=15)
    err_pq = np.linalg.norm(pq.decode(pq.encode(x)) - x)
    err_opq = np.linalg.norm(opq.decode(opq.encode(x)) - x)
    assert err_opq < err_pq, (err_opq, err_pq)
    # the tables rotate the queries once: ADC distances equal distances to the
    # decoded rows in the original space
    codes = opq.encode(x[:50])
    dmat = opq.get_dist_mat(x[:3])
    ad = np.stack([dmat[i][np.arange(8)[None, :], codes.astype(int)].sum(1) for i in range(3)])
    want = ((x[:3, None, :] - opq.decode(codes)[None]) ** 2).sum(-1)
    np.testing.assert_allclose(ad, want, rtol=1e-3, atol=1e-3 * want.max())


def test_opq_raw_recall_estimate_rotates_once(jax_opq):
    """The rerank=0 recall guard's estimate equals the raw ADC recall
    computed directly (the JAX package's estimate rotates an OPQ codec's
    rows twice and reads low: ROADMAP section 3)."""
    x, j = jax_opq
    st = j._state()
    t = opq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')
    qi = np.random.default_rng(0).choice(len(x), size=64, replace=False)
    codes = t.encode(x).astype(np.int64)
    dt = t.get_dist_mat(x[qi])
    adc = np.stack([dt[i][np.arange(8)[None, :], codes].sum(1) for i in range(64)])
    exact = ((x[qi][:, None] - x[None]) ** 2).sum(-1)
    gt, got = np.argpartition(exact, 9, 1)[:, :10], np.argpartition(adc, 9, 1)[:, :10]
    want = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gt, got)])
    assert t_recall(t, x) == pytest.approx(want, abs=1e-9)
    assert j_recall(j, x) < want - 0.05  # the reference's fault, left as it is


def test_opq_identity_init_and_errors():
    x = _aniso(400, seed=4)
    opq = TOPQ(D, n_subvectors=4, n_clusters=8, n_init=1, opq_iters=2, opq_init='identity',
               device='cpu').fit(x, iter=5)
    assert len(opq.fit_trace) == 2
    with pytest.raises(ValueError, match='opq_init'):
        TOPQ(D, n_subvectors=4, opq_init='pca', device='cpu')


def test_graph_pq_traversal_rotates_once(jax_opq):
    """The graph's table traversal with an OPQ codec: the table is
    ``_dist_mat_l2(q @ R)`` (the rotation applied once), and the search
    equals the JAX search, whose searcher rotates explicitly."""
    x, j = jax_opq
    st = j._state()
    t = opq_codec_from_jax_state(st['params'], st['arrays'], device='cpu')
    q = _clustered(8, seed=11)
    once = _dist_mat_l2(torch.from_numpy(q @ j.rotation), torch.from_numpy(j.codebooks.copy()))
    torch.testing.assert_close(t.dist_mat(q), once, rtol=1e-5, atol=1e-4)
    twice = _dist_mat_l2(torch.from_numpy(q @ j.rotation @ j.rotation),
                         torch.from_numpy(j.codebooks.copy()))
    assert not torch.allclose(t.dist_mat(q), twice, atol=1e-2)
    kw = dict(max_degree=16, l_build=32, ef_search=32, beam_width=4, traverse='pq')
    jidx = jg.GraphIndex(D, metric=Metric.EUCLIDEAN, pq_codec=j, n_threads=1, **kw)
    jidx.add_with_ids(x, np.arange(len(x)))
    tidx = graph_index_from_jax_state(jidx.state_arrays(), t, metric='euclidean',
                                      device='cpu', n_threads=1, **kw)
    td, ti = tidx.search(q, limit=10)
    jd, ji = jidx.search(q, limit=10)
    assert_topk_close(td, ti, jd, ji)
    sd, si = jidx.device_searcher(limit=10)(q)
    assert_topk_close(td, ti, np.asarray(sd), np.asarray(si))


# ------------------------------ facade ------------------------------


def _docs(mod, x, lo=0):
    return [mod.Doc(id=f'doc{lo + i}', embedding=v) for i, v in enumerate(x)]


class _T:
    Doc = TDoc


class _J:
    Doc = JDoc


def test_facade_opq_roundtrip(tmp_path):
    x = _aniso(800, seed=5)
    kw = dict(n_dim=D, metric='euclidean', n_subvectors=8, use_opq=True, exact_topk=True,
              rerank=50, data_path=tmp_path)
    ann = TAnnLite(device='cpu', **kw)
    ann.train(x)
    assert isinstance(ann._pq_codec, TOPQ) and ann.is_trained
    ann.index(_docs(_T, x))
    _, ids = ann.search_numpy(x[:10], limit=10)
    assert all(ids[i][0] == f'doc{i}' for i in range(10))
    codes = ann.encode(x[:5])
    assert codes.shape == (5, 8) and ann.decode(codes).shape == (5, D)
    ann.dump()
    ann.close()
    b = TAnnLite(device='cpu', **kw)
    assert isinstance(b._pq_codec, TOPQ) and b.is_trained
    np.testing.assert_array_equal(b._pq_codec.rotation, ann._pq_codec.rotation)
    _, ids2 = b.search_numpy(x[:10], limit=10)
    assert ids == ids2
    b.close()


def test_facade_projector_roundtrip(tmp_path):
    """PCA 32 -> 16, then PQ in the projected space (the JAX package's
    test_projector_plus_pq recipe), a flat index over projected rows, and
    the serving path projecting its queries on the device."""
    x = _clustered(1000, seed=6)
    kw = dict(n_dim=D, metric='euclidean', n_components=16, data_path=tmp_path / 'p')
    ann = TAnnLite(n_subvectors=8, exact_topk=True, device='cpu', **kw)
    ann.train(x)
    assert ann.index_dim == 16 and ann._container.index.dim == 16
    ann.index(_docs(_T, x))
    _, ids = ann.search_numpy(x[:10], limit=10)
    exact = np.argsort(((x[:10, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    recall = np.mean([len({f'doc{j}' for j in exact[i]} & set(ids[i])) / 10 for i in range(10)])
    assert recall > 0.3, recall
    rec = ann.decode(ann.encode(x[:4]))
    assert rec.shape == (4, D)
    ann.dump()
    ann.close()
    b = TAnnLite(n_subvectors=8, exact_topk=True, device='cpu', **kw)
    assert b.is_trained and (b.model_path / 'projector.npz').exists()
    assert b.search_numpy(x[:10], limit=10)[1] == ids
    b.close()
    flat = TAnnLite(device='cpu', **dict(kw, data_path=tmp_path / 'f'))
    flat.train(x)
    flat.index(_docs(_T, x))
    d_np, ids_np = flat.search_numpy(x[:8], limit=5)
    d_sv, ids_sv = flat.serving_searcher(limit=5)(x[:8])
    assert ids_sv == ids_np
    np.testing.assert_allclose(d_sv, np.asarray(d_np), rtol=1e-5, atol=1e-5)
    flat.close()


def test_facade_partial_train_projector(tmp_path):
    x = _clustered(1200, seed=7)
    ann = TAnnLite(D, metric='euclidean', n_components=16, n_subvectors=4,
                   data_path=tmp_path, device='cpu')
    for s in range(0, 1200, 400):
        ann.partial_train(x[s:s + 400])
    assert ann._projector_codec.is_trained and not ann.is_trained
    ann.build_codebooks()
    assert ann.is_trained
    ann.index(_docs(_T, x[:300]))
    assert ann.search_numpy(x[:3], limit=3)[1][0][0] == 'doc0'
    ann.close()


def test_jax_data_path_with_projector_opq_and_device_graph_opens(tmp_path):
    """A JAX facade dump with a projector, an OPQ rotation and a device-built
    W-wide graph opens in the port: its codecs load from the npz files, its
    snapshot through convert.py, and searches give the JAX ids wherever
    neighbouring distances differ by more than 1e-5."""
    x = _clustered(1500, seed=8)
    kw = dict(n_dim=D, metric='euclidean', n_components=16, n_subvectors=4, use_opq=True,
              index_type='graph', graph_build_mode='device', rerank=40, max_degree=16,
              data_path=tmp_path)
    j = JAnnLite(**kw)
    j.train(x)
    j.index(_docs(_J, x))
    jd, jids = j.search_numpy(x[:8], limit=10)
    j.dump()
    j.close()
    t = TAnnLite(device='cpu', **kw)
    assert isinstance(t._pq_codec, TOPQ) and t._projector_codec.is_trained
    idx = t._container.index
    assert idx.build_mode == 'device' and idx.size == 1500
    assert idx.state_arrays()['adjacency'].shape[1] == idx._graph.w
    assert idx.check_integrity()['ok']
    td, tids = t.search_numpy(x[:8], limit=10)
    rows = {f'doc{i}': i for i in range(1500)}
    assert_topk_close(np.asarray(td), [[rows[i] for i in r] for r in tids],
                      np.asarray(jd), [[rows[i] for i in r] for r in jids])
    # the port keeps serving and writing the device-built graph
    t.index(_docs(_T, _clustered(50, seed=12), lo=1500))
    assert t.index_size == 1550 and t.check_integrity()['ok']
    t.close()
