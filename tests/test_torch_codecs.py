"""annlite_torch.codecs (k-means, PQ, VQ) against annlite_tpu.codecs on
identical numpy inputs (the port on the CPU, JAX on the CPU).

The two packages draw different random initial centroids (``jax.random``
against a ``torch.Generator``), so k-means is compared from given initial
centroids, and the codecs from one set of codebooks: fitted by the JAX
package, dumped, and loaded by the port (and the reverse)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch.codecs import PQCodec as TPQ
from annlite_torch.codecs import VQCodec as TVQ
from annlite_torch.codecs import kmeans as tkm
from annlite_torch.codecs.pq import DistanceTable as TTable
from annlite_torch.codecs.pq import estimate_adc_self_recall as t_recall
from annlite_torch.convert import pq_codec_from_jax_state, vq_codec_from_jax_state
from annlite_tpu.codecs import PQCodec as JPQ
from annlite_tpu.codecs import VQCodec as JVQ
from annlite_tpu.codecs import kmeans as jkm
from annlite_tpu.codecs.pq import estimate_adc_self_recall as j_recall

D, M, K = 32, 8, 64


def _clustered(n, d=D, n_centers=16, seed=0):
    """Well separated clusters: nearest-centroid choices are far from ties."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, n_centers, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.5).astype(np.float32)


@pytest.fixture(scope='module')
def jax_codecs(tmp_path_factory):
    """One JAX fit per metric, dumped as pq.npz / vq.npz."""
    out = {}
    x = _clustered(2048)
    root = tmp_path_factory.mktemp('codecs')
    for metric in ('euclidean', 'cosine'):
        pq = JPQ(D, n_subvectors=M, n_clusters=K, metric=metric, n_init=1).fit(x, iter=8)
        vq = JVQ(8, metric=metric, iter=10, n_init=1).fit(x)
        pq.dump(root / f'pq_{metric}.npz')
        vq.dump(root / f'vq_{metric}.npz')
        out[metric] = (pq, vq, root / f'pq_{metric}.npz', root / f'vq_{metric}.npz')
    return x, out


# ----------------------------- k-means -----------------------------


@pytest.mark.parametrize('spherical', [False, True])
def test_lloyd_step_equal_jax(spherical):
    x = _clustered(600, d=8)
    if spherical:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    c0 = x[:12].copy()
    jc, ji = jkm._lloyd_step(jnp.asarray(x), jnp.asarray(c0), spherical=spherical)
    tc, ti = tkm._lloyd_step(torch.from_numpy(x), torch.from_numpy(c0), spherical=spherical)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


def test_kmeans_warm_start_equal_jax():
    """Lloyd from given initial codebooks, all subspaces at once."""
    x = np.stack([_clustered(512, d=4, seed=s) for s in range(M)])  # [M, n, d]
    init = x[:, :K].copy()
    want = jkm.kmeans_fit_multi(jax.random.PRNGKey(0), jnp.asarray(x), K, iters=6,
                                init=jnp.asarray(init))
    got = tkm.kmeans_fit_multi(0, torch.from_numpy(x), K, iters=6,
                               init=torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_minibatch_update_equal_jax():
    x = _clustered(700, d=6)
    c0 = x[:10].copy()
    counts = np.arange(10, dtype=np.float32)
    js = jkm.minibatch_update(jkm.KMeansState(jnp.asarray(c0), jnp.asarray(counts)),
                              jnp.asarray(x))
    ts = tkm.minibatch_update(tkm.KMeansState(torch.from_numpy(c0),
                                              torch.from_numpy(counts)),
                              torch.from_numpy(x))
    np.testing.assert_allclose(ts.centroids.numpy(), np.asarray(js.centroids),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))


def test_kmeans_fit_seeded_and_restarts():
    """The port's own draws: reproducible from the seed, distinct rows, and
    the best restart is kept."""
    x = torch.from_numpy(_clustered(800, d=8))
    a, ia = tkm.kmeans_fit(3, x, 16, iters=5, n_init=3)
    b, ib = tkm.kmeans_fit(3, x, 16, iters=5, n_init=3)
    assert torch.equal(a, b) and float(ia) == float(ib)
    singles = [float(tkm._lloyd(x, c0, 5)[1])
               for c0 in (tkm._init_centroids(tkm._generator(3), x, 16),)]
    assert float(ia) <= singles[0] + 1e-3
    st = tkm.minibatch_init(0, x, 16)
    assert len({tuple(r) for r in st.centroids.numpy().tolist()}) == 16
    with pytest.raises(ValueError, match='at least k'):
        tkm.kmeans_fit(0, x[:4], 16)


# ----------------------------- PQ -----------------------------


@pytest.mark.parametrize('metric', ['euclidean', 'cosine'])
def test_pq_npz_written_by_jax_loads(jax_codecs, metric, tmp_path):
    x, codecs = jax_codecs
    jpq, _, pq_path, _ = codecs[metric]
    tpq = TPQ.load(pq_path, device='cpu')
    assert tpq.is_trained and tpq.code_dtype == jpq.code_dtype
    np.testing.assert_array_equal(tpq.codebooks, jpq.codebooks)
    assert hash(tpq) == hash(jpq)  # same class name and parameters
    # and back: the port's dump loads in the JAX package
    tpq.dump(tmp_path / 'pq.npz')
    back = JPQ.load(tmp_path / 'pq.npz')
    np.testing.assert_array_equal(back.codebooks, jpq.codebooks)
    with pytest.raises(ValueError, match='does not hold a VQCodec'):
        TVQ.load(pq_path, device='cpu')


def _near_tie_mismatches(x, tcodes, jcodes, codebooks, d_sub):
    """Indices where the codes differ; asserts each is a near-tie: the two
    codewords' squared distances agree within 1e-5 relative."""
    bad = np.argwhere(tcodes != jcodes)
    for r, m in bad:
        xs = x[r, m * d_sub:(m + 1) * d_sub].astype(np.float64)
        cb = codebooks[m].astype(np.float64)
        dt = np.sum((xs - cb[tcodes[r, m]]) ** 2)
        dj = np.sum((xs - cb[jcodes[r, m]]) ** 2)
        assert abs(dt - dj) <= 1e-5 * max(dt, dj), (r, m, dt, dj)
    return len(bad)


@pytest.mark.parametrize('metric', ['euclidean', 'cosine'])
def test_pq_encode_decode_equal_jax(jax_codecs, metric):
    x, codecs = jax_codecs
    jpq = codecs[metric][0]
    state = jpq._state()
    tpq = pq_codec_from_jax_state(state['params'], state['arrays'], device='cpu')
    xe = _clustered(1500, seed=5)
    tcodes, jcodes = tpq.encode(xe), jpq.encode(xe)
    assert tcodes.dtype == jcodes.dtype == np.uint8
    xn = xe / np.linalg.norm(xe, axis=1, keepdims=True) if metric == 'cosine' else xe
    # at most 0.1% of the codes may differ, each on a near-tie
    assert _near_tie_mismatches(xn, tcodes, jcodes, jpq.codebooks, D // M) <= tcodes.size // 1000
    np.testing.assert_array_equal(tpq.decode(jcodes), jpq.decode(jcodes))


def test_pq_encode_chunks(jax_codecs):
    """Encoding in chunks of rows gives the codes of one pass."""
    x, codecs = jax_codecs
    state = codecs['euclidean'][0]._state()
    tpq = pq_codec_from_jax_state(state['params'], state['arrays'], device='cpu')
    whole = tpq.encode(x)
    tpq.ENCODE_CHUNK = 100
    np.testing.assert_array_equal(tpq.encode(x), whole)


@pytest.mark.parametrize('metric', ['euclidean', 'inner_product', 'cosine'])
def test_get_dist_mat_equal_jax(jax_codecs, metric):
    x, codecs = jax_codecs
    state = codecs['euclidean'][0]._state()
    params = dict(state['params'], metric=int(JPQ(D, M, K, metric=metric).metric))
    jpq = JPQ.__new__(JPQ)
    jpq._restore(params, state['arrays'])
    tpq = pq_codec_from_jax_state(params, state['arrays'], device='cpu')
    q = _clustered(7, seed=9)
    want = jpq.get_dist_mat(q)
    got = tpq.get_dist_mat(q)
    assert got.shape == (7, M, K) and got.dtype == np.float32
    # rtol 1e-6 of the largest term: the inner-product tables are 1/K - dot,
    # which cancels, so their error is relative to the dot products
    scale = np.abs(want - (0.0 if metric == 'euclidean' else 1.0 / K)).max()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)
    ttab, jtab = tpq.precompute_adc(q[0]), jpq.precompute_adc(q[0])
    codes = jpq.encode(x[:50])
    np.testing.assert_allclose(ttab.adist(codes), jtab.adist(codes), rtol=1e-5, atol=1e-5)
    assert isinstance(ttab, TTable)


def test_pq_partial_fit_and_build_codebook():
    x = _clustered(3000)
    pq = TPQ(D, n_subvectors=M, n_clusters=K, device='cpu')
    with pytest.raises(RuntimeError, match='partial_fit'):
        pq.build_codebook()
    for lo in range(0, 3000, 1000):
        pq.partial_fit(x[lo:lo + 1000])
    assert not pq.is_trained
    pq.build_codebook()
    assert pq.is_trained and pq.codebooks.shape == (M, K, D // M)
    # reconstruction error well below the data's spread
    err = np.mean((pq.decode(pq.encode(x)) - x) ** 2)
    assert err < 0.5 * np.var(x)


def test_pq_fit_recall_and_u16(jax_codecs):
    x, codecs = jax_codecs
    jpq = codecs['euclidean'][0]
    state = jpq._state()
    loaded = pq_codec_from_jax_state(state['params'], state['arrays'], device='cpu')
    assert t_recall(loaded, x) == pytest.approx(j_recall(jpq, x), abs=0.02)
    # the port's own fit (other random draws) reaches the JAX fit's recall
    pq = TPQ(D, n_subvectors=M, n_clusters=K, n_init=1, device='cpu').fit(x, iter=8)
    assert t_recall(pq, x) >= 0.8 * j_recall(jpq, x)
    big = TPQ(D, n_subvectors=4, n_clusters=300, n_init=1, device='cpu').fit(
        _clustered(1200), iter=2)
    assert big.code_dtype == np.uint16 and big.encode(x[:10]).dtype == np.uint16
    with pytest.raises(ValueError, match='dividable'):
        TPQ(30, n_subvectors=8, device='cpu')


# ----------------------------- VQ -----------------------------


@pytest.mark.parametrize('metric', ['euclidean', 'cosine'])
def test_vq_equal_jax(jax_codecs, metric, tmp_path):
    x, codecs = jax_codecs
    _, jvq, _, vq_path = codecs[metric]
    tvq = TVQ.load(vq_path, device='cpu')
    np.testing.assert_array_equal(tvq.codebook, jvq.codebook)
    state = jvq._state()
    tvq2 = vq_codec_from_jax_state(state['params'], state['arrays'], device='cpu')
    np.testing.assert_array_equal(tvq2.codebook, jvq.codebook)
    xe = _clustered(1000, seed=7)
    np.testing.assert_array_equal(tvq.encode(xe), np.asarray(jvq.encode(xe)))
    for n_assign, margin in ((2, 0.05), (3, 0.5)):
        np.testing.assert_array_equal(tvq.encode_multi(xe, n_assign, margin),
                                      jvq.encode_multi(xe, n_assign, margin))
    assert tvq.decode(xe) is None
    tvq.dump(tmp_path / 'vq.npz')
    np.testing.assert_array_equal(JVQ.load(tmp_path / 'vq.npz').codebook, jvq.codebook)


def test_vq_spherical_fit_and_minibatch():
    x = _clustered(1500)
    vq = TVQ(8, metric='cosine', iter=10, n_init=2, device='cpu').fit(x)
    np.testing.assert_allclose(np.linalg.norm(vq.codebook, axis=1), 1.0, rtol=1e-5)
    mb = TVQ(8, metric='cosine', device='cpu')
    for lo in range(0, 1500, 500):
        mb.partial_fit(x[lo:lo + 500])
    mb.build_codebook()
    np.testing.assert_allclose(np.linalg.norm(mb.codebook, axis=1), 1.0, rtol=1e-5)
    cells = mb.encode(x)
    assert cells.dtype == np.int32 and cells.min() >= 0 and cells.max() < 8
    with pytest.raises(RuntimeError, match='trained'):
        TVQ(4, device='cpu').encode(x)
