"""The int4 and bf16 scans of annlite_torch (quantizers, fused-scan
candidates, scan_topk, FlatIndex snapshots, AnnLite(scan_mode=...)) against
annlite_tpu on identical numpy inputs.  The JAX functions run on the CPU
through their plain references (``use_pallas=False``), as the JAX package's
own tests run them; the port's run through the kernels' plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annlite_torch.doc as tdoc
import annlite_tpu.doc as jdoc
from annlite_torch.convert import flat_index_from_jax_state
from annlite_torch.index.flat import FlatIndex as TFlat
from annlite_torch.index_api import AnnLite as TAnnLite
from annlite_torch import profile
from annlite_torch.ops import fused_scan as tfs
from annlite_torch.ops import scan as tsc
from annlite_tpu.enums import Metric
from annlite_tpu.index.flat import FlatIndex as JFlat
from annlite_tpu.index_api import AnnLite as JAnnLite
from annlite_tpu.ops import fused_scan as jfs
from annlite_tpu.ops import scan as jsc
from torch_parity import assert_topk_close

BIG = 3.4e38
D = 256  # the JAX int4 tests' width: the packed store holds 128 bytes a row
# N = 16384 exercises the block2 select, 32768 the lane8 select
N_BY_SELECT = {'block2': 16384, 'lane8': 32768}


def _duplicate(x):
    # rows 128..255 share block 0's buckets with rows 0..127; rows 8192..
    # share lane classes with rows 0.. across blocks (the tie rules)
    x[128:256] = x[0:128]
    x[8192:8192 + 2048] = x[0:2048]
    return x


def _corpus(n, metric, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    if metric == Metric.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return _duplicate(x)


def _dyadic(shape, seed):
    """k/8 with |k| <= 16: every product and partial sum is exact in
    float32, in any order."""
    return (np.random.default_rng(seed).integers(-16, 17, shape) / 8.0).astype(np.float32)


def _queries(metric, nq=5, seed=1):
    if metric == Metric.EUCLIDEAN:
        # dyadic: |q|^2, added outside the kernel, is exact in any order
        return _dyadic((nq, D), seed)
    q = np.random.default_rng(seed).standard_normal((nq, D)).astype(np.float32)
    if metric == Metric.COSINE:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _bias(x, metric, mask):
    bias = np.where(mask > 0, 0.0, BIG).astype(np.float32)
    if metric == Metric.EUCLIDEAN:
        bias = bias + np.sum(x * x, axis=1).astype(np.float32)
    return bias


def _mask(n, masked, seed=2):
    if not masked:
        return np.ones(n, np.int8)
    return (np.random.default_rng(seed).random(n) < 0.5).astype(np.int8)


def _bf16(x):
    """The same bf16 values for both packages: rounded once by torch (to
    nearest even), handed to JAX as float32 (an exact cast back)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# ----------------------------- int4 quantization -----------------------------


def _int4_rows(seed):
    x = np.random.default_rng(seed).standard_normal((500, D)).astype(np.float32) * 3
    x[7] = 0.0
    # max 7 gives scale 1 in both quantizers: exact halves then exercise
    # round-half-to-even
    x[8] = 0.0
    x[8, :6] = [7.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    x[8, D // 2:D // 2 + 3] = [3.5, -3.5, -6.5]
    return x


def test_quantize_int4_host_bit_equal():
    x = _int4_rows(3)
    tp, ts = tsc.quantize_rows_int4(x)
    jp, js = jsc.quantize_rows_int4(x)
    assert tp.dtype == np.int8 and tp.shape == (500, D // 2)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    with pytest.raises(ValueError, match='even'):
        tsc.quantize_rows_int4(x[:, :D - 1])


def test_quantize_int4_device_bit_equal():
    """The device quantizer multiplies by float32(1/7), as XLA compiles the
    JAX one; the host quantizer divides by 7."""
    x = _int4_rows(4)
    tp, ts = tsc.quantize_rows_int4_device(torch.from_numpy(x))
    jp, js = jsc.quantize_rows_int4_jax(jnp.asarray(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    lo, hi = tsc.unpack_int4(tp)
    assert lo[8, :6].tolist() == [7, 0, 2, 2, -2, 0]
    assert hi[8, :3].tolist() == [4, -4, -6]


def test_unpack_int4_equal_jax():
    # every byte value, and packed rows of the quantizer
    every = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    packed, _ = jsc.quantize_rows_int4(_int4_rows(5))
    for p in (every, packed):
        tlo, thi = tsc.unpack_int4(torch.from_numpy(p))
        jlo, jhi = jsc.unpack_int4(jnp.asarray(p))
        assert tlo.dtype == thi.dtype == torch.int8
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


# ----------------------------- int4 fused scan -----------------------------


# batch sizes at the block pass's query-tile edges (one query, one wgmma
# N of 8, two 32-query tiles, one past a 64-query tile, the limit of 128)
QUERY_TILE_EDGES = (1, 8, 64, 65, 128)


def _int4_equal_jax(metric, masked, select, nq):
    n = N_BY_SELECT[select]
    x = _corpus(n, metric)
    q = _queries(metric, nq)
    packed, scale = jsc.quantize_rows_int4(x)
    bias = _bias(x, metric, _mask(n, masked))
    js, jr = jfs.fused_scan_candidates(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(scale), jnp.asarray(bias),
        int(metric), use_pallas=False, packed_int4=True, select=select)
    ts, tr = tfs.fused_scan_candidates(
        torch.from_numpy(q), torch.from_numpy(packed), torch.from_numpy(scale),
        torch.from_numpy(bias), int(metric), packed_int4=True, select=select)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('metric', list(Metric))
def test_fused_scan_candidates_int4_equal_jax(metric, masked, select):
    """Rows equal and scores bit-equal to the JAX plain reference."""
    _int4_equal_jax(metric, masked, select, 5)


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('nq', QUERY_TILE_EDGES)
def test_fused_scan_candidates_int4_equal_jax_query_tiles(nq, select):
    """The same at the batch sizes where the block pass's query tiles split
    (on the card the kernel equals these plain versions bit for bit)."""
    _int4_equal_jax(Metric.COSINE, True, select, nq)


# ----------------------------- bf16 fused scan -----------------------------


def _bf16_dyadic_bit_equal(metric, masked, select, nq):
    n = N_BY_SELECT[select]
    x = _duplicate(_dyadic((n, D), 6))
    q = _dyadic((nq, D), 7)
    bias = _bias(x, metric, _mask(n, masked))
    tx, jx = _bf16(x)
    js, jr = jfs.fused_scan_candidates(
        jnp.asarray(q), jx, None, jnp.asarray(bias), int(metric),
        use_pallas=False, select=select)
    ts, tr = tfs.fused_scan_candidates(
        torch.from_numpy(q), tx, None, torch.from_numpy(bias), int(metric), select=select)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('metric', [Metric.EUCLIDEAN, Metric.INNER_PRODUCT])
def test_fused_scan_candidates_bf16_dyadic_bit_equal(metric, masked, select):
    """On dyadic rows and queries every partial sum is exact, so the two
    packages' float32 sums agree bit for bit whatever their order."""
    _bf16_dyadic_bit_equal(metric, masked, select, 5)


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('nq', QUERY_TILE_EDGES)
def test_fused_scan_candidates_bf16_dyadic_bit_equal_query_tiles(nq, select):
    _bf16_dyadic_bit_equal(Metric.EUCLIDEAN, True, select, nq)


def _bf16_cosine_within_tolerance(masked, select, nq):
    n = N_BY_SELECT[select]
    metric = Metric.COSINE
    x = _corpus(n, metric, seed=8)
    q = _queries(metric, nq, seed=9)
    bias = _bias(x, metric, _mask(n, masked, seed=10))
    tx, jx = _bf16(x)
    js, jr = jfs.fused_scan_candidates(
        jnp.asarray(q), jx, None, jnp.asarray(bias), int(metric),
        use_pallas=False, select=select)
    ts, tr = tfs.fused_scan_candidates(
        torch.from_numpy(q), tx, None, torch.from_numpy(bias), int(metric), select=select)
    js, jr, ts, tr = np.asarray(js), np.asarray(jr), ts.numpy(), tr.numpy()
    tol = 2 * (D * 2.0**-24 * 1.01 + 2.0**-23)
    assert np.abs(ts.astype(np.float64) - js).max() <= tol
    # exact scores of every row, in float64 from the same bf16 values
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    exact = bias.astype(np.float64)[None, :] - qb @ tx.double().numpy().T + 1.0
    differ = tr != jr
    rows_q = np.nonzero(differ)[0]
    gap = np.abs(exact[rows_q, tr[differ]] - exact[rows_q, jr[differ]])
    assert (gap <= 2 * tol).all(), gap.max()
    assert differ.mean() < 0.01


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('masked', [False, True])
def test_fused_scan_candidates_bf16_cosine_within_tolerance(masked, select):
    """General unit rows: the float32 sums of D exact bf16 products differ
    with their order.  Each package's sum is within D * 2^-24 * sum|q_d x_d|
    (<= 1.01 for unit rows rounded to bf16) of the exact one, plus half an
    ulp of 2 for the added 1.0, so the two scores differ by at most
    ``tol``.  Rows may differ only where candidates tie within ``2 * tol``:
    wherever the rows differ, their exact scores lie within ``2 * tol``."""
    _bf16_cosine_within_tolerance(masked, select, 5)


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('nq', QUERY_TILE_EDGES)
def test_fused_scan_candidates_bf16_cosine_within_tolerance_query_tiles(nq, select):
    _bf16_cosine_within_tolerance(True, select, nq)


def test_fused_scan_raw_scores_int4_bit_equal():
    """The kernels' contract itself for the int4 branch: the plain version
    equals the JAX reference before the finishing term, general queries."""
    n = 32768
    x = _corpus(n, Metric.EUCLIDEAN, seed=11)
    q = np.random.default_rng(12).standard_normal((7, D)).astype(np.float32)
    packed, scale = jsc.quantize_rows_int4(x)
    bias = _bias(x, Metric.EUCLIDEAN, _mask(n, True, seed=13))
    jq8, jqsc = jsc.quantize_rows_int8_jax(jnp.asarray(q))
    tq8, tqsc = tsc.quantize_rows_int8_device(torch.from_numpy(q))
    for jref, tref in ((jfs._fused_scan_ref, tfs._fused_scan_ref),
                       (jfs._fused_scan8_ref, tfs._fused_scan8_ref)):
        js, jr = jref(jq8.astype(jnp.bfloat16), jqsc, jnp.asarray(packed),
                      jnp.asarray(scale), jnp.asarray(bias), 8192, -2.0, True)
        ts, tr = tref(tq8, tqsc, torch.from_numpy(packed), torch.from_numpy(scale),
                      torch.from_numpy(bias), 8192, -2.0, True)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_variant_wrappers_refuse_cpu_tensors():
    launches0 = profile.snapshot()['counters']
    q8 = torch.zeros((2, D), dtype=torch.int8)
    ones = torch.ones(8192)
    with pytest.raises(ValueError, match='CUDA'):
        tfs.block_top2(q8, torch.ones(2), torch.zeros((8192, D // 2), dtype=torch.int8),
                       ones, ones, 8192, -1.0, packed_int4=True)
    with pytest.raises(ValueError, match='CUDA'):
        tfs.block_top2(q8.to(torch.bfloat16), torch.ones(2),
                       torch.zeros((8192, D), dtype=torch.bfloat16), ones, ones, 8192, -1.0)
    launches = profile.snapshot()['counters']
    for k in ('launch.block_top2_int4', 'launch.block_top2_bf16'):
        assert launches.get(k, 0) == launches0.get(k, 0)


@pytest.mark.parametrize('n,d,q,ok', [
    (16384, 256, 64, True), (16384, 128, 64, False), (8192, 768, 128, True),
    (8192, 384, 8, False), (12000, 256, 4, False), (8192, 3072, 8, True),
    (8192, 3328, 8, False),
])
def test_supports_fused_scan_int4(n, d, q, ok):
    """int4 needs the packed row (d/2 bytes) lane-aligned, as in JAX."""
    assert tfs.supports_fused_scan(n, d, q, packed_int4=True) is ok
    if d <= 3072:  # the JAX rule has no dimension limit
        assert jfs.supports_fused_scan(n, d, q, packed_int4=True) is ok


# ----------------------------- scan_topk -----------------------------


@pytest.mark.parametrize('fused,n', [(False, 32768), (True, 16384), (True, 32768)])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('metric', list(Metric))
@pytest.mark.parametrize('mode', ['int4', 'bf16'])
def test_scan_topk_equal_jax(mode, metric, masked, fused, n):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((n, D)).astype(np.float32)
    if metric == Metric.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:4] + 0.05 * rng.standard_normal((4, D)).astype(np.float32)
    if metric == Metric.COSINE:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    norms = np.sum(x * x, axis=1).astype(np.float32)
    mask = _mask(n, masked, seed=15)
    if mode == 'int4':
        packed, scale = jsc.quantize_rows_int4(x)
        tscan, jscan = torch.from_numpy(packed), jnp.asarray(packed)
        tscale, jscale = torch.from_numpy(scale), jnp.asarray(scale)
    else:
        tscan, jscan = _bf16(x)
        tscale = jscale = None
    k = 10
    jd, ji = jsc.scan_topk(jnp.asarray(q), jscan, jscale, jnp.asarray(norms),
                           jnp.asarray(mask), k, metric, x_f32=jnp.asarray(x),
                           fused=fused, packed_int4=mode == 'int4')
    td, ti = tsc.scan_topk(torch.from_numpy(q), tscan, tscale, torch.from_numpy(norms),
                           torch.from_numpy(mask), k, metric, x_f32=torch.from_numpy(x),
                           fused=fused, packed_int4=mode == 'int4')
    assert_topk_close(td.numpy(), ti.numpy(), jd, ji)
    assert mask[ti.numpy()].all()


def test_scan_topk_refuses_other_corpora():
    q = torch.zeros((2, D))
    m = torch.ones(8192, dtype=torch.int8)
    for corpus, packed in ((torch.zeros((8192, D), dtype=torch.uint8), False),
                           (torch.zeros((8192, D), dtype=torch.bfloat16), True)):
        with pytest.raises(ValueError, match='unsupported scan corpus'):
            tsc.scan_topk(q, corpus, None, None, m, 5, Metric.COSINE, packed_int4=packed)
        with pytest.raises(ValueError, match='unsupported scan corpus'):
            tfs.fused_scan_candidates(q, corpus, None, torch.zeros(8192),
                                      int(Metric.COSINE), packed_int4=packed)


# ----------------------------- FlatIndex and AnnLite -----------------------------


def _flat_data(n=3000, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:6] + 0.05 * rng.standard_normal((6, d)).astype(np.float32)
    return x, q


@pytest.mark.parametrize('scan_mode', ['int4', 'bf16'])
def test_flat_index_from_jax_state_scan_modes(scan_mode):
    """A JAX FlatIndex snapshot in either mode opens in the port and gives
    the same search; a state round trip through the port is exact."""
    x, q = _flat_data(d=256)
    j = JFlat(256, metric=Metric.EUCLIDEAN, scan_mode=scan_mode)
    j.add_with_ids(x, np.arange(len(x)))
    t = flat_index_from_jax_state(j.state_arrays(), metric='euclidean',
                                  scan_mode=scan_mode, device='cpu')
    assert t.scan_mode == scan_mode and t.size == j.size
    assert_topk_close(*t.search(q, limit=10), *j.search(q, limit=10))
    u = TFlat(256, metric='euclidean', scan_mode=scan_mode, device='cpu')
    u.load_state_arrays(t.state_arrays())
    for a, b in zip(t.search(q, limit=10), u.search(q, limit=10)):
        np.testing.assert_array_equal(a, b)
    # the scan copies equal the JAX package's
    np.testing.assert_array_equal(t._scan_buf.host_view(),
                                  np.asarray(j._scan_buf.host_view(), np.float32)
                                  if scan_mode == 'bf16' else j._scan_buf.host_view())


@pytest.mark.parametrize('scan_mode', ['int4', 'bf16'])
def test_annlite_scan_mode_equal_jax_and_reopen(tmp_path, scan_mode):
    d, n = 64, 600
    rng = np.random.default_rng(16)
    x = rng.standard_normal((n, d)).astype(np.float32)
    prices = rng.uniform(0, 100, n)

    def docs(mod):
        return [mod.Doc(id=f'd{i}', embedding=x[i], tags={'price': float(prices[i])})
                for i in range(n)]

    cfg = dict(metric='cosine', columns=[('price', float)], scan_mode=scan_mode)
    t = TAnnLite(d, data_path=tmp_path / 't', device='cpu', **cfg)
    j = JAnnLite(d, data_path=tmp_path / 'j', **cfg)
    t.index(docs(tdoc))
    j.index(docs(jdoc))
    q = x[:8] + 0.01
    flt = {'price': {'$lt': 50.0}}
    for kw in ({}, {'filter': flt}):
        (td, ti), (jd, ji) = t.search_numpy(q, limit=10, **kw), j.search_numpy(q, limit=10, **kw)
        assert ti == ji
        for a, b in zip(td, jd):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    sd, sids = t.serving_searcher(limit=10)(q)
    want_d, want = t.search_numpy(q, limit=10)
    assert sids == want
    np.testing.assert_array_equal(sd, np.stack(want_d))
    t.delete(['d1'])
    want_d, want = t.search_numpy(q, limit=10)
    assert 'd1' not in {i for r in want for i in r}
    t.dump()
    t.close()
    j.close()
    t2 = TAnnLite(d, data_path=tmp_path / 't', device='cpu', **cfg)
    back_d, back = t2.search_numpy(q, limit=10)
    assert t2._container.index.scan_mode == scan_mode
    assert back == want
    for a, b in zip(back_d, want_d):
        np.testing.assert_array_equal(a, b)
    t2.close()
