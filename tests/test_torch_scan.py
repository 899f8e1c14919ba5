"""annlite_torch.ops (scan, fused scan, gather-rerank) against annlite_tpu.ops
on identical numpy inputs.  The JAX functions run on the CPU through their
plain references (``use_pallas=False``), as the JAX package's own tests run
them; the port's run on the CPU through the kernels' plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch import profile
from annlite_torch.ops import fused_scan as tfs
from annlite_torch.ops import gather as tga
from annlite_torch.ops import scan as tsc
from annlite_tpu.enums import Metric
from annlite_tpu.ops import fused_scan as jfs
from annlite_tpu.ops import gather as jga
from annlite_tpu.ops import scan as jsc
from torch_parity import assert_topk_close

BIG = 3.4e38
D = 128
# N = 16384 exercises the block2 select, 32768 the lane8 select
N_BY_SELECT = {'block2': 16384, 'lane8': 32768}


def _corpus(n, metric, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    # duplicated rows exercise the tie rules: rows 128..255 share block 0's
    # buckets with rows 0..127; rows 8192.. share lane classes with rows 0..
    # across blocks
    x[128:256] = x[0:128]
    x[8192:8192 + 2048] = x[0:2048]
    if metric == Metric.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _queries(metric, nq=5, seed=1):
    rng = np.random.default_rng(seed)
    if metric == Metric.EUCLIDEAN:
        # dyadic values: |q|^2, which the L2 scores add outside the kernel,
        # is then exact in any summation order, so the two frameworks' sums
        # agree bit for bit (for general queries they may differ in the last
        # bit, which test_fused_scan_raw_scores_bit_equal sidesteps)
        return (rng.integers(-16, 17, (nq, D)) / 8.0).astype(np.float32)
    q = rng.standard_normal((nq, D)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _bias(x, metric, mask):
    bias = np.where(mask > 0, 0.0, BIG).astype(np.float32)
    if metric == Metric.EUCLIDEAN:
        bias = bias + np.sum(x * x, axis=1).astype(np.float32)
    return bias


def _mask(n, masked, seed=2):
    if not masked:
        return np.ones(n, np.int8)
    return (np.random.default_rng(seed).random(n) < 0.5).astype(np.int8)


# ----------------------------- quantization -----------------------------


def test_quantize_host_bit_equal():
    x = np.random.default_rng(3).standard_normal((500, D)).astype(np.float32) * 3
    x[7] = 0.0
    tc, ts = tsc.quantize_rows_int8(x)
    jc, js = jsc.quantize_rows_int8(x)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)


def test_quantize_device_bit_equal():
    x = np.random.default_rng(4).standard_normal((500, D)).astype(np.float32) * 3
    x[7] = 0.0
    # exact halves exercise round-half-to-even
    x[8, :4] = [0.5, 1.5, 2.5, -2.5]
    x[8, 4] = 127.0
    tc, ts = tsc.quantize_rows_int8_device(torch.from_numpy(x))
    jc, js = jsc.quantize_rows_int8_jax(jnp.asarray(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_dot_exact_past_one_chunk():
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (6, 1100)).astype(np.int8)
    b = rng.integers(-127, 128, (9, 1100)).astype(np.int8)
    got = tfs.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


# ----------------------------- fused scan -----------------------------


# batch sizes at the block pass's query-tile edges (one query, one wgmma
# N of 8, a full 64-query tile, one past it, the geometry's limit of 128)
QUERY_TILE_EDGES = (1, 8, 64, 65, 128)


def _candidates_equal_jax(metric, masked, select, nq):
    n = N_BY_SELECT[select]
    x = _corpus(n, metric)
    q = _queries(metric, nq)
    codes, scale = jsc.quantize_rows_int8(x)
    bias = _bias(x, metric, _mask(n, masked))
    js, jr = jfs.fused_scan_candidates(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale),
        jnp.asarray(bias), int(metric), use_pallas=False, select=select)
    ts, tr = tfs.fused_scan_candidates(
        torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(scale),
        torch.from_numpy(bias), int(metric), select=select)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('metric', [Metric.COSINE, Metric.EUCLIDEAN])
def test_fused_scan_candidates_equal_jax(metric, masked, select):
    """Rows equal and scores equal to fused_scan_candidates(use_pallas=False)."""
    _candidates_equal_jax(metric, masked, select, 5)


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('nq', QUERY_TILE_EDGES)
def test_fused_scan_candidates_equal_jax_query_tiles(nq, select):
    """The same at the batch sizes where the block pass's query tiles split
    (on the card the kernel equals these plain versions bit for bit)."""
    _candidates_equal_jax(Metric.EUCLIDEAN, True, select, nq)


def _raw_scores_bit_equal(coef, select, nq):
    n = N_BY_SELECT[select]
    metric = Metric.EUCLIDEAN if coef == -2.0 else Metric.COSINE
    x = _corpus(n, metric, seed=10)
    q = np.random.default_rng(11).standard_normal((nq, D)).astype(np.float32)
    codes, scale = jsc.quantize_rows_int8(x)
    bias = _bias(x, metric, _mask(n, True, seed=12))
    jq8, jqsc = jsc.quantize_rows_int8_jax(jnp.asarray(q))
    jref = jfs._fused_scan8_ref if select == 'lane8' else jfs._fused_scan_ref
    js, jr = jref(jq8.astype(jnp.bfloat16), jqsc, jnp.asarray(codes),
                  jnp.asarray(scale), jnp.asarray(bias), 8192, coef)
    tq8, tqsc = tsc.quantize_rows_int8_device(torch.from_numpy(q))
    tref = tfs._fused_scan8_ref if select == 'lane8' else tfs._fused_scan_ref
    ts, tr = tref(tq8, tqsc, torch.from_numpy(codes), torch.from_numpy(scale),
                  torch.from_numpy(bias), 8192, coef)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('coef', [-1.0, -2.0])
def test_fused_scan_raw_scores_bit_equal(coef, select):
    """The kernels' contract itself, for general (non-dyadic) queries: the
    plain versions equal the JAX references before |q|^2 is added."""
    _raw_scores_bit_equal(coef, select, 7)


@pytest.mark.parametrize('select', ['block2', 'lane8'])
@pytest.mark.parametrize('nq', QUERY_TILE_EDGES)
def test_fused_scan_raw_scores_bit_equal_query_tiles(nq, select):
    _raw_scores_bit_equal(-1.0, select, nq)


@pytest.mark.parametrize('block_rows', [128, 1024, 8192])
@pytest.mark.parametrize('nb', [1, 2, 4, 8, 16, 128])
def test_block_pass_plan_covers_each_cell_once(nb, block_rows):
    """The block pass's CTAs (query tiles, lane halves, group splits) cover
    every (block, group, lane, query) exactly once, for every batch the
    fused scan admits (Q <= 128) in every variant; the tiles fit the
    kernels' shapes, and a split keeps at least two groups."""
    n = nb * block_rows
    groups = block_rows // 128
    for variant in ('int8', 'int4', 'bf16'):
        for nq in range(1, 129):
            plan = tfs.block_pass_plan(nq, n, block_rows, variant)
            assert plan.nt in tfs.TILE_WIDTHS
            assert plan.nwg == 1 or (variant == 'int8' and plan.nwg == 2 and plan.nt == 32)
            assert 1 <= plan.qt <= plan.nt * plan.nwg <= tfs.QUERY_TILE[variant]
            assert (plan.tiles - 1) * plan.qt < nq <= plan.tiles * plan.qt
            assert groups % plan.splits == 0
            assert plan.splits == 1 or groups // plan.splits >= 2
            # a CTA's lanes are one of the two halves of 64 (its M tile)
            seen = np.zeros((nb, groups, 2, nq), np.int8)
            for blk, lanes, grp, queries in tfs.block_pass_ctas(plan, nq, n, block_rows):
                assert lanes in (range(0, 64), range(64, 128))
                seen[blk, grp.start:grp.stop, lanes.start // 64,
                     queries.start:queries.stop] += 1
            assert (seen == 1).all(), (variant, nq)


def test_lane8_merge_ref_is_stable_top8():
    """Among equal scores of one lane class the earlier candidate (lower
    block, mn1 before mn2) comes first."""
    s = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0, 5.0, 0.5, 1.0, 9.0, 9.0]])
    s = s.repeat_interleave(128, dim=1).reshape(1, 10, 128)
    s = s.reshape(1, 1280)
    r = torch.arange(1280, dtype=torch.int32)[None, :]
    s8, r8 = tfs._lane8_merge_ref(s, r)
    want = [6, 1, 2, 4, 7, 3, 0, 5]  # slot order of the stable sort
    assert (r8[0, ::128] // 128).tolist() == want
    assert (r8[0, 5::128] - 5).div(128, rounding_mode='floor').tolist() == want


def test_wrappers_refuse_cpu_tensors():
    launches0 = profile.snapshot()['counters']
    q8 = torch.zeros((2, D), dtype=torch.int8)
    qsc = torch.ones(2)
    x8 = torch.zeros((8192, D), dtype=torch.int8)
    ones = torch.ones(8192)
    with pytest.raises(ValueError, match='CUDA'):
        tfs.block_top2(q8, qsc, x8, ones, ones, 8192, -1.0)
    with pytest.raises(ValueError, match='CUDA'):
        tfs.lane8_merge(torch.zeros((2, 1024)), torch.zeros((2, 1024), dtype=torch.int32))
    with pytest.raises(ValueError, match='CUDA'):
        tga.gather_rerank(torch.zeros((2, D)), torch.zeros((10, D)),
                          torch.zeros((2, 3), dtype=torch.int32), 1)
    launches = profile.snapshot()['counters']
    for k in ('launch.block_top2', 'launch.lane8_merge', 'launch.gather_rerank'):
        assert launches.get(k, 0) == launches0.get(k, 0)


@pytest.mark.parametrize('case,reason', [
    ('ok', None),
    ('dtype', 'expected torch.int8 queries'),
    ('row', '128-byte TMA boxes'),
    ('dim', 'D = 3200 > 3072'),
    ('n', 'must be a multiple of block_rows'),
    ('scales', 'must be float32'),
])
def test_block_pass_names_what_it_refuses(case, reason):
    """The wrapper's checks (run before a launch): None for inputs the
    kernel takes, else the reason it raises with."""
    n, d = 16384, {'row': 64, 'dim': 3200}.get(case, 128)
    q = torch.zeros((3, d), dtype=torch.float32 if case == 'dtype' else torch.int8)
    x = torch.zeros((n - (case == 'n'), d), dtype=torch.int8)
    rs = torch.ones(x.shape[0], dtype=torch.float64 if case == 'scales' else torch.float32)
    got = tfs._unsupported(q, torch.ones(3), x, rs, torch.zeros(x.shape[0]), 8192,
                           torch.int8, torch.int8, d)
    assert (got is None) if reason is None else reason in got


def test_unported_corpora_raise():
    """Only int8, packed int4 (int8 storage) and bf16 corpora are scanned."""
    q = torch.zeros((2, D))
    x = torch.zeros((8192, D), dtype=torch.uint8)
    with pytest.raises(ValueError, match='unsupported scan corpus'):
        tfs.fused_scan_candidates(q, x, None, torch.zeros(8192), int(Metric.COSINE))
    for corpus in (x, x.to(torch.float32)):
        with pytest.raises(ValueError, match='unsupported scan corpus'):
            tsc.scan_topk(q, corpus, None, None, torch.ones(8192, dtype=torch.int8),
                          5, Metric.COSINE)


@pytest.mark.parametrize('n,d,q,ok', [
    (16384, 768, 64, True), (16384, 100, 64, False), (12000, 128, 4, False),
    (8192, 128, 129, False), (8192, 3072, 8, True), (8192, 3200, 8, False),
])
def test_supports_fused_scan(n, d, q, ok):
    assert tfs.supports_fused_scan(n, d, q) is ok
    if d <= 3072:  # the JAX rule has no dimension limit
        assert jfs.supports_fused_scan(n, d, q) is ok


# ----------------------------- gather-rerank -----------------------------


@pytest.mark.parametrize('metric', list(Metric))
def test_gather_rerank_dists_equal_jax(metric):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1000, D)).astype(np.float32)
    q = rng.standard_normal((6, D)).astype(np.float32)
    cand = rng.integers(-3, 1003, (6, 40)).astype(np.int32)  # some out of range
    t = tga.gather_rerank_dists(torch.from_numpy(q), torch.from_numpy(x),
                                torch.from_numpy(cand), int(metric))
    j = jga.gather_rerank_dists(jnp.asarray(q), jnp.asarray(x),
                                jnp.asarray(cand), int(metric), use_pallas=False)
    # 1 - q.c is a difference of terms of size |q||c| ~ D: atol for those
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6 * D)


@pytest.mark.parametrize('r', [1, 40, 128, 1000])
@pytest.mark.parametrize('nq', [1, 3, 64, 65, 100])
def test_gather_plan_covers_each_pair_once(nq, r):
    """The kernel's warps (one (query, candidate) pair each) cover every pair
    exactly once, in CTAs of at most 8 warps, and spread over as many CTAs
    as an H100 has SMs wherever there are that many pairs."""
    plan = tga.gather_plan(nq, r)
    assert 1 <= plan.warps <= tga.MAX_WARPS
    assert plan.grid >= min(tga.TARGET_CTAS, nq * r)
    seen = np.zeros((nq, r), np.int32)
    pairs = tga.gather_plan_pairs(plan, nq, r)
    assert len(pairs) == plan.grid * plan.warps
    for p in pairs:
        if p is not None:
            seen[p] += 1
    assert (seen == 1).all()
    assert sum(p is None for p in pairs) < plan.warps  # only the last CTA is cut


@pytest.mark.parametrize('metric', list(Metric))
def test_exact_rerank_masked_slots_score_big(metric):
    """Masked and padded shortlist slots score exactly BIG (float32) and
    never displace a live candidate, even where their rows are the nearest:
    the query's own row sits in two masked slots."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((50, D)).astype(np.float32)
    if metric == Metric.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[[7, 8]].copy()
    cand = np.array([[7, 3, 7, 11, 20, 21], [30, 8, 31, 32, 8, 33]], np.int32)
    masked = np.array([[True, False, True, False, False, True],
                       [False, True, False, False, True, True]])
    d, ids = tsc._exact_rerank(torch.from_numpy(q), torch.from_numpy(x),
                               torch.from_numpy(cand), torch.from_numpy(masked),
                               int(metric), 5)
    d, ids = d.numpy(), ids.numpy()
    assert d.dtype == np.float32
    for row in range(2):
        live = cand[row][~masked[row]]
        assert sorted(ids[row][:len(live)].tolist()) == sorted(live.tolist())
        assert (d[row][:len(live)] < BIG).all()
        assert (d[row][len(live):] == np.float32(BIG)).all()
        assert (np.diff(d[row]) >= 0).all()


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('metric', list(Metric))
def test_scan_topk_few_alive_rows_pad_big_equal_jax(metric, fused):
    """Fewer alive rows than k: the shortlist's padded slots score BIG and
    come last, the alive rows first with their exact distances, as in the
    JAX package."""
    n, k = 16384, 10
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, D)).astype(np.float32)
    if metric == Metric.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[[5, 9]].copy()
    codes, scale = jsc.quantize_rows_int8(x)
    norms = np.sum(x * x, axis=1).astype(np.float32)
    mask = np.zeros(n, np.int8)
    mask[[3, 5, 9, 4000]] = 1
    jd, ji = jsc.scan_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale),
                           jnp.asarray(norms), jnp.asarray(mask), k, metric,
                           x_f32=jnp.asarray(x), fused=fused)
    td, ti = tsc.scan_topk(torch.from_numpy(q), torch.from_numpy(codes),
                           torch.from_numpy(scale), torch.from_numpy(norms),
                           torch.from_numpy(mask), k, metric,
                           x_f32=torch.from_numpy(x), fused=fused)
    td, ti = td.numpy(), ti.numpy()
    jd = np.asarray(jd)
    for row in range(2):
        assert sorted(ti[row][:4].tolist()) == [3, 5, 9, 4000]
        assert (td[row][4:] == np.float32(BIG)).all()
        np.testing.assert_array_equal(td[row][4:], jd[row][4:])
        np.testing.assert_array_equal(ti[row][:4], np.asarray(ji)[row][:4])
        np.testing.assert_allclose(td[row][:4], jd[row][:4], rtol=1e-5, atol=1e-5)


# ----------------------------- scan_topk -----------------------------


@pytest.mark.parametrize('fused,n', [(False, 32768), (True, 16384), (True, 32768)])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('metric', list(Metric))
def test_scan_topk_equal_jax(metric, masked, fused, n):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, D)).astype(np.float32)
    if metric == Metric.COSINE:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:4] + 0.05 * rng.standard_normal((4, D)).astype(np.float32)
    if metric == Metric.COSINE:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    codes, scale = jsc.quantize_rows_int8(x)
    norms = np.sum(x * x, axis=1).astype(np.float32)
    mask = _mask(n, masked, seed=9)
    k = 10
    jd, ji = jsc.scan_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale),
                           jnp.asarray(norms), jnp.asarray(mask), k, metric,
                           x_f32=jnp.asarray(x), fused=fused)
    td, ti = tsc.scan_topk(torch.from_numpy(q), torch.from_numpy(codes),
                           torch.from_numpy(scale), torch.from_numpy(norms),
                           torch.from_numpy(mask), k, metric,
                           x_f32=torch.from_numpy(x), fused=fused)
    assert_topk_close(td.numpy(), ti.numpy(), jd, ji)
    assert mask[ti.numpy()].all()
