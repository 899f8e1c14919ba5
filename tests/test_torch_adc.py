"""annlite_torch.ops.adc against annlite_tpu.ops.adc on identical numpy
inputs.  The JAX functions run on the CPU through their references
(``use_pallas=False``), as the JAX package's own tests run them; the port's
run on the CPU through the kernels' plain versions."""
import numpy as np
import pytest
import torch

from annlite_torch.ops import adc as tadc
from annlite_torch.ops import fused_scan as tfs
from annlite_tpu.ops import adc as jadc
from torch_parity import assert_topk_close

BIG = 3.4e38


def _inputs(q, m, k, n, code_dtype=np.uint8, dyadic=False, dup=True, seed=0):
    """``dtable [Q, M, K]``, codes ``[N, M]``.  Dyadic tables (multiples of
    1/8 below 16) sum exactly in any order, so the two packages' scores are
    then bit-equal and their selections comparable row for row."""
    rng = np.random.default_rng(seed)
    if dyadic:
        dtable = (rng.integers(0, 128, (q, m, k)) / 8.0).astype(np.float32)
    else:
        dtable = rng.uniform(0, 10, (q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (n, m)).astype(code_dtype)
    if dup and n >= 4096 + 256:
        # duplicated rows exercise the tie rules: rows 128..255 share block
        # 0's buckets with rows 0..127; rows 4096.. share lane classes with
        # rows 0.. across blocks
        codes[128:256] = codes[0:128]
        codes[4096:4096 + 256] = codes[0:256]
    return dtable, codes


def _mask(n, masked, seed=2):
    if not masked:
        return None
    return (np.random.default_rng(seed).random(n) < 0.6).astype(np.int8)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('code_dtype,k', [(np.uint8, 16), (np.uint16, 300)])
def test_adc_scores_equal_jax(code_dtype, k, masked):
    dtable, codes = _inputs(5, 8, k, 1000, code_dtype)
    mask = _mask(1000, masked)
    want = np.asarray(jadc.adc_scores(dtable, codes.T, mask, use_pallas=False))
    got = tadc.adc_scores(_t(dtable), _t(codes.T), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if masked:
        assert (got[:, mask == 0] == np.float32(BIG)).all()
    ref = np.asarray(jadc.adc_scores_ref(dtable, codes.T))
    np.testing.assert_allclose(tadc.adc_scores_ref(_t(dtable), _t(codes.T)).numpy(),
                               ref, rtol=1e-5)


def _oracle_select8(scores, block_n):
    """numpy oracle of the deep select from ``[Q, N]`` scores: per block and
    lane the best two groups (lowest group on ties, the second clamped to
    groups - 1), then a stable top-8 per lane class -> ``[Q, 1024]``."""
    q, n = scores.shape
    nb, groups = n // block_n, block_n // 128
    s4 = scores.reshape(q, nb, groups, 128)
    order = np.argsort(s4, axis=2, kind='stable')
    g1, g2 = order[:, :, 0, :], order[:, :, 1, :] if groups > 1 else order[:, :, 0, :]
    g2 = np.minimum(g2, groups - 1)
    lane = np.arange(128)
    base = (np.arange(nb) * block_n)[None, :, None]
    mn1 = np.take_along_axis(s4, g1[:, :, None, :], 2)[:, :, 0, :]
    mn2 = np.take_along_axis(s4, g2[:, :, None, :], 2)[:, :, 0, :]
    s = np.concatenate([mn1, mn2], axis=-1).reshape(q, nb * 256)
    r = np.concatenate([base + g1 * 128 + lane, base + g2 * 128 + lane],
                       axis=-1).reshape(q, nb * 256)
    s3, r3 = s.reshape(q, nb * 2, 128), r.reshape(q, nb * 2, 128)
    top = np.argsort(s3, axis=1, kind='stable')[:, :8]
    return (np.take_along_axis(s3, top, 1).reshape(q, 1024),
            np.take_along_axis(r3, top, 1).reshape(q, 1024))


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('code_dtype,k,n', [(np.uint8, 16, 4 * 4096),
                                            (np.uint16, 300, 4 * 2048)])
def test_deep_select_candidates_equal_oracle(code_dtype, k, n, masked):
    """The plain K4 block pass + lane8 merge against a numpy oracle built from
    the JAX reference's scores: rows equal, scores bit-equal."""
    dtable, codes = _inputs(3, 8, k, n, code_dtype, dyadic=True)
    mask = _mask(n, masked)
    block_n = tadc._scale_blocks(k)
    assert n == 4 * block_n
    scores = np.asarray(jadc.adc_scores(dtable, codes.T, mask, use_pallas=False))
    want_s, want_r = _oracle_select8(scores, block_n)
    m8 = torch.ones(n, dtype=torch.int8) if mask is None else _t(mask)
    s, r = tadc._adc_block_top2_ref(_t(dtable), _t(codes.T), m8, block_n)
    s8, r8 = tfs._lane8_merge_ref(s, r)
    np.testing.assert_array_equal(r8.numpy(), want_r)
    np.testing.assert_array_equal(s8.numpy(), want_s)


@pytest.mark.parametrize('exact', [False, True])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('n', [1000, 4 * 4096])
def test_adc_topk_equal_jax(n, masked, exact):
    dtable, codes = _inputs(4, 8, 16, n)
    mask = _mask(n, masked)
    jd, ji = jadc.adc_topk(dtable, codes.T, 20, mask, exact=exact, use_pallas=False)
    td, ti = tadc.adc_topk(_t(dtable), _t(codes.T), 20, _t(mask), exact=exact)
    assert ti.dtype == torch.int32
    assert_topk_close(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji))


def test_adc_topk_deep_select_on_cpu():
    """``deep=True`` runs the deep select's plain version: its top-k is drawn
    from the 1024 candidates, which hold every row of the exact top-8 here."""
    dtable, codes = _inputs(3, 8, 16, 4 * 4096, dyadic=True)
    td, ti = tadc.adc_topk(_t(dtable), _t(codes.T), 8, deep=True)
    scores = tadc.adc_scores(_t(dtable), _t(codes.T)).numpy()
    np.testing.assert_array_equal(td.numpy(), np.sort(scores, axis=1)[:, :8])
    np.testing.assert_array_equal(
        np.take_along_axis(scores, ti.numpy().astype(np.int64), 1), td.numpy())
    # not taken where the JAX dispatch would not take it
    d2, i2 = tadc.adc_topk(_t(dtable), _t(codes.T[:, :4096 * 3]), 8, deep=True)
    assert i2.max() < 4096 * 3


def test_kernel_wrappers_refuse_cpu_tensors():
    dtable, codes = _inputs(2, 4, 16, 4096)
    d, c, m = _t(dtable), _t(codes.T), torch.ones(4096, dtype=torch.int8)
    with pytest.raises(ValueError, match='CUDA'):
        tadc.adc_scores_kernel(d, c, m)
    with pytest.raises(ValueError, match='CUDA'):
        tadc.adc_block_top2(d, c, m, 4096)


def test_scale_blocks_and_limits():
    for k in (16, 256, 300, 1024, 4096):
        assert tadc._scale_blocks(k) == jadc._scale_blocks(k, 64, 4096)[1]
    assert tadc.supports_adc(32768) and not tadc.supports_adc(tadc.MAX_ADC_CLUSTERS + 1)
    with pytest.raises(ValueError, match='uint8 or uint16'):
        tadc._code_bytes(torch.zeros(3, dtype=torch.int32))


# the query tile's edges: Q = 1, QT - 1, QT, QT + 1 and 2 QT + 1 of the
# lookup core's largest tile (csrc/adc.cu; ops/adc.py adc_plan)
QT = tadc.MAX_QUERY_TILE
TILE_EDGES = [1, QT - 1, QT, QT + 1, 2 * QT + 1]


@pytest.mark.parametrize('nq', TILE_EDGES)
def test_adc_scores_equal_jax_query_tiles(nq):
    """The plain K5 (masked scores) against the JAX function on dyadic
    tables, bit for bit, at the query tile's edges."""
    dtable, codes = _inputs(nq, 8, 16, 1000, dyadic=True, seed=nq)
    mask = _mask(1000, True)
    want = np.asarray(jadc.adc_scores(dtable, codes.T, mask, use_pallas=False))
    got = tadc.adc_scores(_t(dtable), _t(codes.T), _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('nq', TILE_EDGES)
def test_deep_select_candidates_equal_oracle_query_tiles(nq):
    """The plain K4 block pass + lane8 merge against the numpy oracle from
    the JAX reference's scores at the query tile's edges: rows equal, scores
    bit-equal."""
    n = 4 * 4096
    dtable, codes = _inputs(nq, 8, 16, n, dyadic=True, seed=nq)
    mask = _mask(n, True)
    scores = np.asarray(jadc.adc_scores(dtable, codes.T, mask, use_pallas=False))
    want_s, want_r = _oracle_select8(scores, 4096)
    s, r = tadc._adc_block_top2_ref(_t(dtable), _t(codes.T), _t(mask), 4096)
    s8, r8 = tfs._lane8_merge_ref(s, r)
    np.testing.assert_array_equal(r8.numpy(), want_r)
    np.testing.assert_array_equal(s8.numpy(), want_s)


def _check_plan_covers(n_rb, bn, m, k, queries):
    """For every batch in ``queries``: the core's CTAs cover each (row block,
    group, query) once and each CTA's threads cover each (row block of the
    CTA, lane, query of the tile) once, so each (block, group, lane, query)
    is computed exactly once; the plan fits the kernel's limits."""
    groups = bn // 128
    thread_maps = {}
    for nq in queries:
        plan = tadc.adc_plan(nq, n_rb, bn, m, k)
        assert plan.qt in tadc.QUERY_TILES and plan.qt <= tadc.MAX_QUERY_TILE
        assert (plan.tiles - 1) * plan.qt < nq <= plan.tiles * plan.qt
        assert groups % plan.splits == 0
        assert plan.threads <= tadc.MAX_THREADS and plan.smem <= tadc.MAX_SMEM
        assert 1 <= plan.nbuf <= min(plan.nchunks, tadc.NBUF) and (
            (plan.nchunks - 1) * plan.mc < m <= plan.nchunks * plan.mc)
        # a chunk of the interleaved table is whole 16-byte units
        assert (plan.mc * -(-k // 4) * 4 * plan.qt * 4) % 16 == 0
        key = (plan.qt, plan.nbc)
        if key not in thread_maps:
            seen = np.zeros((plan.nbc, 128, plan.qt), np.int32)
            for blk, lanes, qs in tadc.adc_plan_threads(plan):
                seen[blk, lanes.start:lanes.stop, qs.start:qs.stop] += 1
            thread_maps[key] = bool((seen == 1).all())
        assert thread_maps[key], (nq, plan)
        ctas = tadc.adc_plan_ctas(plan, nq, n_rb, groups)
        assert len(ctas) == plan.grid
        seen = np.zeros((n_rb, groups, nq), np.int32)
        for rb0, grp, qs in ctas:
            seen[rb0:rb0 + plan.nbc, grp.start:grp.stop, qs.start:qs.stop] += 1
        assert (seen == 1).all(), (nq, plan)


@pytest.mark.parametrize('n_rb,bn,m,k', [
    (256, 4096, 64, 256),     # the PQ path: 2^20 rows (K4, K5)
    (32, 4096, 64, 256),      # the facade's PQ index: 131,072 rows
    (4, 4096, 8, 16),         # the CPU tests' deep select
    (3, 4096, 64, 256),       # K5 at N = 12,293 (a partial last block)
    (128, 1024, 64, 1024),    # K = 1024, u16: the table tiled over subspaces
    (4, 4096, 4, 58096),      # the largest K the kernels take
])
def test_adc_plan_covers_each_cell_once(n_rb, bn, m, k):
    _check_plan_covers(n_rb, bn, m, k, range(1, 131))


def test_adc_plan_limits():
    assert tadc.MAX_ADC_CLUSTERS == (tadc.MAX_SMEM - 64) // 4 == 58096
    with pytest.raises(ValueError, match='exceed'):
        tadc.adc_plan(1, 1, 4096, 8, tadc.MAX_ADC_CLUSTERS + 1)
    # the PQ path at batch 64: four tiles of 16, two row blocks per CTA, the
    # table streamed through two buffers; batch 1 keeps its table resident
    p64 = tadc.adc_plan(64, 256, 4096, 64, 256)
    assert (p64.qt, p64.tiles, p64.threads, p64.splits, p64.nbuf) == (16, 4, 512, 1, 2)
    p1 = tadc.adc_plan(1, 256, 4096, 64, 256)
    assert (p1.qt, p1.nchunks, p1.nbuf) == (1, 1, 1) and p1.splits > 1


@pytest.mark.parametrize('nq,k,in_place', [(1, 256, True), (1, 1024, True), (1, 18, False),
                                           (2, 256, False), (64, 256, False)])
def test_table_read_in_place(nq, k, in_place):
    """At a query tile of 1 and K % 4 == 0 the table [Q, M, K] already is
    the core's interleaved [tiles, M, kp, QT]: no scratch, no interleave
    (one kernel launch fewer); otherwise scratch of tiles * M * kp * QT."""
    dtable = torch.zeros((nq, 8, k), dtype=torch.float32)
    plan = tadc.adc_plan(nq, 4, 4096, 8, k)
    tab, ptr = tadc._table_scratch(plan, dtable)
    assert (tab is None and ptr == 0) == in_place
    if not in_place:
        assert tab.numel() == plan.tiles * 8 * -(-k // 4) * 4 * plan.qt
    # a table that is not 16-byte aligned is interleaved all the same
    off = torch.zeros(nq * 8 * k + 1, dtype=torch.float32)[1:].view(nq, 8, k)
    assert tadc._table_scratch(plan, off)[0] is not None
