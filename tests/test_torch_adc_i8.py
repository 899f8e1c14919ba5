"""annlite_torch.ops.adc_i8 against annlite_tpu.ops.adc_i8.

The int8 table and scales must equal the JAX ``quantize_dtable``'s bit for
bit (XLA turns the divisions by 127 into products with the float32
reciprocal); the offsets within an ulp.  The scores are held against a
numpy emulation of the TPU kernel's integer arithmetic (the pattern of
tests/test_adc.py): the JAX package's own CPU path returns the exact float
scores instead, so against it the port is held within the table's rounding
(1% of the largest score, as the JAX package's test)."""
import numpy as np
import pytest
import torch

from annlite_torch.ops import adc as tadc
from annlite_torch.ops import adc_i8 as ti8
from annlite_tpu.ops import adc as jadc
from annlite_tpu.ops import adc_i8 as ji8

BIG = np.float32(3.4e38)


def _inputs(q, m, k, n, code_dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    dt = (np.abs(rng.normal(size=(q, m, k))) * 3).astype(np.float32)
    codes_t = rng.integers(0, k, (m, n)).astype(code_dtype)
    return dt, codes_t


@pytest.mark.parametrize('q,m,k', [(200, 16, 32), (5, 64, 256), (3, 8, 1024)])
def test_quantize_dtable_equals_jax(q, m, k):
    dt, _ = _inputs(q, m, k, 1)
    want = [np.asarray(a) for a in ji8.quantize_dtable(dt)]
    got = [a.numpy() for a in ti8.quantize_dtable(torch.from_numpy(dt))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the offsets: summed in order here, in blocks of 32 by XLA (rtol 1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    if m <= 32:
        np.testing.assert_array_equal(got[2], want[2])


def _emulate(dt, codes_t, mask):
    """The TPU kernel's arithmetic in numpy: int table, integer sum, then
    ``acc * scale + offset`` in float32 with a rounding after each step.
    (M <= 32 here, where both packages' offsets are equal.)"""
    t8, scale, offset = (np.asarray(a) for a in ji8.quantize_dtable(dt))
    acc = np.zeros((dt.shape[0], codes_t.shape[1]), np.int64)
    for j in range(dt.shape[1]):
        acc += t8[:, j, codes_t[j].astype(np.int64)]
    s = acc.astype(np.float32) * scale + offset
    return s if mask is None else np.where(mask[None, :] > 0, s, BIG)


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('code_dtype,k', [(np.uint8, 32), (np.uint16, 300)])
def test_scores_equal_integer_emulation(code_dtype, k, masked):
    q, m, n = 4, 16, 700
    dt, codes_t = _inputs(q, m, k, n, code_dtype)
    mask = (np.random.default_rng(1).random(n) < 0.6).astype(np.int8) if masked else None
    got = ti8.adc_scores_i8(torch.from_numpy(dt), torch.from_numpy(codes_t),
                            None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, _emulate(dt, codes_t, mask))
    # within the table's rounding of the exact scores, which the JAX
    # package's CPU path returns
    exact = np.asarray(ji8.adc_scores_i8(dt, codes_t, mask, use_pallas=False))
    keep = np.ones(n, bool) if mask is None else mask > 0
    np.testing.assert_array_equal(got[:, ~keep], exact[:, ~keep])
    assert np.abs(got[:, keep] - exact[:, keep]).max() / np.abs(exact[:, keep]).max() < 0.01
    np.testing.assert_allclose(exact, np.asarray(jadc.adc_scores(dt, codes_t, mask,
                                                                 use_pallas=False)))


def test_plain_version_takes_quantized_inputs():
    dt, codes_t = _inputs(3, 8, 16, 200)
    t8, scale, offset = ti8.quantize_dtable(torch.from_numpy(dt))
    mask = torch.ones(200, dtype=torch.int8)
    got = ti8._adc_scores_i8_ref(t8, torch.from_numpy(codes_t), mask, scale[:, 0], offset[:, 0])
    np.testing.assert_array_equal(got.numpy(), _emulate(dt, codes_t, None))


def test_kernel_wrappers_take_only_cuda_tensors():
    """On the CPU the public functions run the plain versions; the kernel
    wrappers themselves refuse CPU tensors instead of falling back."""
    dt, codes_t = _inputs(2, 8, 16, 64)
    t8, scale, offset = ti8.quantize_dtable(torch.from_numpy(dt))
    with pytest.raises(ValueError, match='CUDA'):
        ti8.adc_i8_kernel(t8, torch.from_numpy(codes_t), torch.ones(64, dtype=torch.int8),
                          scale[:, 0], offset[:, 0])
    ids = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA'):
        tadc.lut_pq_kernel(ids, torch.from_numpy(codes_t.T.copy()), torch.from_numpy(dt))


# ----------------------- K9's plan and packed sums -----------------------


@pytest.mark.parametrize('m,k,cb', [(64, 256, 1), (64, 1024, 2), (258, 256, 1),
                                    (64, 232448, 2), (1, 16, 1)])
@pytest.mark.parametrize('nq', [1, 3, 4, 5, 8, 9, 64, 65, 100])
def test_adc_i8_plan_covers_each_cell_once(nq, m, k, cb):
    """K9's CTAs cover every (query, row) exactly once (N % 4 != 0
    included); the tiles are balanced widths the kernel has, the table (one
    chunk or several) fits shared memory with its mbarrier, and the codewords
    a code can name are staged."""
    for n in (1, 5, 4097, 12293):
        plan = ti8.adc_i8_plan(nq, n, m, k, cb)
        assert plan.qt in ti8.QUERY_TILES
        assert (plan.tiles - 1) * plan.qt < nq <= plan.tiles * plan.qt
        assert plan.kp % 16 == 0 and plan.kp >= min(k, 256 if cb == 1 else 65536)
        assert plan.mc * plan.nchunks >= m > plan.mc * (plan.nchunks - 1)
        assert plan.smem == plan.mc * plan.kp * plan.qt + ti8.BAR_BYTES <= ti8.MAX_SMEM
        assert plan.rows_per_cta % 4 == 0 and plan.grid == plan.ranges * plan.tiles
        seen = np.zeros((nq, n), np.int32)
        for rows, queries in ti8.adc_i8_plan_ctas(plan, nq, n):
            seen[queries.start:queries.stop, rows.start:rows.stop] += 1
        assert (seen == 1).all(), (nq, n)


def test_adc_i8_plan_at_the_adc_shapes():
    """Q = 64, N = 2^20, M = 64, K = 256 u8: eight tiles of eight queries, the
    128 KB table resident, one CTA per SM in one wave; Q = 1 a tile of one."""
    plan = ti8.adc_i8_plan(64, 1 << 20, 64, 256)
    assert (plan.qt, plan.tiles, plan.nchunks) == (8, 8, 1)
    assert plan.smem == 64 * 256 * 8 + ti8.BAR_BYTES
    assert plan.grid <= ti8.TARGET_SMS and plan.grid == 128
    assert ti8.adc_i8_plan(1, 1 << 20, 64, 256).qt == 1


def _packed_model(t8, codes_t, mask, scale, offset, plan):
    """The kernel's arithmetic in numpy, on its plan: the tables biased to u8
    and interleaved [tile][m][kp][qt] (padded queries and codewords 0x80);
    per chunk of subspaces and per 256 subspaces within it, sums of each
    table word's even and odd bytes in 16-bit lanes of uint32 words (which
    wrap, as on the card), folded into 32-bit sums; 128 * M subtracted;
    float32 ``acc * scale``, then ``+ offset``; BIG where the mask is 0."""
    t8 = t8.numpy()
    codes = ti8._widen(codes_t).numpy()
    mask, scale, offset = mask.numpy(), scale.numpy(), offset.numpy()
    q, m, k = t8.shape
    n = codes.shape[1]
    qt, tiles = plan.qt, plan.tiles
    kr = min(k, 256 if codes_t.dtype == torch.uint8 else 65536)
    tab = np.full((tiles, m, plan.kp, qt), 0x80, np.uint8)
    for j in range(q):
        tab[j // qt, :, :kr, j % qt] = t8[j, :, :kr].view(np.uint8) ^ 0x80
    tot = np.zeros((tiles, n, qt), np.uint32)
    for c in range(plan.nchunks):
        m0 = c * plan.mc
        mcur = min(plan.mc, m - m0)
        for s0 in range(0, mcur, ti8.FLUSH):
            pk = np.zeros((tiles, n, max(1, qt // 2)), np.uint32)
            for mm in range(m0 + s0, m0 + min(mcur, s0 + ti8.FLUSH)):
                ent = tab[:, mm, codes[mm], :]  # [tiles, n, qt]
                if qt == 1:
                    tot[..., 0] += ent[..., 0]
                    continue
                b = ent.reshape(tiles, n, qt // 4, 4).astype(np.uint32)
                w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
                pk[..., 0::2] += w & np.uint32(0x00FF00FF)
                pk[..., 1::2] += (w >> np.uint32(8)) & np.uint32(0x00FF00FF)
            if qt > 1:
                lo, hi = pk & np.uint32(0xFFFF), pk >> np.uint32(16)
                tot[..., 0::4] += lo[..., 0::2]
                tot[..., 2::4] += hi[..., 0::2]
                tot[..., 1::4] += lo[..., 1::2]
                tot[..., 3::4] += hi[..., 1::2]
    acc = tot.transpose(0, 2, 1).reshape(tiles * qt, n)[:q].astype(np.int64) - 128 * m
    s = acc.astype(np.int32).astype(np.float32) * scale[:, None] + offset[:, None]
    return np.where(mask[None, :] > 0, s, BIG).astype(np.float32)


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('k,code_dtype', [(16, np.uint8), (256, np.uint8), (1024, np.uint8),
                                          (16, np.uint16), (1024, np.uint16)])
@pytest.mark.parametrize('m', [1, 64, 257, 258])
def test_packed_model_equals_plain_version(m, k, code_dtype, masked):
    """A plain model of K9's tiled, biased and packed accumulation, with its
    flush every 256 subspaces, equals ``_adc_scores_i8_ref`` bit for bit:
    tiles of 1, 4 and 8 queries with Q not a multiple of the tile, N % 4 !=
    0, a table of random entries and one saturated at +-127 (a 16-bit lane
    of 258 subspaces of 255 would overflow without the flush)."""
    rng = np.random.default_rng(m * 7 + k)
    n = 37
    codes_t = torch.from_numpy(rng.integers(0, min(k, 256 if code_dtype == np.uint8 else k),
                                            (m, n)).astype(code_dtype))
    mask = torch.from_numpy((rng.random(n) < (0.6 if masked else 2.0)).astype(np.int8))
    for q in (1, 3, 9):
        t8 = rng.integers(-127, 128, (q, m, k)).astype(np.int8)
        t8[0] = 127
        if q > 1:
            t8[1] = -127
        t8 = torch.from_numpy(t8)
        scale = torch.from_numpy((rng.random(q) * 0.01 + 1e-4).astype(np.float32))
        offset = torch.from_numpy(rng.normal(size=q).astype(np.float32))
        plan = ti8.adc_i8_plan(q, n, m, k, 1 if code_dtype == np.uint8 else 2)
        assert (q, plan.qt) in ((1, 1), (3, 4), (9, 8))
        want = ti8._adc_scores_i8_ref(t8, codes_t, mask, scale, offset).numpy()
        np.testing.assert_array_equal(_packed_model(t8, codes_t, mask, scale, offset, plan),
                                      want)
