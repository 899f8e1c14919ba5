"""ADC scoring with an int8 table — the port of `annlite_tpu/ops/adc_i8.py`.

An experimental variant of `ops/adc.py` on no index path: its entry point is
:func:`adc_scores_i8`.  :func:`quantize_dtable` turns a float32 table into
int8 without reordering any query's scores: each (q, m) row is centred on
``mid = (min_k + max_k) / 2`` (the removed constants sum to a per-query
``offset``), and each query gets one symmetric scale ``max|centred| / 127``.
A score is then ``float(sum_m t8[q, m, code]) * scale[q] + offset[q]``; the
only error is the rounding of each table entry (at most scale / 2).

Kernel (``csrc/adc_i8.cu``, K9, planned by :func:`adc_i8_plan`): a tile of
1, 4 or 8 queries per CTA, whose int8 tables an interleave kernel lays out
biased to u8 as ``[tile][m][kp][QT]`` so one 4- or 8-byte shared read serves
the tile; four codes per load; sums in 16-bit lanes, two queries per add,
folded into 32-bit sums every 256 subspaces (exact, in any order); the
epilogue ``acc * scale + offset`` with one rounding after each operation; BIG
where the mask is 0.  Its plain version ``_adc_scores_i8_ref`` computes the
same, bit for bit.

Difference from the JAX package: off the TPU ``adc_scores_i8`` there skips
the quantization and returns the exact float32 scores of ``adc_scores_ref``.
Here the plain version computes what the TPU kernel computes (quantized
table, integer sum, scale and offset), so the CPU and the card give the same
scores, within the table's rounding of the exact ones.

XLA compiles the divisions by the constant 127 into a product with the
float32 reciprocal; the port does the same, so the int8 table and the scales
equal the JAX function's.  The offsets are summed over m in order 0..M-1;
XLA sums blocks of 32 subspaces, so above M = 32 an offset may differ from
the JAX function's in its last bit.
"""
import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..profile import count
from . import BIG, _ext
from .adc import _code_bytes, _mask_row, _round_up, _widen

# the codewords the wrapper takes (the limit of the first kernel, which held
# one subspace of one query's table in shared memory); the kernel stages only
# the codewords a code can name, 256 for u8 and 65,536 for u16 codes
MAX_I8_CLUSTERS = 232448
# shared memory a CUDA block may use (227 KB), and what an H100 SM gives its
# blocks (228 KB, 1 KB of it reserved per block)
MAX_SMEM = 232448
SM_SMEM = 233472
BAR_BYTES = 16                # the mbarrier after the table
# query tiles csrc/adc_i8.cu instantiates, and the CTAs per SM each is
# compiled for (its __launch_bounds__)
QUERY_TILES = (1, 4, 8)
CTAS_PER_SM = {1: 2, 4: 2, 8: 1}
THREADS = 512
ROWS_PER_THREAD = 4           # one 32-bit (u8) or 64-bit (u16) code load
TILE_ROWS = THREADS * ROWS_PER_THREAD
FLUSH = 256                   # subspaces a 16-bit lane sums exactly: 255 * 256 < 2^16
TARGET_SMS = 132


class AdcI8Plan(NamedTuple):
    """Launch of K9: ``tiles`` query tiles of ``qt`` queries (the last may
    hold fewer), each table ``[m][kp][qt]`` bytes (``kp``: the codewords a
    code can name, rounded up to 16); the table resident when one chunk of
    ``mc`` subspaces holds it (``nchunks == 1``), else streamed per 2048 rows;
    ``grid`` = ``ranges`` x ``tiles`` CTAs (the tile fastest) of
    ``rows_per_cta`` rows (the codes' row stride ``ld``, N rounded up to 4,
    cut in ranges)."""
    qt: int
    tiles: int
    kp: int
    mc: int
    nchunks: int
    ranges: int
    rows_per_cta: int
    grid: int
    smem: int


def adc_i8_plan(nq: int, n: int, m: int, k: int, code_bytes: int = 1,
                qt: Optional[int] = None) -> AdcI8Plan:
    """K9's launch for ``nq`` queries over ``n`` rows, ``m`` subspaces of
    ``k`` codewords.  Tiles are balanced (9 queries take two tiles of 8, 3
    one of 4, 1 one of 1) among the widths whose one subspace fits shared
    memory; ``qt`` forces a width (to time the others).  The table stays
    resident where the tile's whole table fits, else it streams in balanced
    chunks.  Row ranges fill one wave of the card's SMs at the CTAs per SM
    the width allows."""
    kp = _round_up(min(k, 256 if code_bytes == 1 else 65536), 16)
    fit = [t for t in QUERY_TILES if kp * t + BAR_BYTES <= MAX_SMEM]
    if qt is None:
        tiles = -(-nq // fit[-1])
        qt = next(t for t in fit if t * tiles >= nq)
    elif qt not in fit:
        raise ValueError(f'adc_i8_plan: no tile of {qt} queries at K = {k}')
    tiles = -(-nq // qt)
    per_m = kp * qt
    mc = min(m, (MAX_SMEM - BAR_BYTES) // per_m)
    nchunks = -(-m // mc)
    mc = -(-m // nchunks)
    smem = mc * per_m + BAR_BYTES
    per_sm = max(1, min(CTAS_PER_SM[qt], SM_SMEM // (smem + 1024)))
    ld = _round_up(n, 4)
    ranges = max(1, min(TARGET_SMS * per_sm // tiles, -(-ld // TILE_ROWS)))
    rows = _round_up(-(-ld // ranges), ROWS_PER_THREAD)
    ranges = -(-ld // rows)
    return AdcI8Plan(qt, tiles, kp, mc, nchunks, ranges, rows, ranges * tiles, smem)


def adc_i8_plan_ctas(plan: AdcI8Plan, nq: int, n: int) -> List[Tuple[range, range]]:
    """Each CTA's ``(rows, queries)`` in ``blockIdx`` order, as the kernel
    computes them (rows past N are computed and not stored)."""
    out = []
    for b in range(plan.grid):
        tile, rg = b % plan.tiles, b // plan.tiles
        lo = rg * plan.rows_per_cta
        out.append((range(lo, min(n, lo + plan.rows_per_cta)),
                    range(tile * plan.qt, min(nq, tile * plan.qt + plan.qt))))
    return out


def adc_i8_info(nq: int, n: int, m: int, k: int, code_bytes: int = 1) -> dict:
    """K9's plan at these shapes, the kernels one call launches (the
    interleave and the scores) and the registers and spilled bytes per
    thread of the scores kernel.  Builds the kernels; needs a card."""
    plan = adc_i8_plan(nq, n, m, k, code_bytes)
    out = (ctypes.c_int * 2)()
    _ext.check(_ext.library('adc_i8').annlite_adc_i8_info(code_bytes, plan.qt, out),
               'adc_i8_info')
    return {**plan._asdict(), 'kernel_launches': 2, 'registers': out[0],
            'spill_bytes': out[1]}


def quantize_dtable(dtable: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 ``[Q, M, K]`` -> (int8 table ``[Q, M, K]``, per-query scale
    ``[Q, 1]``, offset ``[Q, 1]``, the mids summed over m in order)."""
    dtable = dtable.float()
    mid = (torch.amin(dtable, dim=2, keepdim=True)
           + torch.amax(dtable, dim=2, keepdim=True)) * 0.5  # [Q, M, 1]
    centred = dtable - mid
    scale = torch.clamp_min(torch.amax(torch.abs(centred), dim=(1, 2)), 1e-30) * (1.0 / 127.0)
    t8 = torch.clamp(torch.round(centred / scale[:, None, None]), -127, 127).to(torch.int8)
    offset = torch.zeros(dtable.shape[0], dtype=torch.float32, device=dtable.device)
    for j in range(dtable.shape[1]):
        offset = offset + mid[:, j, 0]
    return t8, scale[:, None], offset[:, None]


def _adc_scores_i8_ref(t8, codes_t, mask, scale, offset):
    """Plain version of K9: ``t8 [Q, M, K]`` int8, ``codes_t [M, N]``,
    ``mask [N]`` int8, ``scale``/``offset`` float32 ``[Q]`` -> float32
    ``[Q, N]``."""
    codes = _widen(codes_t)
    q, m, _ = t8.shape
    acc = torch.zeros((q, codes.shape[1]), dtype=torch.int32, device=t8.device)
    for j in range(m):
        acc = acc + t8[:, j, :].to(torch.int32)[:, codes[j]]
    scores = acc.float() * scale[:, None] + offset[:, None]
    return torch.where(mask[None, :] > 0, scores, BIG)


def adc_i8_kernel(t8, codes_t, mask, scale, offset):
    """Launch ``adc_i8_scores`` (K9) -> float32 ``[Q, N]`` as
    :func:`_adc_scores_i8_ref`."""
    for t in (t8, codes_t, mask, scale, offset):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError('adc_scores_i8: expected contiguous CUDA tensors')
    q, m, k = t8.shape
    n = codes_t.shape[1] if codes_t.dim() == 2 else 0
    if (t8.dtype != torch.int8 or codes_t.dim() != 2 or codes_t.shape[0] != m
            or mask.dtype != torch.int8 or mask.shape != (n,) or n >= 2**31
            or scale.dtype != torch.float32 or offset.dtype != torch.float32
            or scale.shape != (q,) or offset.shape != (q,) or q > 65535):
        raise ValueError('adc_scores_i8: unsupported inputs')
    if k > MAX_I8_CLUSTERS:
        raise ValueError(f'adc_scores_i8: K = {k} codewords exceed the kernel limit '
                         f'K <= {MAX_I8_CLUSTERS}')
    out = torch.empty((q, n), dtype=torch.float32, device=t8.device)
    if q == 0 or n == 0:
        return out
    return _adc_i8_launch(adc_i8_plan(q, n, m, k, _code_bytes(codes_t)), t8, codes_t, mask,
                          scale, offset, out)


def _adc_i8_launch(plan: AdcI8Plan, t8, codes_t, mask, scale, offset, out):
    """K9 on ``plan``, into ``out``.  The kernel loads 4 rows of codes and
    mask at once: codes and mask of an N that is not a multiple of 4, or not
    8- and 4-byte aligned, are padded into an aligned copy first."""
    q, m, k = t8.shape
    n = codes_t.shape[1]
    cb = _code_bytes(codes_t)
    ld = _round_up(n, 4)
    if ld != n:
        codes_t = torch.nn.functional.pad(codes_t.view(torch.int8) if cb == 1
                                          else codes_t.view(torch.int16), (0, ld - n))
        mask = torch.nn.functional.pad(mask, (0, ld - n))
    if codes_t.data_ptr() % 8:
        codes_t = codes_t.clone()
    if mask.data_ptr() % 4:
        mask = mask.clone()
    tab = torch.empty(plan.tiles * m * plan.kp * plan.qt, dtype=torch.uint8, device=t8.device)
    args = (ctypes.c_int * 5)(plan.qt, plan.tiles, plan.kp, plan.mc, plan.rows_per_cta)
    lib = _ext.library('adc_i8')
    with torch.cuda.device(t8.device):
        _ext.check(lib.annlite_adc_i8_scores(
            t8.data_ptr(), codes_t.data_ptr(), mask.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), out.data_ptr(), tab.data_ptr(), q, m, k, n, ld, cb, args,
            _ext.stream_ptr(t8)), 'adc_scores_i8')
    count('launch.adc_scores_i8')
    return out


def adc_scores_i8(
    dtable: torch.Tensor,
    codes_t: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked ADC scores ``[Q, N]`` through an int8 table; the contract of
    `ops/adc.py` ``adc_scores`` (float32 ``dtable [Q, M, K]`` and transposed
    codes ``[M, N]`` in, float32 scores out, BIG where ``mask`` is 0).  The
    JAX function pads Q and N to its blocks; the kernel needs no padding."""
    t8, scale, offset = quantize_dtable(dtable)
    mask_row = _mask_row(mask, codes_t.shape[1], codes_t.device)
    if codes_t.device.type == 'cpu':
        return _adc_scores_i8_ref(t8, codes_t, mask_row, scale[:, 0], offset[:, 0])
    return adc_i8_kernel(t8.contiguous(), codes_t.contiguous(), mask_row,
                         scale[:, 0].contiguous(), offset[:, 0].contiguous())
