"""Fused quantized scan + in-kernel candidate selection — the port of
`annlite_tpu/ops/fused_scan.py`.

The unfused first-pass scan (`ops/scan.py`) would materialize a ``[Q, N]``
float32 score matrix that the top-k reduction reads straight back.  The fused
scan keeps only each block's *bucketed top-2*: for every (query, lane)
bucket of the ``block_rows/128`` strided rows of a block of ``block_rows``
corpus rows, the best two scores and their global rows.  'lane8' selection
then keeps a sorted top-8 per (query, lane class) over all blocks, which
leaves 1024 candidates per query.

The corpus is int8 ``[N, D]`` with row scales, nibble-packed int4
``[N, D/2]`` with row scales (``packed_int4=True``), or bfloat16 ``[N, D]``.

Kernels (``csrc/fused_scan.cu``): the block pass (K2 of the JAX package, one
variant per corpus type: ``block_top2``, ``block_top2_int4``,
``block_top2_bf16``; wgmma products fed by TMA, the bucketed top-2 kept in
registers) and ``lane8_merge`` (the running top-8, the rest of K1; each
lane class's blocks walked as several ranges side by side and the ranges'
stacks merged in order).  The launch geometries are chosen here: the block
pass's query tiles, lane halves and group splits by
:func:`block_pass_plan`, the merge's ranges by :func:`lane8_merge_plan`.
Beside the kernels sit their plain
PyTorch versions (``_fused_scan_ref``, ``_fused_scan8_ref``), which hold
the JAX references' contract (`annlite_tpu/ops/fused_scan.py:269-322`):
for int8 and int4 the same scores bit for bit and the same rows; for bf16
the same up to the order of the float32 sums.  The wrappers take the plain
version for CPU tensors only; for CUDA tensors they launch the kernels or
raise.
"""
import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..enums import Metric
from ..math import dot_f32
from ..profile import count
from . import _ext

# the widest row the block passes take (their query tile then streams
# through shared memory beside the corpus instead of staying resident)
MAX_FUSED_DIM = 3072
# queries of a tile, by variant; more queries take several tiles.  The
# shapes measured fastest on an H100 at 2^20 x 768 (PERF.md, PR 5): int8
# takes tiles of 64 as two warpgroups of 32 on the same corpus stages (one
# warpgroup at N = 64 spills); int4, whose unpacked A fragments then spill
# too, and bf16, whose 64-query tile leaves one CTA per SM, take tiles of 32
QUERY_TILE = {'int8': 64, 'int4': 32, 'bf16': 32}
TILE_WIDTHS = (8, 16, 32)       # wgmma N of a warpgroup's share of a tile
HALVES = 2                      # lane halves: 64 rows, one warpgroup's M tile
TARGET_CTAS = 264               # two per SM of an H100 (132 SMs)
# lane8_merge: at most 16 block ranges (warps) per (query, 32-lane chunk),
# and as many as give 32 resident warps on each of the 132 SMs
MERGE_MAX_RANGES = 16
MERGE_TARGET_WARPS = 132 * 32


def int8_dot(q8: torch.Tensor, x8: torch.Tensor) -> torch.Tensor:
    """Exact ``q8 @ x8.T`` of int8 codes, as int32 ``[Q, N]``.

    PyTorch has no int8 x int8 -> int32 product for these shapes on every
    device (on the CPU ``matmul`` of int8 returns int8 and wraps).  A float32
    product of int8 values is exact while every partial sum stays below
    2^24, i.e. over at most 1040 dimensions (1040 * 127^2 < 2^24), so the
    product is taken in float32 (without TF32, :func:`dot_f32`) over chunks
    of 1024 dimensions and the chunks are summed in int32."""
    acc = None
    for lo in range(0, q8.shape[1], 1024):
        part = dot_f32(q8[:, lo:lo + 1024], x8[:, lo:lo + 1024]).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


# --------------------------------------------------------------------------
# Plain versions (CPU path, and the card's reference in chip_smoke.py)
# --------------------------------------------------------------------------


def _bucket_top2(sel, block_rows: int):
    """Per block of ``block_rows`` columns of ``sel [Q, N]`` and per lane
    (column mod 128), the best two of the block's ``block_rows/128`` groups:
    ``(s, r)`` float32/int32 ``[Q, N/block_rows*256]``, per block ``[mn1 (128
    lanes) | mn2 (128 lanes)]``.  Ties go to the lowest group; the second
    group is clamped to ``groups - 1``.  Shared by the fused scan and the ADC
    block passes (`ops/adc.py`, `ops/ivf.py`)."""
    nq, n = sel.shape
    nb = n // block_rows
    groups = block_rows // 128
    dev = sel.device
    s4 = sel.reshape(nq, nb, groups, 128)
    giota = torch.arange(groups, dtype=torch.int32, device=dev)[None, None, :, None]
    big_g = torch.tensor(groups, dtype=torch.int32, device=dev)
    mn1 = s4.amin(dim=2)
    g1 = torch.where(s4 <= mn1[:, :, None, :], giota, big_g).amin(dim=2)
    s4m = torch.where(giota == g1[:, :, None, :], float('inf'), s4)
    mn2 = s4m.amin(dim=2)
    g2 = torch.where(s4m <= mn2[:, :, None, :], giota, big_g).amin(dim=2)
    base = (torch.arange(nb, dtype=torch.int32, device=dev) * block_rows)[None, :, None]
    lane = torch.arange(128, dtype=torch.int32, device=dev)[None, None, :]
    r1 = base + g1 * 128 + lane
    r2 = base + torch.clamp_max(g2, groups - 1) * 128 + lane
    s = torch.cat([mn1, mn2], dim=-1).reshape(nq, nb * 256)
    r = torch.cat([r1, r2], dim=-1).reshape(nq, nb * 256)
    return s, r


def scan_dots(q, x, packed_int4: bool = False):
    """``q . x`` as float32 ``[Q, N]``: exact integer sums for int8 codes
    ``q`` against an int8 or packed int4 ``x``; a float32 product without
    TF32 for bf16 ``q`` and ``x`` (each bf16 product is exact in float32,
    so only the order of the sums can differ from the kernel's)."""
    if x.dtype == torch.bfloat16:
        return dot_f32(q.float(), x.float())
    if packed_int4:
        from .scan import unpack_int4

        d2 = x.shape[1]
        lo, hi = unpack_int4(x)
        return (int8_dot(q[:, :d2], lo) + int8_dot(q[:, d2:], hi)).float()
    return int8_dot(q, x).float()


def _fused_scan_ref(q, qsc, x, rs, bias, block_rows: int, coef: float,
                    packed_int4: bool = False):
    """Block pass: ``(s, r)`` float32/int32 ``[Q, N/block_rows*256]``; per
    block ``[mn1 (128 lanes) | mn2 (128 lanes)]``."""
    acc = scan_dots(q, x, packed_int4)
    sel = bias[None, :] + coef * ((acc * qsc[:, None]) * rs[None, :])
    return _bucket_top2(sel, block_rows)


def _fused_scan8_ref(q, qsc, x, rs, bias, block_rows: int, coef: float,
                     packed_int4: bool = False):
    """Deep select: the block pass, then :func:`_lane8_merge_ref`."""
    return _lane8_merge_ref(
        *_fused_scan_ref(q, qsc, x, rs, bias, block_rows, coef, packed_int4))


def _lane8_merge_ref(s, r):
    """The per-lane-class top-8 of a block pass's candidates (a stable sort:
    an earlier candidate wins a tie) -> ``[Q, 1024]`` with column
    ``128 * k + lane`` the k-th best."""
    nq, c = s.shape
    s3 = s.reshape(nq, c // 128, 128)
    r3 = r.reshape(nq, c // 128, 128)
    order = torch.argsort(s3, dim=1, stable=True)[:, :8]
    return (torch.gather(s3, 1, order).reshape(nq, 1024),
            torch.gather(r3, 1, order).reshape(nq, 1024))


def lane8_merge_plan(nq: int, nb: int) -> int:
    """The block ranges per lane class of ``lane8_merge`` over ``nb``
    blocks of ``nq`` queries: a CTA per (query, 32-lane chunk) holds one
    warp per range, as many as bring the grid to
    :data:`MERGE_TARGET_WARPS` warps, at most :data:`MERGE_MAX_RANGES` and
    at most ``nb`` (every range holds a block).  At Q = 64 that is 16 (256
    CTAs of 512 threads); at Q = 1 also 16, in 4 CTAs."""
    want = -(-MERGE_TARGET_WARPS // (4 * nq))
    return max(1, min(MERGE_MAX_RANGES, nb, want))


def lane8_merge_ranges(nb: int, ranges: int) -> List[range]:
    """The blocks of each range, in order: warp ``w`` walks
    ``[w * nb // ranges, (w + 1) * nb // ranges)``."""
    return [range(w * nb // ranges, (w + 1) * nb // ranges) for w in range(ranges)]


def _insert8(ss, rr, cs, cr):
    """The kernel's shifting insert of candidates ``(cs, cr) [...]`` into
    sorted stacks ``(ss, rr) [..., 8]`` with strict '<'."""
    take = (cs[..., None] < ss).int().cummax(dim=-1).values.bool()
    before = torch.cat([torch.zeros_like(take[..., :1]), take[..., :-1]], dim=-1)
    up_s = torch.cat([cs[..., None], ss[..., :-1]], dim=-1)
    up_r = torch.cat([cr[..., None], rr[..., :-1]], dim=-1)
    new_s = torch.where(before, up_s, cs[..., None].expand_as(ss))
    new_r = torch.where(before, up_r, cr[..., None].expand_as(rr))
    return torch.where(take, new_s, ss), torch.where(take, new_r, rr)


def _lane8_merge_split(s, r, ranges: int):
    """CPU twin of the ``lane8_merge`` kernel over ``ranges`` block ranges
    (:func:`lane8_merge_ranges`): each range's sequential walk, then the
    kernel's pairwise merges, the later range's stack inserted in order.
    Equal to :func:`_lane8_merge_ref` wherever each lane class has 8 finite
    candidates; where it has fewer, the stacks keep their (+inf, 0)
    fillers, as the kernel's."""
    nq, c = s.shape
    s3 = s.reshape(nq, c // 128, 128)
    r3 = r.reshape(nq, c // 128, 128)
    stacks = []
    for blocks in lane8_merge_ranges(c // 256, ranges):
        ss = torch.full((nq, 128, 8), float('inf'), dtype=s.dtype, device=s.device)
        rr = torch.zeros((nq, 128, 8), dtype=r.dtype, device=r.device)
        for i in range(2 * blocks.start, 2 * blocks.stop):
            ss, rr = _insert8(ss, rr, s3[:, i], r3[:, i])
        stacks.append((ss, rr))
    d = 1
    while d < ranges:
        for w in range(0, ranges - d, 2 * d):
            ss, rr = stacks[w]
            for k in range(8):
                ss, rr = _insert8(ss, rr, stacks[w + d][0][..., k], stacks[w + d][1][..., k])
            stacks[w] = (ss, rr)
        d *= 2
    ss, rr = stacks[0]
    return (ss.permute(0, 2, 1).reshape(nq, 1024), rr.permute(0, 2, 1).reshape(nq, 1024))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


class BlockPassPlan(NamedTuple):
    """Launch geometry of a block pass: ``tiles`` query tiles of ``qt``
    queries (the last may hold fewer), each held by ``nwg`` warpgroups of
    ``nt`` queries (the wgmma N) that share the corpus stages; ``splits``
    CTAs share the groups of one block's lane half."""
    tiles: int
    qt: int
    nt: int
    nwg: int
    splits: int


def block_pass_plan(nq: int, n: int, block_rows: int, variant: str = 'int8') -> BlockPassPlan:
    """Query tiles of at most ``QUERY_TILE[variant]`` queries, balanced (65
    int8 queries take two tiles of 33), each reading the corpus, through L2
    where they run side by side, rather than one tile of N = 128, whose
    state would not fit in registers.  A tile of up to 32 queries is one
    warpgroup padded to the wgmma N of 8, 16 or 32; an int8 tile of 33 to
    64, two warpgroups of 32.  Where the blocks give fewer than half of
    :data:`TARGET_CTAS` CTAs, each block's groups are split over CTAs (at
    least two groups each), and the kernel merges the splits' partial
    top-2s in order."""
    tiles = -(-nq // QUERY_TILE[variant])
    qt = -(-nq // tiles)
    nwg = 1 if qt <= TILE_WIDTHS[-1] else 2
    nt = next(w for w in TILE_WIDTHS if w * nwg >= qt)
    groups = block_rows // 128
    want = TARGET_CTAS // (n // block_rows * HALVES * tiles)
    splits = max(s for s in range(1, max(1, min(want, groups // 2)) + 1) if groups % s == 0)
    return BlockPassPlan(tiles, qt, nt, nwg, splits)


def block_pass_ctas(plan: BlockPassPlan, nq: int, n: int,
                    block_rows: int) -> List[Tuple[int, range, range, range]]:
    """The kernel's CTAs in ``blockIdx`` order (query tile fastest, then
    group split, lane half, row block), each as ``(block, lanes, groups,
    queries)``: the cells of the block pass it computes."""
    gps = block_rows // 128 // plan.splits
    return [(blk, range(h * 64, h * 64 + 64), range(s * gps, s * gps + gps),
             range(t * plan.qt, min(nq, t * plan.qt + plan.qt)))
            for blk in range(n // block_rows) for h in range(HALVES)
            for s in range(plan.splits) for t in range(plan.tiles)]


def _check_cuda(*ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f'expected CUDA tensors, got one on {t.device}')
        if not t.is_contiguous():
            raise ValueError('expected contiguous tensors')


def _unsupported(q, qsc, x, rs, bias, block_rows, q_dtype, x_dtype, x_width):
    """Why the block pass cannot take these inputs, or None."""
    nq, d = q.shape
    n = x.shape[0]
    if q.dtype != q_dtype or x.dtype != x_dtype:
        return f'expected {q_dtype} queries and a {x_dtype} corpus'
    if x.shape[1] != x_width or nq == 0:
        return f'a corpus row of {x_width} values and at least one query expected'
    if (d * q.element_size()) % 128 or (x_width * x.element_size()) % 128:
        return 'query and corpus rows must be whole 128-byte TMA boxes'
    if d > MAX_FUSED_DIM:
        return f'D = {d} > {MAX_FUSED_DIM}'
    if block_rows % 128 or n == 0 or n % block_rows or block_rows // 128 > 0xFFFF:
        return (f'N = {n} must be a multiple of block_rows = {block_rows}, itself '
                'a multiple of 128 of at most 65535 groups')
    if n >= 2**31:
        return 'N must be below 2^31'
    if (qsc.dtype, rs.dtype, bias.dtype) != (torch.float32,) * 3 or (
            qsc.shape != (nq,) or rs.shape != (n,) or bias.shape != (n,)):
        return 'qsc [Q], rs [N] and bias [N] must be float32'
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        return 'queries and corpus must be 16-byte aligned'
    return None


def _launch_block_pass(entry: str, variant: str, q, qsc, x, rs, bias, block_rows: int,
                       coef: float, q_dtype, x_dtype, x_width: int):
    _check_cuda(q, qsc, x, rs, bias)
    reason = _unsupported(q, qsc, x, rs, bias, block_rows, q_dtype, x_dtype, x_width)
    if reason:
        raise ValueError(f'{entry}: unsupported inputs: {reason}')
    nq, d = q.shape
    n = x.shape[0]
    nb = n // block_rows
    plan = block_pass_plan(nq, n, block_rows, variant)
    s = torch.empty((nq, nb * 256), dtype=torch.float32, device=x.device)
    r = torch.empty((nq, nb * 256), dtype=torch.int32, device=x.device)
    parts = (None, None)
    if plan.splits > 1:  # the splits' partial top-2s and their groups
        ps = torch.empty((plan.splits, nq, nb * 256), dtype=torch.float32, device=x.device)
        pg = torch.empty((plan.splits, nq, nb * 256), dtype=torch.int32, device=x.device)
        parts = (ps.data_ptr(), pg.data_ptr())
    lib = _ext.library('fused_scan')
    with torch.cuda.device(x.device):
        _ext.check(getattr(lib, f'annlite_{entry}')(
            q.data_ptr(), qsc.data_ptr(), x.data_ptr(), rs.data_ptr(),
            bias.data_ptr(), s.data_ptr(), r.data_ptr(), *parts, nq, n, d, block_rows,
            plan.qt, plan.nt, plan.nwg, plan.splits, coef, _ext.stream_ptr(x)), entry)
    return s, r


def block_pass_info(variant: str, nq: int, n: int, d: int, block_rows: int = 8192) -> dict:
    """How the block pass of ``variant`` ('int8', 'int4', 'bf16') runs at
    these shapes on the card: its plan, grid, registers and spilled bytes
    per thread, shared memory per CTA, ring stages and whether the query
    tile stays resident.  Builds the kernels; needs a card."""
    plan = block_pass_plan(nq, n, block_rows, variant)
    out = (ctypes.c_int * 5)()
    _ext.check(_ext.library('fused_scan').annlite_block_pass_info(
        ('int8', 'int4', 'bf16').index(variant), plan.nt, plan.nwg, d, out), 'block_pass_info')
    return {**plan._asdict(), 'grid': len(block_pass_ctas(plan, nq, n, block_rows)),
            'registers': out[0], 'spill_bytes': out[1], 'smem_bytes': out[2],
            'stages': out[3], 'query_tile_resident': bool(out[4])}


def block_top2(q, qsc, x, rs, bias, block_rows: int, coef: float,
               packed_int4: bool = False):
    """Launch the block pass (K2 / K1's block pass) that matches the corpus
    -> ``(s, r)`` as :func:`_fused_scan_ref`: ``block_top2`` for int8 codes
    ``x [N, D]``, :func:`block_top2_int4` for ``packed_int4``,
    :func:`block_top2_bf16` for a bf16 ``x``.  Each counts its launches
    in the tracer's ``launch.<name>`` (`profile.py`)."""
    if packed_int4:
        return block_top2_int4(q, qsc, x, rs, bias, block_rows, coef)
    if x.dtype == torch.bfloat16:
        return block_top2_bf16(q, qsc, x, rs, bias, block_rows, coef)
    out = _launch_block_pass('block_top2', 'int8', q, qsc, x, rs, bias, block_rows, coef,
                             torch.int8, torch.int8, q.shape[1])
    count('launch.block_top2')
    return out


def block_top2_int4(q8, qsc, x4, rs, bias, block_rows: int, coef: float):
    """The int4 block pass: int8 query codes ``q8 [Q, D]`` against the
    nibble-packed corpus ``x4 [N, D/2]``."""
    out = _launch_block_pass('block_top2_int4', 'int4', q8, qsc, x4, rs, bias, block_rows,
                             coef, torch.int8, torch.int8, q8.shape[1] // 2)
    count('launch.block_top2_int4')
    return out


def block_top2_bf16(qbf, qsc, xbf, rs, bias, block_rows: int, coef: float):
    """The bf16 block pass: bf16 queries ``qbf [Q, D]`` against the bf16
    corpus ``xbf [N, D]`` (``qsc`` and ``rs`` are ones on the scan path)."""
    out = _launch_block_pass('block_top2_bf16', 'bf16', qbf, qsc, xbf, rs, bias, block_rows,
                             coef, torch.bfloat16, torch.bfloat16, qbf.shape[1])
    count('launch.block_top2_bf16')
    return out


def lane8_merge(s, r):
    """Launch ``lane8_merge`` (K1's running top-8) over a block pass's
    ``[Q, nb*256]`` candidates -> ``[Q, 1024]``, the blocks walked in
    :func:`lane8_merge_plan`'s ranges."""
    _check_cuda(s, r)
    nq, c = s.shape
    if (s.dtype != torch.float32 or r.dtype != torch.int32 or r.shape != s.shape
            or c % 256):
        raise ValueError('lane8_merge: unsupported inputs')
    s8 = torch.empty((nq, 1024), dtype=torch.float32, device=s.device)
    r8 = torch.empty((nq, 1024), dtype=torch.int32, device=s.device)
    lib = _ext.library('fused_scan')
    with torch.cuda.device(s.device):
        _ext.check(lib.annlite_lane8_merge(
            s.data_ptr(), r.data_ptr(), s8.data_ptr(), r8.data_ptr(), nq,
            c // 256, lane8_merge_plan(nq, c // 256), _ext.stream_ptr(s)), 'lane8_merge')
    count('launch.lane8_merge')
    return s8, r8


def _fused_scan(q, qsc, x, rs, bias, block_rows, coef, select, packed_int4):
    if x.device.type == 'cpu':
        ref = _fused_scan8_ref if select == 'lane8' else _fused_scan_ref
        return ref(q, qsc, x, rs, bias, block_rows, coef, packed_int4)
    s, r = block_top2(q, qsc, x, rs, bias, block_rows, coef, packed_int4)
    if select == 'lane8':
        return lane8_merge(s, r)
    return s, r


# --------------------------------------------------------------------------
# Public wrapper
# --------------------------------------------------------------------------


def supports_fused_scan(n: int, d: int, q: int, block_rows: int = 8192,
                        packed_int4: bool = False) -> bool:
    """The fused kernel requires lane-aligned geometry; callers use the
    unfused scan otherwise.  ``d`` is the LOGICAL dim (the packed int4 store
    holds d/2 bytes per row, which must itself be lane-aligned).  The JAX
    rule, plus the kernels' dimension limit (:data:`MAX_FUSED_DIM`)."""
    d_store = d // 2 if packed_int4 else d
    return (
        n % block_rows == 0
        and d % 128 == 0
        and d_store % 128 == 0
        and d <= MAX_FUSED_DIM
        and q <= 128
        and n // block_rows >= 1
    )


def fused_scan_candidates(
    q: torch.Tensor,
    x_scan: torch.Tensor,
    row_scale: Optional[torch.Tensor],
    bias: torch.Tensor,
    metric_val: int,
    *,
    block_rows: int = 8192,
    packed_int4: bool = False,
    select: str = 'block2',
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan ``x_scan`` (int8 ``[N, D]`` with ``row_scale``, bf16, or
    nibble-packed int4 ``[N, D/2]`` with ``packed_int4=True``) against
    float32 queries ``q [Q, D]``; returns ``(scores[Q, C], rows[Q, C])``,
    scores finalized to the values the unfused scan produces (BIG-or-more for
    masked rows).

    ``select``: 'block2' emits the bucketed top-2 per block
    (C = N/block_rows*256); 'lane8' keeps a running top-8 per lane class
    (C = 1024, requires N >= 4*block_rows).

    ``bias`` is float32 [N]: ``BIG*(1-mask)`` for IP/cosine, ``norms_sq +
    BIG*(1-mask)`` for L2.  The |q|^2 term of L2 is added here, outside the
    kernel.  The JAX function pads Q to a multiple of 8; the port does not
    need to."""
    from .scan import quantize_rows_int8_device

    if x_scan.dtype not in (torch.int8, torch.bfloat16) or (
            packed_int4 and x_scan.dtype != torch.int8):
        raise ValueError(f'unsupported scan corpus: {x_scan.dtype}'
                         f'{" (packed int4)" if packed_int4 else ""}')
    n = x_scan.shape[0]
    if n % block_rows != 0:
        raise ValueError(
            f'fused scan requires N % {block_rows} == 0 (got N={n}); the '
            'library pads corpus buffers to chunk multiples (see '
            'index/buffer.py) — callers with odd N must use the unfused scan'
        )
    if select not in ('block2', 'lane8'):
        raise ValueError(f'unknown select: {select!r}')
    if select == 'lane8' and n < 4 * block_rows:
        raise ValueError('lane8 selection requires N >= 4*block_rows')
    if x_scan.dtype == torch.int8:
        qs, qsc = quantize_rows_int8_device(q)
        rs = row_scale
    else:  # bf16: the queries rounded to bf16, no scales
        qs = q.to(torch.bfloat16)
        qsc = torch.ones((q.shape[0],), dtype=torch.float32, device=q.device)
        rs = None
    if rs is None:
        rs = torch.ones((n,), dtype=torch.float32, device=x_scan.device)
    coef = -2.0 if metric_val == int(Metric.EUCLIDEAN) else -1.0
    s, r = _fused_scan(qs, qsc, x_scan, rs, bias, block_rows, coef, select,
                       packed_int4)
    if metric_val == int(Metric.EUCLIDEAN):
        s = s + torch.sum(q * q, dim=1)[:, None]
    else:
        s = s + 1.0
    return s, r
