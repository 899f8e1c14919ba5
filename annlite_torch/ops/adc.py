"""ADC (asymmetric distance computation) scoring — the port of
`annlite_tpu/ops/adc.py`.

A query keeps an exact table ``dtable[q, m, c]`` of distances from its m-th
sub-vector to every codeword c, and a stored row with PQ codes
``codes_t[:, n]`` (transposed ``[M, N]``, so the N axis is contiguous) scores
``sum_m dtable[q, m, codes_t[m, n]]``.  The filter/delete predicate is a
per-row int8 mask fused into the scan (BIG where it is 0).

Kernels (``csrc/adc.cu``): ``adc_scores`` (K5, the full ``[Q, N]`` scores)
and ``adc_block_top2`` (K4's block pass: per block of ``block_n`` rows the
bucketed top-2 of `ops/fused_scan.py`), which ``lane8_merge`` finishes into a
running top-8 per lane class.  Both run on one lookup core with the IVF
kernels of `ops/ivf.py` where its plan gives them the core; its launch
geometry (query tile, row blocks per CTA,
group splits, table chunks) is chosen here, :func:`adc_plan`.  Beside each
kernel sits its plain PyTorch version (``_adc_scores_ref``,
``_adc_block_top2_ref``), which sums over m in order 0..M-1 in float32 as the
kernels do: scores and rows are bit-equal.  The TPU kernels' one-hot products
with a bf16 table are not carried over; the port computes what the JAX
references (``adc_scores_ref``) compute, in float32.

The graph's PQ traversal scores each query's own candidates instead
(``adc_scores_per_query``, ``lut_pq_scores``): K8 (``csrc/lut_pq.cu``)
gathers each candidate's row of the row-major codes ``[N, M]`` and sums its
table entries, in order 0..M-1 as ``adc_scores_per_query_ref`` does.

The wrappers take the plain version for CPU tensors only; for CUDA tensors
they launch the kernels or raise.
"""
import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..profile import count
from . import BIG, _ext
from .fused_scan import _bucket_top2, _lane8_merge_ref, lane8_merge
from .topk import topk

# shared memory a CUDA block may use (227 KB); the lookup core keeps 64 bytes
# of it for the mbarriers and counters of its table ring
MAX_SMEM = 232448
RING_BYTES = MAX_SMEM - 64
# one subspace of one query's float32 table (K rounded up to 4, a 16-byte
# multiple for the bulk copy) must fit the ring: the kernels tile the table
# over subspaces
MAX_ADC_CLUSTERS = RING_BYTES // 4
# query tiles of the lookup core (csrc/adc.cu instantiates these); a thread
# holds two queries of a tile (one of QT = 1)
QUERY_TILES = (1, 2, 4, 8, 16)
MAX_QUERY_TILE = QUERY_TILES[-1]
LANES_PER_THREAD = 4            # one 32-bit (u8) or 64-bit (u16) code load
MAX_THREADS = 512
# one CTA on each of an H100's 132 SMs: the plan splits each block's groups
# over CTAs until the grid would outgrow one such wave
TARGET_CTAS = 132
# buffers of the table ring when the table streams
NBUF = 2
# rows per block of the deep select at K <= 256 (its bucketed top-2 is taken
# per block, so this sets the candidates, as in the JAX package)
BLOCK_N = 4096


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _scale_blocks(k: int) -> int:
    """The deep select's block of rows for ``k`` codewords: ``BLOCK_N``,
    shrunk for K > 256 (u16 codes) as the JAX package shrinks it."""
    if k <= 256:
        return BLOCK_N
    return max(512, BLOCK_N // -(-k // 256))


def _code_bytes(codes: torch.Tensor) -> int:
    if codes.dtype == torch.uint8:
        return 1
    if codes.dtype == torch.uint16:
        return 2
    raise ValueError(f'ADC kernels take uint8 or uint16 codes, got {codes.dtype}')


def supports_adc(k: int) -> bool:
    """Whether the kernels take ``k`` codewords per subspace."""
    return 1 <= k <= MAX_ADC_CLUSTERS


# --------------------------------------------------------------------------
# Plain versions (CPU path, and the card's reference in chip_smoke.py)
# --------------------------------------------------------------------------


def adc_scores_ref(dtable: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """``dtable [Q, M, K] x codes_t [M, N] -> [Q, N]`` float32, summed over m
    in order 0..M-1 (the kernels' order).  Codes are widened to int64 first:
    PyTorch's uint16 is a storage type without arithmetic or indexing."""
    codes = codes_t.to(torch.int32).long()
    q, m, _ = dtable.shape
    acc = torch.zeros((q, codes.shape[1]), dtype=torch.float32, device=dtable.device)
    for j in range(m):
        acc = acc + dtable[:, j, :].float()[:, codes[j]]
    return acc


def _masked(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return scores
    return torch.where(mask[None, :] > 0, scores,
                       torch.tensor(BIG, dtype=torch.float32, device=scores.device))


def _adc_scores_ref(dtable, codes_t, mask):
    """Plain version of ``adc_scores``: BIG where ``mask`` is 0."""
    return _masked(adc_scores_ref(dtable, codes_t), mask)


def _adc_block_top2_ref(dtable, codes_t, mask, block_n: int):
    """Plain version of ``adc_block_top2``: ``(s, r)`` float32/int32
    ``[Q, N/block_n*256]`` (see `ops/fused_scan.py` ``_bucket_top2``)."""
    return _bucket_top2(_adc_scores_ref(dtable, codes_t, mask), block_n)


def _widen(codes: torch.Tensor) -> torch.Tensor:
    """Codes as int64 for indexing; uint16 goes through an int16 view (the
    same bits), which PyTorch can gather where it cannot gather uint16."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).long() & 0xFFFF
    return codes.long()


def adc_scores_per_query_ref(dtable: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``dtable [Q, M, K] x codes [Q, C, M] -> [Q, C]`` float32, summed over
    m in order 0..M-1 (K8's order)."""
    c = _widen(codes)
    q, m, _ = dtable.shape
    acc = torch.zeros(c.shape[:2], dtype=torch.float32, device=dtable.device)
    for j in range(m):
        acc = acc + torch.gather(dtable[:, j, :].float(), 1, c[:, :, j])
    return acc


def _lut_pq_scores_ref(ids, codes, dtable):
    """Plain version of ``lut_pq_scores``: the codes of rows ``ids [Q, C]``
    of ``codes [N, M]`` scored against ``dtable [Q, M, K]``; BIG where an id
    lies outside ``[0, N)``."""
    n = codes.shape[0]
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, 0).long()
    if codes.dtype == torch.uint16:  # gathered through the int16 view
        rows = codes.view(torch.int16)[safe].long() & 0xFFFF
    else:
        rows = codes[safe].long()  # [Q, C, M]
    return torch.where(valid, adc_scores_per_query_ref(dtable, rows), BIG)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


class AdcPlan(NamedTuple):
    """Launch geometry of the lookup core: ``tiles`` query tiles of ``qt``
    queries (the last may hold fewer); CTAs of ``threads`` threads that hold
    ``nbc`` row blocks; ``splits`` CTAs share the groups of one row block; the
    tile's interleaved table streams through ``nbuf`` shared-memory buffers of
    ``mc`` subspaces (resident when ``nchunks <= nbuf``)."""
    qt: int
    tiles: int
    nbc: int
    splits: int
    mc: int
    nbuf: int
    nchunks: int
    threads: int
    grid: int
    smem: int


def _threads_per_block(qt: int) -> int:
    """Threads that hold one row block's 128 lanes for a tile of ``qt``
    queries: 32 lane quads times the threads that share one (two queries
    each, one at QT = 1)."""
    return 32 * max(1, qt // 2)


@functools.lru_cache(maxsize=1024)
def adc_plan(nq: int, n_rb: int, bn: int, m: int, k: int) -> AdcPlan:
    """The lookup core's launch for ``nq`` queries over ``n_rb`` row blocks of
    ``bn`` rows, ``m`` subspaces of ``k`` codewords.

    Query tiles of at most :data:`MAX_QUERY_TILE` queries, balanced (17
    queries take two tiles of 16, the sizes being :data:`QUERY_TILES`), as
    wide as the
    table allows: two buffers of one subspace each must fit the ring (QT = 1
    needs one).  A CTA holds as many row blocks as 512 threads allow; while
    the grid stays within one wave of :data:`TARGET_CTAS`, each block's
    groups are split over twice as many CTAs (a power of two that divides the
    groups), and the kernel's merge inserts the splits' partial top-2s in
    order.  The table stays resident where the tile's whole table fits the
    ring, else it streams through :data:`NBUF` buffers of ``mc`` subspaces
    (fewer where a subspace fills the ring)."""
    groups = bn // 128
    kp = _round_up(k, 4)
    fit = [t for t in QUERY_TILES if t == 1 or 2 * kp * t * 4 <= RING_BYTES]
    if not fit or kp * 4 > RING_BYTES:
        raise ValueError(f'K = {k} codewords exceed the kernel limit K <= {MAX_ADC_CLUSTERS}')
    tiles = -(-nq // fit[-1])
    qt = next(t for t in fit if t * tiles >= nq)
    per_block = _threads_per_block(qt)
    nbc = max(1, min(MAX_THREADS // per_block, n_rb))
    nrbg = -(-n_rb // nbc)
    splits = 1
    while (tiles * nrbg * splits * 2 <= TARGET_CTAS and groups % (2 * splits) == 0):
        splits *= 2
    per_m = kp * qt * 4
    if m * per_m <= RING_BYTES:
        mc, nbuf = m, 1
    else:
        nbuf = NBUF
        while nbuf > 1 and nbuf * per_m > RING_BYTES:
            nbuf -= 1
        nchunks = -(-m // (RING_BYTES // (nbuf * per_m)))
        mc = -(-m // nchunks)
    nchunks = -(-m // mc)
    nbuf = min(nbuf, nchunks)
    return AdcPlan(qt, tiles, nbc, splits, mc, nbuf, nchunks, per_block * nbc,
                   tiles * splits * nrbg, nbuf * mc * per_m + 64)


def adc_plan_ctas(plan: AdcPlan, nq: int, n_rb: int,
                  groups: int) -> List[Tuple[int, range, range]]:
    """The kernel's CTAs in ``blockIdx`` order (row-block group fastest,
    then group split, then query tile), each as
    ``(first row block, groups, queries)``; :func:`adc_plan_threads` gives the
    cells of its threads."""
    gps = groups // plan.splits
    nrbg = plan.grid // (plan.tiles * plan.splits)
    return [(c * plan.nbc, range(s * gps, s * gps + gps),
             range(t * plan.qt, min(nq, t * plan.qt + plan.qt)))
            for t in range(plan.tiles) for s in range(plan.splits) for c in range(nrbg)]


def adc_plan_threads(plan: AdcPlan) -> List[Tuple[int, range, range]]:
    """Each thread of a CTA, in ``threadIdx`` order, as the kernel computes
    it: ``(row block within the CTA, lanes, queries within the tile)``."""
    tq = max(1, plan.qt // 2)
    qpt = plan.qt // tq
    out = []
    for t in range(plan.threads):
        lq = t // tq
        lane0 = (lq % 32) * LANES_PER_THREAD
        q0 = (t % tq) * qpt
        out.append((lq // 32, range(lane0, lane0 + LANES_PER_THREAD), range(q0, q0 + qpt)))
    return out


_EPILOGUES = {'adc_scores': 0, 'adc_block_top2': 1, 'ivf_scores': 2, 'ivf_block_top2': 3}


def adc_info(entry: str, nq: int, n_rb: int, bn: int, m: int, k: int,
             code_bytes: int = 1) -> dict:
    """How ``entry`` ('adc_scores', 'adc_block_top2', and 'ivf_scores' or
    'ivf_block_top2' where `ops/ivf.py` ``ivf_plan`` gives them the core)
    runs at these shapes on the card: its plan, the
    kernels one call launches (the table interleave unless the core reads
    the table in place, the core, and the splits' merge of a top-2 entry),
    and the registers and spilled bytes per thread of its instantiation.
    Builds the kernels; needs a card."""
    plan = adc_plan(nq, n_rb, bn, m, k)
    out = (ctypes.c_int * 2)()
    _ext.check(_ext.library('adc').annlite_adc_info(
        code_bytes, _EPILOGUES[entry], plan.qt, out), 'adc_info')
    launches = 1 + int(not _in_place(plan, k)) + int(entry.endswith('top2') and plan.splits > 1)
    return {**plan._asdict(), 'kernel_launches': launches, 'registers': out[0],
            'spill_bytes': out[1]}


@functools.lru_cache(maxsize=1024)
def _plan_args(plan: AdcPlan):
    return (ctypes.c_int * 6)(plan.qt, plan.tiles, plan.nbc, plan.splits, plan.mc, plan.nbuf)


def _in_place(plan: AdcPlan, k: int, dtable: Optional[torch.Tensor] = None) -> bool:
    """Whether the core reads ``dtable [Q, M, K]`` as its table: at QT = 1
    with K % 4 == 0 it already is the interleaved ``[tiles, m, kp, 1]``
    (given the bulk copy's 16-byte alignment), so nothing is interleaved."""
    return plan.qt == 1 and k % 4 == 0 and (dtable is None or dtable.data_ptr() % 16 == 0)


def _table_scratch(plan: AdcPlan, dtable: torch.Tensor):
    """Room for the interleaved tables ``[tiles, m, kp, qt]`` and its
    pointer; ``(None, 0)`` (a null table) where the core reads ``dtable`` in
    place."""
    _, m, k = dtable.shape
    if _in_place(plan, k, dtable):
        return None, 0
    tab = torch.empty(plan.tiles * m * _round_up(k, 4) * plan.qt, dtype=torch.float32,
                      device=dtable.device)
    return tab, tab.data_ptr()


def _split_parts(plan: AdcPlan, q: int, width: int, device):
    """The splits' partial top-2s and their groups (null without splits)."""
    if plan.splits == 1:
        return None, None, (0, 0)
    ps = torch.empty((plan.splits, q, width), dtype=torch.float32, device=device)
    pg = torch.empty((plan.splits, q, width), dtype=torch.int32, device=device)
    return ps, pg, (ps.data_ptr(), pg.data_ptr())


def _check(what, dtable, codes_t, mask):
    for t in (dtable, codes_t, mask):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f'{what}: expected contiguous CUDA tensors')
    q, m, k = dtable.shape
    if (dtable.dtype != torch.float32 or codes_t.dim() != 2 or codes_t.shape[0] != m
            or mask.dtype != torch.int8 or mask.shape != (codes_t.shape[1],)
            or codes_t.shape[1] >= 2**31 - 4 or q == 0):
        raise ValueError(f'{what}: unsupported inputs')
    if not supports_adc(k):
        raise ValueError(f'{what}: K = {k} codewords exceed the kernel limit '
                         f'K <= {MAX_ADC_CLUSTERS}')
    if codes_t.data_ptr() % 8 or mask.data_ptr() % 4:
        raise ValueError(f'{what}: codes must be 8-byte and the mask 4-byte aligned '
                         '(the kernel loads 4 rows at once)')
    return q, m, k, codes_t.shape[1], _code_bytes(codes_t)


def adc_scores_kernel(dtable, codes_t, mask):
    """Launch ``adc_scores`` (K5) -> float32 ``[Q, N]``, BIG where ``mask``
    is 0.  Codes and mask of an N that is not a multiple of 4 are padded to
    one (the kernel reads 4 rows per load and writes only the N)."""
    q, m, k, n, cb = _check('adc_scores', dtable, codes_t, mask)
    ld = _round_up(n, 4)
    if ld != n:
        codes_t = torch.nn.functional.pad(codes_t.view(torch.int8) if cb == 1
                                          else codes_t.view(torch.int16), (0, ld - n))
        mask = torch.nn.functional.pad(mask, (0, ld - n))
    plan = adc_plan(q, -(-n // BLOCK_N), BLOCK_N, m, k)
    out = torch.empty((q, n), dtype=torch.float32, device=dtable.device)
    tab, tab_ptr = _table_scratch(plan, dtable)
    lib = _ext.library('adc')
    with torch.cuda.device(dtable.device):
        _ext.check(lib.annlite_adc_scores(
            dtable.data_ptr(), codes_t.data_ptr(), mask.data_ptr(), out.data_ptr(),
            tab_ptr, q, m, k, n, ld, cb, _plan_args(plan), _ext.stream_ptr(dtable)),
            'adc_scores')
    count('launch.adc_scores')
    return out


def adc_block_top2(dtable, codes_t, mask, block_n: int):
    """Launch ``adc_block_top2`` (K4's block pass) -> ``(s, r)`` as
    :func:`_adc_block_top2_ref`."""
    q, m, k, n, cb = _check('adc_block_top2', dtable, codes_t, mask)
    if block_n % 128 or n % block_n or n < block_n or block_n // 128 > 0xFFFF:
        raise ValueError('adc_block_top2: N must be a multiple of block_n, '
                         'itself a multiple of 128 of at most 65535 groups')
    nb = n // block_n
    plan = adc_plan(q, nb, block_n, m, k)
    s = torch.empty((q, nb * 256), dtype=torch.float32, device=dtable.device)
    r = torch.empty((q, nb * 256), dtype=torch.int32, device=dtable.device)
    ps, pg, parts = _split_parts(plan, q, nb * 256, dtable.device)
    tab, tab_ptr = _table_scratch(plan, dtable)
    lib = _ext.library('adc')
    with torch.cuda.device(dtable.device):
        _ext.check(lib.annlite_adc_block_top2(
            dtable.data_ptr(), codes_t.data_ptr(), mask.data_ptr(), s.data_ptr(),
            r.data_ptr(), *parts, tab_ptr, q, m, k, n, n, block_n, cb,
            _plan_args(plan), _ext.stream_ptr(dtable)), 'adc_block_top2')
    count('launch.adc_block_top2')
    return s, r


def lut_pq_kernel(ids, codes, dtable):
    """Launch ``lut_pq_scores`` (K8, `csrc/lut_pq.cu`) -> float32 ``[Q, C]``
    as :func:`_lut_pq_scores_ref`."""
    for t in (ids, codes, dtable):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError('lut_pq_scores: expected contiguous CUDA tensors')
    q, m, k = dtable.shape
    if (ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[0] != q
            or dtable.dtype != torch.float32 or codes.dim() != 2 or codes.shape[1] != m
            or codes.shape[0] >= 2**31):
        raise ValueError('lut_pq_scores: unsupported inputs')
    if not supports_adc(k):
        raise ValueError(f'lut_pq_scores: K = {k} codewords exceed the kernel limit '
                         f'K <= {MAX_ADC_CLUSTERS}')
    c = ids.shape[1]
    out = torch.empty((q, c), dtype=torch.float32, device=dtable.device)
    if q == 0 or c == 0:
        return out
    lib = _ext.library('lut_pq')
    with torch.cuda.device(dtable.device):
        _ext.check(lib.annlite_lut_pq_scores(
            ids.data_ptr(), codes.data_ptr(), dtable.data_ptr(), out.data_ptr(),
            q, c, codes.shape[0], m, k, _code_bytes(codes), _ext.stream_ptr(dtable)),
            'lut_pq_scores')
    count('launch.lut_pq_scores')
    return out


def lut_pq_scores(ids: torch.Tensor, codes: torch.Tensor, dtable: torch.Tensor) -> torch.Tensor:
    """The graph's PQ scorer (`ops/beam.py` ``make_pq_scorer``): rows ``ids
    [Q, C]`` of ``codes [N, M]`` (row-major) against ``dtable [Q, M, K]`` ->
    float32 ``[Q, C]``, BIG where an id lies outside ``[0, N)``.  K8 fuses
    the row gather and the mask that the TPU did outside its kernel."""
    if codes.device.type == 'cpu':
        return _lut_pq_scores_ref(ids, codes, dtable)
    return lut_pq_kernel(ids.to(torch.int32).contiguous(), codes.contiguous(),
                         dtable.float().contiguous())


def adc_scores_per_query(dtable: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scores of per-query candidate codes: ``dtable [Q, M, K] x codes
    [Q, C, M]`` (uint8 or uint16) -> float32 ``[Q, C]``.  On the card K8
    runs over ``codes`` viewed as ``[Q*C, M]`` rows with ``ids = q*C + c``;
    the JAX function pads C to 128, the kernel needs no padding."""
    if codes.device.type == 'cpu':
        return adc_scores_per_query_ref(dtable, codes)
    q, c, m = codes.shape
    ids = torch.arange(q * c, dtype=torch.int32, device=codes.device).view(q, c)
    return lut_pq_scores(ids, codes.reshape(q * c, m), dtable)


def _mask_row(mask: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    if mask is None:
        return torch.ones((n,), dtype=torch.int8, device=device)
    return mask.to(device=device, dtype=torch.int8).contiguous()


def _adc_select8(dtable, codes_t, mask, block_n: int):
    """K4: block pass + running top-8 per lane class -> ``[Q, 1024]``."""
    if codes_t.device.type == 'cpu':
        return _lane8_merge_ref(*_adc_block_top2_ref(dtable, codes_t, mask, block_n))
    return lane8_merge(*adc_block_top2(dtable.float().contiguous(),
                                       codes_t.contiguous(), mask, block_n))


# --------------------------------------------------------------------------
# Public functions
# --------------------------------------------------------------------------


def adc_scores(
    dtable: torch.Tensor,
    codes_t: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked ADC scores ``[Q, N]`` from ``dtable [Q, M, K]`` and transposed
    codes ``[M, N]`` (mask-failing rows score BIG).  The JAX function pads Q
    and N to its blocks; the kernel needs no padding."""
    if codes_t.device.type == 'cpu':
        return _adc_scores_ref(dtable, codes_t, mask)
    n = codes_t.shape[1]
    return adc_scores_kernel(dtable.float().contiguous(), codes_t.contiguous(),
                             _mask_row(mask, n, codes_t.device))


def adc_topk(
    dtable: torch.Tensor,
    codes_t: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    *,
    exact: bool = False,
    deep: Optional[bool] = None,
):
    """Score + top-k: ``(dists [Q, k], rows [Q, k] int32)`` ascending.

    The JAX package's dispatch: the deep select (K4, ``[Q, 1024]``
    candidates) when ``not exact and k <= 1024 and N % block_n == 0 and
    N >= 4 * block_n`` (``block_n`` from :func:`_scale_blocks`), otherwise
    the full scores (K5) and an exact top-k.  ``deep=None`` takes the deep select for a CUDA corpus, as the JAX package
    takes it on the TPU (``use_pallas``); ``deep=True`` runs its plain
    version on the CPU.  The final top-k keeps ``lax.top_k``'s tie rule
    (lower index first: a stable sort)."""
    n = codes_t.shape[1]
    block_n = _scale_blocks(dtable.shape[2])
    if deep is None:
        deep = codes_t.is_cuda
    if deep and not exact and k <= 1024 and n % block_n == 0 and n >= 4 * block_n:
        s, r = _adc_select8(dtable, codes_t, _mask_row(mask, n, codes_t.device),
                            block_n)
        d, pos = topk(s, min(k, 1024))
        return d, torch.gather(r, 1, pos)
    d, pos = topk(adc_scores(dtable, codes_t, mask), k)
    return d, pos.to(torch.int32)
