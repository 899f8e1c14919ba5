"""Block-gathered IVF scan — the port of `annlite_tpu/ops/ivf.py`.

Codes are stored in fixed-size blocks, each owned by one IVF cell
(:class:`BlockedCodes`), and a search scores ONLY the blocks of the probed
cells: their ids arrive as a device array (``-1`` pads a selection) and each
CTA of the kernel reads the blocks it is given.  Candidates are (selection,
slot) pairs mapped back to global rows through the store's row map.

Kernels (``csrc/ivf.cu``, planned by :func:`ivf_plan`): ``ivf_scores`` (K7:
``[S, Q, BS]`` scores, the slot mask applied outside), for one or two
queries a latency-bound body of two slots a thread, above that the lookup
core of `ops/adc.py`; and ``ivf_block_top2`` (K6's block pass: the slot mask
and pad selections as BIG biases, bucketed top-2 with provenance
``j * BS + slot``), which ``lane8_merge`` finishes into a running top-8 per
lane class: one launch over one CTA per SM, or the lookup core where the
plan expects that faster (many selections, whose grid fills the card).  Beside each sits its plain
PyTorch version (``_ivf_scores_ref``, ``_ivf_block_top2_ref``), bit-equal to
it.  The wrappers take the plain version for CPU tensors only; for CUDA
tensors they launch the kernels or raise.
"""
import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..profile import count
from . import BIG, _ext
from .adc import (MAX_ADC_CLUSTERS, MAX_SMEM, TARGET_CTAS, AdcPlan, _code_bytes, _plan_args,
                  _round_up, _split_parts, _table_scratch, adc_info, adc_plan, adc_scores_ref,
                  supports_adc)
from .fused_scan import _bucket_top2, _lane8_merge_ref, lane8_merge
from .topk import topk

BLOCK_SIZE = 1024  # rows per block (lane-aligned)


# --------------------------------------------------------------------------
# Plain versions (CPU path, and the card's reference in chip_smoke.py)
# --------------------------------------------------------------------------


def _ivf_scores_ref(block_ids, dtable, codes_blocks):
    """Plain version of ``ivf_scores``: ``[S, Q, BS]`` raw scores of the
    blocks ``max(block_ids, 0)``, summed over m in order."""
    safe = torch.clamp_min(block_ids.long(), 0)
    codes = codes_blocks.to(torch.int32)[safe]  # [S, M, BS]
    s, m, bs = codes.shape
    flat = codes.permute(1, 0, 2).reshape(m, s * bs)  # [M, S*BS]
    acc = adc_scores_ref(dtable, flat)  # [Q, S*BS]
    return acc.reshape(-1, s, bs).transpose(0, 1)


def _ivf_keep(block_ids, mask_blocks):
    """``[S, BS]``: alive slots of real (non-pad) selections."""
    safe = torch.clamp_min(block_ids.long(), 0)
    return (mask_blocks[safe] > 0) & (block_ids >= 0)[:, None]


def _ivf_scan_ref(block_ids, dtable, codes_blocks, mask_blocks):
    """``[Q, S, BS]`` scores, BIG outside the slot mask and on pads."""
    scores = _ivf_scores_ref(block_ids, dtable, codes_blocks).transpose(0, 1)
    big = torch.tensor(BIG, dtype=torch.float32, device=scores.device)
    return torch.where(_ivf_keep(block_ids, mask_blocks)[None], scores, big)


def _ivf_block_top2_ref(block_ids, dtable, codes_blocks, mask_blocks):
    """Plain version of ``ivf_block_top2``: ``(acc + slot bias) + pad bias``
    in that order, then the bucketed top-2 of each selected block ->
    ``(s, r)`` ``[Q, S*256]`` with ``r = j * BS + slot``."""
    acc = _ivf_scores_ref(block_ids, dtable, codes_blocks).transpose(0, 1)  # [Q, S, BS]
    safe = torch.clamp_min(block_ids.long(), 0)
    zero = torch.tensor(0.0, dtype=torch.float32, device=acc.device)
    big = torch.tensor(BIG, dtype=torch.float32, device=acc.device)
    bias = torch.where(mask_blocks[safe] > 0, zero, big)  # [S, BS]
    pad = torch.where(block_ids >= 0, zero, big)  # [S]
    sel = (acc + bias[None]) + pad[None, :, None]
    q, s, bs = sel.shape
    return _bucket_top2(sel.reshape(q, s * bs), bs)


# --------------------------------------------------------------------------
# Launch plans
# --------------------------------------------------------------------------

# K7's own body (csrc/ivf.cu ivf_rows_kernel) takes at most this many
# queries; above it the lookup core of csrc/adc.cu scores the blocks
ROWS_MAX_QUERIES = 2
ROWS_PER_CTA = 64          # one warp of two slots a thread
ROWS_CHUNK_M = 64          # subspaces per table chunk when K7 stages its table
ROWS_MAX_CHUNKS = 16       # the kernel's mbarriers
# whether K7 stages its table in shared memory (else it reads it through
# L1/L2); chosen by the card's times (PERF.md)
ROWS_SMEM_TABLE = True
# K6's own body (csrc/ivf.cu ivf_top2_kernel) against the lookup core:
# milliseconds = fixed + per lookup, fitted to their times on an NVIDIA H100
# 80GB HBM3 at 700 W (scripts/ivf_probe.py: Q 8 to 64 over 139 and 256
# selections of 1,024 slots, M = 64, K = 256).  The core's lookups count
# its padded query tiles over the share of its last wave's SMs it fills: its
# tiles of 16 read the table with fewer bank conflicts than the own body's
# tiles of 2, but few selections leave its grid short of the card.
K6_OWN_MS = (0.0199, 4.71e-10)
K6_CORE_MS = (0.0313, 2.93e-10)
TOP2_THREADS = 512         # K6: 16 warps, a work unit each per round
TOP2_WARPS = TOP2_THREADS // 32
TOP2_MAX_TILE = 2          # queries per K6 work unit (one 8-byte table read)


class IvfPlan(NamedTuple):
    """Launch of an IVF kernel.  ``kernel``: ``'rows'`` (K7's body: ``grid``
    CTAs of one warp, two slots a thread, all ``qt`` = Q queries),
    ``'core'`` (the lookup core of `ops/adc.py` under ``core``), or
    ``'top2'`` (K6: ``units`` = tiles x selections x groups work units of one
    warp, query tiles of ``qt``, ``cpt`` CTAs a tile over equal ranges of its
    units, ``grid`` = tiles x cpt).  ``smem_tab``: the table staged in shared
    memory (K7 in chunks of ``mc`` subspaces), else read through L1/L2."""
    kernel: str
    qt: int
    tiles: int
    units: int
    grid: int
    threads: int
    smem: int
    smem_tab: bool
    mc: int
    cpt: int
    core: Optional[AdcPlan]


def _core_plan(nq: int, n_sel: int, bs: int, m: int, k: int) -> IvfPlan:
    """The lookup core's launch (:func:`~.adc.adc_plan`) as an IVF plan."""
    core = adc_plan(nq, n_sel, bs, m, k)
    return IvfPlan('core', core.qt, core.tiles, 0, core.grid, core.threads, core.smem, True,
                   core.mc, 0, core)


def _rows_plan(nq: int, n_sel: int, bs: int, m: int, k: int,
               smem_tab: bool = ROWS_SMEM_TABLE) -> IvfPlan:
    """K7's own body: one CTA per 64 slots; the table staged in shared memory
    (``smem_tab``) where it fits, in chunks of ``mc`` subspaces."""
    tab = nq * m * k * 4 + ROWS_MAX_CHUNKS * 8  # the table, then its mbarriers
    smem = smem_tab and k % 4 == 0 and tab <= MAX_SMEM
    mc = max(ROWS_CHUNK_M, -(-m // ROWS_MAX_CHUNKS))
    return IvfPlan('rows', nq, 1, 0, n_sel * (bs // ROWS_PER_CTA), 32, tab if smem else 0,
                   smem, mc, 0, None)


def _top2_plan(nq: int, n_sel: int, bs: int, m: int, k: int, ctas: int,
               smem_tab: bool = True, qt: Optional[int] = None) -> IvfPlan:
    """K6's own body: query tiles of ``qt`` (2, or 1 for one query),
    ``ctas // tiles`` CTAs a tile (at least one, at most one per work unit),
    so the grid is one CTA per SM up to a remainder; each tile's interleaved
    table resident in shared memory (``smem_tab``) where it fits beside a
    round's scores, else read through L2."""
    qt = qt or min(nq, TOP2_MAX_TILE)
    tiles = -(-nq // qt)
    per_tile = n_sel * (bs // 128)
    cpt = max(1, min(per_tile, ctas // tiles))
    scores = TOP2_WARPS * qt * 128 * 4 + 16  # a round's scores, then the flags
    tab = _round_up(m * k * qt, 4) * 4
    smem = smem_tab and tab + scores <= MAX_SMEM
    return IvfPlan('top2', qt, tiles, tiles * per_tile, tiles * cpt, TOP2_THREADS,
                   (tab if smem else 0) + scores, smem, 0, cpt, None)


@functools.lru_cache(maxsize=1024)
def ivf_plan(entry: str, nq: int, n_sel: int, bs: int, m: int, k: int,
             ctas: int = TARGET_CTAS) -> IvfPlan:
    """The launch of ``entry`` ('ivf_scores' or 'ivf_block_top2') for ``nq``
    queries over ``n_sel`` selected blocks of ``bs`` slots, ``m`` subspaces of
    ``k`` codewords, on a card of ``ctas`` SMs.  K7 up to
    :data:`ROWS_MAX_QUERIES` queries takes its own body, above them the
    lookup core; K6 takes whichever of its own body and the core
    :data:`K6_OWN_MS` and :data:`K6_CORE_MS` expect to be faster."""
    if entry == 'ivf_scores':
        if nq > ROWS_MAX_QUERIES:
            return _core_plan(nq, n_sel, bs, m, k)
        return _rows_plan(nq, n_sel, bs, m, k)
    if entry != 'ivf_block_top2':
        raise ValueError(f'ivf_plan: unknown entry {entry!r}')
    own, core = _top2_plan(nq, n_sel, bs, m, k, ctas), _core_plan(nq, n_sel, bs, m, k)
    lookups = n_sel * bs * m
    waves = -(-core.grid // ctas)
    own_ms = K6_OWN_MS[0] + K6_OWN_MS[1] * nq * lookups
    core_ms = K6_CORE_MS[0] + K6_CORE_MS[1] * core.tiles * core.qt * lookups * (
        waves * ctas / core.grid)
    return own if own_ms <= core_ms else core


def _unit_lo(plan: IvfPlan, ci: int) -> int:
    """The first work unit, within its query tile, of the tile's K6 CTA
    ``ci`` (the kernel's ``unit_lo``)."""
    return ci * (plan.units // plan.tiles) // plan.cpt


def ivf_plan_ctas(plan: IvfPlan, nq: int, n_sel: int,
                  bs: int) -> List[List[Tuple[int, range, range]]]:
    """The cells each CTA of a 'rows' or 'top2' plan computes, in
    ``blockIdx`` order: a list of ``(selection, slots, queries)``.  A K6 CTA
    lists its work units (one group of 128 slots each) in the order it runs
    them."""
    if plan.kernel == 'rows':
        per = bs // ROWS_PER_CTA
        return [[(c // per, range(c % per * ROWS_PER_CTA, c % per * ROWS_PER_CTA + ROWS_PER_CTA),
                  range(nq))] for c in range(plan.grid)]
    groups = bs // 128
    out = []
    for c in range(plan.grid):
        tile, ci = divmod(c, plan.cpt)
        qs = range(tile * plan.qt, min(nq, tile * plan.qt + plan.qt))
        out.append([(u // groups, range(u % groups * 128, u % groups * 128 + 128), qs)
                    for u in range(_unit_lo(plan, ci), _unit_lo(plan, ci + 1))])
    return out


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# K6's counters per (card, stream): zero between calls (the kernel's last
# CTA on a selection sets its counter back to 0)
_COUNTERS = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def ivf_info(entry: str, nq: int, n_sel: int, bs: int, m: int, k: int,
             code_bytes: int = 1) -> dict:
    """How ``entry`` ('ivf_scores', 'ivf_block_top2') runs at these shapes on
    the card: its plan, the kernels one call launches, the grid, and the
    registers and spilled bytes per thread of its instantiation.  Builds the
    kernels; needs a card."""
    plan = ivf_plan(entry, nq, n_sel, bs, m, k, _sm_count(torch.cuda.current_device()))
    if plan.kernel == 'core':
        return {'kernel': 'core', **adc_info(entry, nq, n_sel, bs, m, k, code_bytes)}
    out = (ctypes.c_int * 2)()
    _ext.check(_ext.library('ivf').annlite_ivf_info(
        int(plan.kernel == 'top2'), code_bytes, plan.qt, int(plan.smem_tab), out), 'ivf_info')
    info = plan._asdict()
    del info['core']
    return {**info, 'kernel_launches': 1, 'registers': out[0], 'spill_bytes': out[1]}


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check(what, block_ids, dtable, codes_blocks, *more):
    for t in (block_ids, dtable, codes_blocks) + more:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f'{what}: expected contiguous CUDA tensors')
    q, m, k = dtable.shape
    if (dtable.dtype != torch.float32 or block_ids.dtype != torch.int32
            or block_ids.dim() != 1 or codes_blocks.dim() != 3
            or codes_blocks.shape[1] != m or codes_blocks.shape[2] % 128):
        raise ValueError(f'{what}: unsupported inputs')
    if not supports_adc(k):
        raise ValueError(f'{what}: K = {k} codewords exceed the kernel limit '
                         f'K <= {MAX_ADC_CLUSTERS}')
    if q == 0 or block_ids.shape[0] == 0 or codes_blocks.data_ptr() % 8:
        raise ValueError(f'{what}: at least one query and one selection, and 8-byte '
                         'aligned codes (the kernel loads 4 slots at once), expected')
    if block_ids.shape[0] * codes_blocks.shape[2] >= 2**31:
        raise ValueError(f'{what}: selections x block size must stay below 2^31')
    return q, m, k, block_ids.shape[0], codes_blocks.shape[2], _code_bytes(codes_blocks)


def _aligned(dtable: torch.Tensor) -> torch.Tensor:
    """``dtable`` at a 16-byte address (the bulk copies' and float4 loads')."""
    return dtable if dtable.data_ptr() % 16 == 0 else dtable.clone()


def ivf_scores(block_ids, dtable, codes_blocks, plan: Optional[IvfPlan] = None):
    """Launch ``ivf_scores`` (K7) -> float32 ``[S, Q, BS]``; ``plan``
    overrides :func:`ivf_plan`'s (a measurement aid)."""
    q, m, k, s, bs, cb = _check('ivf_scores', block_ids, dtable, codes_blocks)
    plan = plan or ivf_plan('ivf_scores', q, s, bs, m, k)
    out = torch.empty((s, q, bs), dtype=torch.float32, device=dtable.device)
    with torch.cuda.device(dtable.device):
        if plan.kernel == 'core':
            tab, tab_ptr = _table_scratch(plan.core, dtable)
            _ext.check(_ext.library('adc').annlite_ivf_scores(
                block_ids.data_ptr(), dtable.data_ptr(), codes_blocks.data_ptr(),
                out.data_ptr(), tab_ptr, s, q, m, k, bs, cb, _plan_args(plan.core),
                _ext.stream_ptr(dtable)), 'ivf_scores')
        else:
            dtable = _aligned(dtable)
            _ext.check(_ext.library('ivf').annlite_ivf_rows(
                block_ids.data_ptr(), dtable.data_ptr(), codes_blocks.data_ptr(),
                out.data_ptr(), s, q, m, k, bs, cb, int(plan.smem_tab), plan.mc,
                _ext.stream_ptr(dtable)), 'ivf_scores')
    count('launch.ivf_scores')
    return out


def ivf_block_top2(block_ids, dtable, codes_blocks, mask_blocks,
                   plan: Optional[IvfPlan] = None):
    """Launch ``ivf_block_top2`` (K6's block pass) -> ``(s, r)`` as
    :func:`_ivf_block_top2_ref`, in one launch; ``plan`` overrides
    :func:`ivf_plan`'s (a measurement aid)."""
    q, m, k, s, bs, cb = _check('ivf_block_top2', block_ids, dtable, codes_blocks,
                                mask_blocks)
    if mask_blocks.dtype != torch.int8 or mask_blocks.shape != (codes_blocks.shape[0], bs):
        raise ValueError('ivf_block_top2: unsupported mask')
    dev = dtable.device
    plan = plan or ivf_plan('ivf_block_top2', q, s, bs, m, k, _sm_count(dev.index))
    so = torch.empty((q, s * 256), dtype=torch.float32, device=dev)
    ro = torch.empty((q, s * 256), dtype=torch.int32, device=dev)
    if plan.kernel == 'core':
        ps, pg, parts = _split_parts(plan.core, q, s * 256, dev)
        tab, tab_ptr = _table_scratch(plan.core, dtable)
        with torch.cuda.device(dev):
            _ext.check(_ext.library('adc').annlite_ivf_block_top2(
                block_ids.data_ptr(), dtable.data_ptr(), codes_blocks.data_ptr(),
                mask_blocks.data_ptr(), so.data_ptr(), ro.data_ptr(), *parts, tab_ptr,
                s, q, m, k, bs, cb, _plan_args(plan.core), _ext.stream_ptr(dtable)),
                'ivf_block_top2')
        count('launch.ivf_block_top2')
        return so, ro
    part_s = torch.empty((plan.grid, 2, plan.qt, 256), dtype=torch.float32, device=dev)
    part_g = torch.empty((plan.grid, 2, plan.qt, 256), dtype=torch.int32, device=dev)
    dtable = _aligned(dtable)
    with torch.cuda.device(dev):
        counters = _counters(dev, plan.tiles * s)
        _ext.check(_ext.library('ivf').annlite_ivf_top2(
            block_ids.data_ptr(), dtable.data_ptr(), codes_blocks.data_ptr(),
            mask_blocks.data_ptr(), so.data_ptr(), ro.data_ptr(), part_s.data_ptr(),
            part_g.data_ptr(), counters.data_ptr(), s, q, m, k, bs, cb, plan.qt,
            int(plan.smem_tab), plan.cpt, _ext.stream_ptr(dtable)), 'ivf_block_top2')
    count('launch.ivf_block_top2')
    return so, ro


# --------------------------------------------------------------------------
# Public functions
# --------------------------------------------------------------------------


def ivf_scan_topk(
    block_ids: torch.Tensor,
    dtable: torch.Tensor,
    codes_blocks: torch.Tensor,
    mask_blocks: torch.Tensor,
    row_map: torch.Tensor,
    k: int,
    *,
    return_addr: bool = False,
    deep: Optional[bool] = None,
) -> Tuple[torch.Tensor, ...]:
    """Scan the selected blocks and return ``(dists [Q, k], global_rows
    [Q, k])``; with ``return_addr`` also the candidates' ``(blocks, slots)``.

    block_ids [S] int32 (pad -1, else < n_blocks: the kernels read the
    blocks they name); codes_blocks [n_blocks, M, BS] uint8/16;
    mask_blocks [n_blocks, BS] int8; row_map [n_blocks, BS] int32.  The JAX
    package's dispatch: the deep select (K6) when ``S >= 16 and k <= 1024
    and BS % 128 == 0``, else the full scores (K7) and an exact top-k.
    ``deep=None`` takes the deep select for CUDA tensors; ``deep=True`` runs
    its plain version on the CPU.  The JAX function's ``exact`` switch has no
    counterpart: both of its top-k branches are exact here (`ops/topk.py`)."""
    n_sel = block_ids.shape[0]
    bs = codes_blocks.shape[2]
    block_ids = block_ids.to(torch.int32).contiguous()
    safe = torch.clamp_min(block_ids.long(), 0)
    if deep is None:
        deep = codes_blocks.is_cuda
    if deep and n_sel >= 16 and k <= 1024 and bs % 128 == 0:
        if codes_blocks.device.type == 'cpu':
            s8, r8 = _lane8_merge_ref(*_ivf_block_top2_ref(
                block_ids, dtable, codes_blocks, mask_blocks))
        else:
            s8, r8 = lane8_merge(*ivf_block_top2(
                block_ids, dtable.float().contiguous(), codes_blocks.contiguous(),
                mask_blocks.contiguous()))
        d, pos8 = topk(s8, min(k, 1024))
        prov = torch.gather(r8, 1, pos8).long()
        sel_block = safe[prov // bs]
        slot = prov % bs
        rows = row_map[sel_block, slot]
        if return_addr:
            return d, rows, sel_block, slot
        return d, rows
    if codes_blocks.device.type == 'cpu':
        scores = _ivf_scan_ref(block_ids, dtable, codes_blocks, mask_blocks)
    else:
        raw = ivf_scores(block_ids, dtable.float().contiguous(), codes_blocks.contiguous())
        # the slot mask applied outside the kernel, as the JAX package does; a
        # scalar fill, so the host queues the top-k without waiting for K7
        scores = raw.masked_fill(~_ivf_keep(block_ids, mask_blocks)[:, None],
                                 BIG).transpose(0, 1)
    q = scores.shape[0]
    d, pos = topk(scores.reshape(q, n_sel * bs), min(k, n_sel * bs))
    sel_block = safe[pos // bs]
    slot = pos % bs
    rows = row_map[sel_block, slot]
    if return_addr:
        return d, rows, sel_block, slot
    return d, rows


def slot_mask_device(mb: torch.Tensor, rm: torch.Tensor, row_pred: torch.Tensor):
    """AND the device-resident slot mask ``mb [n_blocks, BS]`` with a
    per-global-row predicate ``row_pred [N] int8``, gathered through the
    device-resident ``row_map``: a filtered search uploads only the N-byte
    predicate.  Empty slots (row_map < 0) already have ``mb == 0``, so the
    clamped gather there is ANDed away."""
    safe = torch.clamp(rm.long(), 0, row_pred.shape[0] - 1)
    return mb & row_pred[safe].to(mb.dtype)


class BlockedCodes:
    """Host-side blocked code store (numpy, a copy of the JAX package's):
    rows grouped by cell into fixed blocks, each cell filling its last
    partial block before it opens a new one; :meth:`device_arrays` mirrors
    codes, slot mask and row map on ``device`` (``None`` means the card).
    """

    def __init__(self, n_subvectors: int, block_size: int = BLOCK_SIZE,
                 code_dtype=np.uint8,
                 device: Optional[Union[str, torch.device]] = None):
        self.m = n_subvectors
        self.bs = block_size
        # u8/u16/u32 per the codec's n_clusters — a u8-only buffer would
        # silently wrap codes mod 256 at n_clusters > 256
        self.code_dtype = np.dtype(code_dtype)
        self.device = resolve_device(device)
        self.codes = np.zeros((0, self.m, self.bs), dtype=self.code_dtype)
        self.mask = np.zeros((0, self.bs), dtype=np.int8)
        self.row_map = np.full((0, self.bs), -1, dtype=np.int32)
        self.block_cell = np.zeros(0, dtype=np.int32)
        self._cell_tail = {}  # cell -> (block_idx, fill)
        # global row -> (block, slot), or a LIST of addrs when the row is
        # soft-assigned into several cells (multi=True)
        self._row_addr = {}
        self.multi = False  # any row stored in >1 cell (soft assignment)
        self._dirty = True
        self._dev = None

    @property
    def n_blocks(self) -> int:
        return self.codes.shape[0]

    def _grow(self, n_new: int):
        self.codes = np.concatenate(
            [self.codes, np.zeros((n_new, self.m, self.bs), self.code_dtype)]
        )
        self.mask = np.concatenate([self.mask, np.zeros((n_new, self.bs), np.int8)])
        self.row_map = np.concatenate(
            [self.row_map, np.full((n_new, self.bs), -1, np.int32)]
        )
        self.block_cell = np.concatenate(
            [self.block_cell, np.zeros(n_new, np.int32)]
        )

    def append(self, codes: np.ndarray, cells: np.ndarray, rows: np.ndarray):
        """codes [n, M]; cells [n]; rows [n] global row ids.

        Vectorized bulk ingest: rows are grouped by cell (stable, preserving
        input order within a cell), each cell fills its tail block then any
        number of freshly allocated blocks; all block storage is grown in ONE
        reallocation."""
        codes = np.asarray(codes)
        if codes.dtype.itemsize > self.code_dtype.itemsize:
            raise ValueError(
                f'codes dtype {codes.dtype} would be truncated by this '
                f'{self.code_dtype} store — construct BlockedCodes with the '
                f'codec\'s code_dtype'
            )
        codes = codes.astype(self.code_dtype)
        cells = np.asarray(cells).astype(np.int64).ravel()
        rows = np.asarray(rows).astype(np.int64).ravel()
        n = len(rows)
        if n == 0:
            return
        order = np.argsort(cells, kind='stable')
        uniq, starts = np.unique(cells[order], return_index=True)
        counts = np.diff(np.append(starts, n))

        # one reallocation for all new blocks
        need_new = 0
        for cell, cnt in zip(uniq.tolist(), counts.tolist()):
            _, fill = self._cell_tail.get(cell, (None, self.bs))
            rem = cnt - min(self.bs - fill, cnt)
            need_new += -(-rem // self.bs)
        next_block = self.n_blocks
        if need_new:
            self._grow(need_new)

        for cell, s0, cnt in zip(uniq.tolist(), starts.tolist(), counts.tolist()):
            seg = order[s0:s0 + cnt]
            seg_codes, seg_rows = codes[seg], rows[seg]
            pos = 0
            b, fill = self._cell_tail.get(cell, (None, self.bs))
            while pos < cnt:
                if fill >= self.bs:
                    b, fill = next_block, 0
                    self.block_cell[b] = cell
                    next_block += 1
                take = min(self.bs - fill, cnt - pos)
                sl = slice(fill, fill + take)
                self.codes[b, :, sl] = seg_codes[pos:pos + take].T
                self.mask[b, sl] = 1
                self.row_map[b, sl] = seg_rows[pos:pos + take]
                if not self.multi:
                    self._row_addr.update(
                        zip(
                            seg_rows[pos:pos + take].tolist(),
                            ((b, s) for s in range(fill, fill + take)),
                        )
                    )
                else:  # duplicate-aware (soft assignment): keep EVERY addr
                    for r, s in zip(seg_rows[pos:pos + take].tolist(),
                                    range(fill, fill + take)):
                        cur = self._row_addr.get(r)
                        if cur is None:
                            self._row_addr[r] = (b, s)
                        elif isinstance(cur, list):
                            cur.append((b, s))
                        else:
                            self._row_addr[r] = [cur, (b, s)]
                fill += take
                pos += take
            self._cell_tail[cell] = (b, fill)
        self._dirty = True

    def delete_rows(self, rows):
        changed = []
        for row in np.asarray(rows).tolist():
            addr = self._row_addr.pop(int(row), None)
            if addr is None:
                continue
            for a in (addr if isinstance(addr, list) else [addr]):
                self.mask[a] = 0
                changed.append(a)
        if not changed:
            return
        if self._dev is not None and not self._dirty:
            # incremental: scatter only the deleted slots into the cached
            # device mask, in place — codes and row map are untouched by
            # deletes, so a full re-upload would be pure waste
            _, mb, _ = self._dev
            b = torch.tensor([a[0] for a in changed], dtype=torch.long, device=mb.device)
            s = torch.tensor([a[1] for a in changed], dtype=torch.long, device=mb.device)
            mb[b, s] = 0
        else:
            self._dirty = True

    def set_filter_mask(self, row_mask: np.ndarray) -> np.ndarray:
        """Combine alive-slots with a per-global-row predicate ->
        [n_blocks, BS] int8 (not cached on device: per-query-batch)."""
        out = self.mask.copy()
        valid = self.row_map >= 0
        out[valid] &= row_mask[self.row_map[valid]].astype(np.int8)
        return out

    def select_blocks(self, probed_cells) -> np.ndarray:
        sel = np.nonzero(np.isin(self.block_cell, np.asarray(probed_cells)))[0]
        return sel.astype(np.int32)

    def device_arrays(self):
        """``(codes, slot_mask, row_map)`` as tensors on the store's device."""
        if self._dirty or self._dev is None:
            self._dev = None  # drop the old mirror before the new one lands
            # a copy also on the CPU: the host arrays keep changing
            self._dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, copy=True) for a in (self.codes, self.mask, self.row_map))
            self._dirty = False
        return self._dev
