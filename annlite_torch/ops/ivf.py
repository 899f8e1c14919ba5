"""Block-gathered IVF scan — the port of `annlite_tpu/ops/ivf.py`.

Codes are stored in fixed-size blocks, each owned by one IVF cell
(:class:`BlockedCodes`), and a search scores ONLY the blocks of the probed
cells: their ids arrive as a device array (``-1`` pads a selection) and each
CTA of the kernel reads the blocks it is given.  Candidates are (selection,
slot) pairs mapped back to global rows through the store's row map.

Kernels (``csrc/adc.cu``): ``ivf_scores`` (K7: ``[S, Q, BS]`` scores, the
slot mask applied outside) and ``ivf_block_top2`` (K6's block pass: the slot
mask and pad selections as BIG biases, bucketed top-2 with provenance
``j * BS + slot``), which ``lane8_merge`` finishes into a running top-8 per
lane class.  Beside each sits its plain PyTorch version (``_ivf_scores_ref``,
``_ivf_block_top2_ref``), bit-equal to it.  The wrappers take the plain
version for CPU tensors only; for CUDA tensors they launch the kernels or
raise.
"""
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import BIG, _ext
from .adc import MAX_ADC_CLUSTERS, _code_bytes, adc_scores_ref, supports_adc
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
    return q, m, k, block_ids.shape[0], codes_blocks.shape[2], _code_bytes(codes_blocks)


def ivf_scores(block_ids, dtable, codes_blocks):
    """Launch ``ivf_scores`` (K7) -> float32 ``[S, Q, BS]``."""
    q, m, k, s, bs, cb = _check('ivf_scores', block_ids, dtable, codes_blocks)
    out = torch.empty((s, q, bs), dtype=torch.float32, device=dtable.device)
    lib = _ext.library('adc')
    with torch.cuda.device(dtable.device):
        _ext.check(lib.annlite_ivf_scores(
            block_ids.data_ptr(), dtable.data_ptr(), codes_blocks.data_ptr(),
            out.data_ptr(), s, q, m, k, bs, cb, _ext.stream_ptr(dtable)),
            'ivf_scores')
    ivf_scores.launches += 1
    return out


ivf_scores.launches = 0


def ivf_block_top2(block_ids, dtable, codes_blocks, mask_blocks):
    """Launch ``ivf_block_top2`` (K6's block pass) -> ``(s, r)`` as
    :func:`_ivf_block_top2_ref`."""
    q, m, k, s, bs, cb = _check('ivf_block_top2', block_ids, dtable, codes_blocks,
                                mask_blocks)
    if mask_blocks.dtype != torch.int8 or mask_blocks.shape != (codes_blocks.shape[0], bs):
        raise ValueError('ivf_block_top2: unsupported mask')
    so = torch.empty((q, s * 256), dtype=torch.float32, device=dtable.device)
    ro = torch.empty((q, s * 256), dtype=torch.int32, device=dtable.device)
    lib = _ext.library('adc')
    with torch.cuda.device(dtable.device):
        _ext.check(lib.annlite_ivf_block_top2(
            block_ids.data_ptr(), dtable.data_ptr(), codes_blocks.data_ptr(),
            mask_blocks.data_ptr(), so.data_ptr(), ro.data_ptr(), s, q, m, k, bs,
            cb, _ext.stream_ptr(dtable)), 'ivf_block_top2')
    ivf_block_top2.launches += 1
    return so, ro


ivf_block_top2.launches = 0


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
        big = torch.tensor(BIG, dtype=torch.float32, device=raw.device)
        # the slot mask applied outside the kernel, as the JAX package does
        scores = torch.where(_ivf_keep(block_ids, mask_blocks)[:, None], raw,
                             big).transpose(0, 1)
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
