"""IVF-PQ index — the port of `annlite_tpu/index/ivf_pq.py`: a blocked code
store and a scan of the probed cells' blocks only (`ops/ivf.py`), with an
optional exact rerank over bfloat16 rows, as in `PQScanIndex`.
"""
from typing import Optional, Union

import numpy as np
import torch

from ..codecs import PQCodec
from ..device import resolve_device
from ..enums import Metric
from ..math import l2_normalize
from ..ops import BIG
from ..ops.ivf import BLOCK_SIZE, BlockedCodes, ivf_scan_topk, slot_mask_device
from ..ops.topk import topk
from .base import BaseIndex
from .buffer import DeviceBuffer


def _dedup_candidates(d, rows):
    """Keep each row's best occurrence: order by (row, distance), set repeats
    of a row (and empty rows < 0) to BIG, restore distance order.  The
    lexicographic order is two stable sorts, the minor key first."""
    o = torch.argsort(d, dim=1, stable=True)
    rows_o, d_o = torch.gather(rows, 1, o), torch.gather(d, 1, o)
    o = torch.argsort(rows_o, dim=1, stable=True)
    rows_s, d_s = torch.gather(rows_o, 1, o), torch.gather(d_o, 1, o)
    dup = torch.zeros_like(rows_s, dtype=torch.bool)
    dup[:, 1:] = rows_s[:, 1:] == rows_s[:, :-1]
    big = torch.tensor(BIG, dtype=d_s.dtype, device=d_s.device)
    d_s = torch.where(dup | (rows_s < 0), big, d_s)
    o = torch.argsort(d_s, dim=1, stable=True)
    return torch.gather(d_s, 1, o), torch.gather(rows_s, 1, o)


class IVFPQIndex(BaseIndex):
    wants_cells = True  # container passes per-row cell ids to add_with_ids

    def __init__(
        self,
        dim: int,
        pq_codec: PQCodec,
        block_size: int = BLOCK_SIZE,
        rerank: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        **kwargs,
    ):
        super().__init__(dim=dim, metric=pq_codec.metric, **kwargs)
        if not pq_codec.is_trained:
            raise RuntimeError('PQCodec must be trained before building IVFPQIndex')
        self.device = resolve_device(device)
        self.pq_codec = pq_codec
        self.rerank = rerank
        self._store = BlockedCodes(pq_codec.n_subvectors, block_size,
                                   code_dtype=pq_codec.code_dtype, device=self.device)
        self._size = 0
        self._vectors = (
            DeviceBuffer((dim,), np.float32, self.device, device_dtype=torch.bfloat16)
            if rerank > 0 else None
        )

    @property
    def size(self) -> int:
        return self._size

    @property
    def capacity(self) -> int:
        return self._store.n_blocks * self._store.bs

    def _prep(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32).reshape(-1, self.dim)
        if self.pq_codec.normalize_input:
            x = l2_normalize(torch.from_numpy(x)).numpy()
        return x

    def add_with_ids(self, x, ids, cells=None, codes=None):
        """``cells`` may be ``[n]`` (single assignment) or ``[n, a]`` with
        -1 pads (soft assignment: the row's codes are stored once per
        listed cell; search dedups)."""
        self._add_prepped(self._prep(x), ids, cells, codes)

    def _add_prepped(self, x, ids, cells, codes):
        """``add_with_ids`` of rows already through ``_prep``."""
        if cells is None:
            cells = np.zeros(len(x), dtype=np.int32)
        if codes is None:
            codes = self.pq_codec.encode(x)
        ids = np.asarray(ids)
        cells = np.asarray(cells)
        if cells.ndim == 2:
            self._store.multi = True
            keep = cells >= 0
            rep_idx = np.nonzero(keep)[0]       # row index per copy
            self._store.append(codes[rep_idx], cells[keep], ids[rep_idx])
        else:
            self._store.append(codes, cells, ids)
        self._size = max(self._size, int(ids.max()) + 1) if len(ids) else self._size
        if self._vectors is not None:
            self._vectors.write(ids, x)

    def delete_rows(self, rows):
        self._store.delete_rows(rows)

    def search(
        self,
        query: np.ndarray,
        limit: int = 10,
        mask: Optional[np.ndarray] = None,
        cells: Optional[np.ndarray] = None,
    ):
        """``cells``: probed cell ids for this batch (union over queries);
        None scans everything."""
        query = self._prep(query)
        dtable = self.pq_codec.dist_mat(query).to(self.device)
        if cells is None:
            sel = np.arange(self._store.n_blocks, dtype=np.int32)
        else:
            sel = self._store.select_blocks(np.unique(np.asarray(cells)))
        if sel.size == 0:
            q = query.shape[0]
            return (np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64))
        cb, mb, rm = self._store.device_arrays()
        if mask is not None:
            # the predicate is combined on the device through the resident
            # row map: only the [N] int8 predicate crosses host->device
            mb = slot_mask_device(
                mb, rm, torch.from_numpy(np.asarray(mask).astype(np.int8)).to(self.device))
        k = limit if self.rerank == 0 else max(self.rerank, limit)
        if self._store.multi:
            # soft-assigned rows can appear once per probed copy — widen
            # the candidate pool so duplicates don't crowd out real rows,
            # then keep only each row's first occurrence
            k = min(2 * k, self._store.n_blocks * self._store.bs)
        d, rows = ivf_scan_topk(torch.from_numpy(sel).to(self.device), dtable, cb, mb,
                                rm, k)
        if self._store.multi:
            d, rows = _dedup_candidates(d, rows)
        if self.rerank > 0:
            d, rows = self._rerank_stage(query, rows, d, limit)
        elif self._store.multi:
            d, pos = topk(d, min(limit, d.shape[1]))
            rows = torch.gather(rows, 1, pos)
        d, rows = d.cpu().numpy(), rows.cpu().numpy()
        return d[:, :limit], rows[:, :limit]

    def _rerank_stage(self, query, cand_rows, cand_d, limit):
        vecs = self._vectors.device_view()
        safe = torch.clamp(cand_rows.long(), 0, vecs.shape[0] - 1)
        cvec = vecs[safe].float()
        q = torch.from_numpy(query).to(self.device)
        if self.metric == Metric.EUCLIDEAN:
            d = torch.sum((q[:, None, :] - cvec) ** 2, dim=-1)
        else:
            d = 1.0 - torch.einsum('qd,qrd->qr', q, cvec)
        big = torch.tensor(BIG, dtype=torch.float32, device=d.device)
        d = torch.where(cand_d < BIG / 2, d, big)
        d, pos = topk(d, min(limit, d.shape[1]))
        return d, torch.gather(cand_rows, 1, pos)

    def reset(self):
        self._store = BlockedCodes(self.pq_codec.n_subvectors, self._store.bs,
                                   code_dtype=self.pq_codec.code_dtype,
                                   device=self.device)
        self._size = 0
        if self._vectors is not None:
            self._vectors.reset()

    # ----- snapshot state -----

    def state_arrays(self):
        out = {
            'kind': np.array('ivf_pq'),
            'codes': self._store.codes.copy(),
            'slot_mask': self._store.mask.copy(),
            'row_map': self._store.row_map.copy(),
            'block_cell': self._store.block_cell.copy(),
            'size': np.array(self._size),
            'store_multi': np.array(self._store.multi),
        }
        if self._vectors is not None:
            out['vectors'] = self._vectors.host_view().copy()
        return out

    def load_state_arrays(self, state):
        self.reset()
        st = self._store
        st.codes = np.asarray(state['codes'], dtype=st.code_dtype)
        st.mask = np.asarray(state['slot_mask'], dtype=np.int8)
        st.row_map = np.asarray(state['row_map'], dtype=np.int32)
        st.block_cell = np.asarray(state['block_cell'], dtype=np.int32)
        st._dirty = True
        # rebuild tails + row addresses, vectorized (a per-slot Python loop
        # costs tens of seconds at 1M rows)
        nb = st.n_blocks
        st.multi = bool(state.get('store_multi', False))
        if nb:
            fill = (st.row_map[:nb] >= 0).sum(axis=1)
            cells = np.asarray(st.block_cell[:nb])
            # last block of each cell (highest index) becomes the tail
            uniq, ridx = np.unique(cells[::-1], return_index=True)
            last = nb - 1 - ridx
            st._cell_tail = {
                int(c): (int(b), int(fill[b])) for c, b in zip(uniq, last)
            }
            alive = (st.row_map[:nb] >= 0) & (st.mask[:nb] > 0)
            b_idx, s_idx = np.nonzero(alive)
            rows = st.row_map[:nb][b_idx, s_idx]
            if not st.multi:
                st._row_addr = dict(
                    zip(rows.tolist(), zip(b_idx.tolist(), s_idx.tolist()))
                )
            else:  # soft-assigned rows hold several addrs — keep them all
                addr = {}
                for r, b, s in zip(rows.tolist(), b_idx.tolist(), s_idx.tolist()):
                    cur = addr.get(r)
                    if cur is None:
                        addr[r] = (b, s)
                    elif isinstance(cur, list):
                        cur.append((b, s))
                    else:
                        addr[r] = [cur, (b, s)]
                st._row_addr = addr
        else:
            st._cell_tail = {}
            st._row_addr = {}
        self._size = int(state['size'])
        if self._vectors is not None and 'vectors' in state:
            v = np.asarray(state['vectors'], dtype=np.float32)
            if v.size:
                self._vectors.write(np.arange(v.shape[0]), v)
