"""Exact flat index — quantized first-pass scan + exact float32 rerank; the
port of `annlite_tpu/index/flat.py`.

The dense scan is bound by the bytes it reads, so the default path scans an
int8 copy of the corpus (4x fewer bytes than float32) and reranks the top-R
shortlist against the exact float32 rows: returned distances are exact.  The
predicate mask is applied before the top-k reduction, so filtered search
costs the same as unfiltered.

``scan_mode``: 'int8' (default), 'int4' (nibble-packed, half the scan
bytes of int8, with a deeper default shortlist), 'bf16' (no quantization
scales), or 'exact' (a float32 product, no quantized copy, for parity
debugging).  Each quantized mode has its own variant of the fused block-pass
kernel (`ops/fused_scan.py`).
"""
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..enums import Metric
from ..math import dot_f32, l2_normalize
from ..ops import BIG
from ..ops.scan import quantize_rows_int4, quantize_rows_int8, scan_topk
from ..ops.topk import topk
from ..profile import span, upload, wait
from .base import BaseIndex, padded_mask
from .buffer import DeviceBuffer


def _flat_search(q, x, norms_sq, mask, k, metric_val):
    """q[Q, D], x[N, D], norms_sq[N], mask[N] -> (dists[Q,k], idx[Q,k])."""
    dots = dot_f32(q, x)
    if metric_val == int(Metric.EUCLIDEAN):
        scores = torch.sum(q * q, dim=1)[:, None] + norms_sq[None, :] - 2.0 * dots
    else:  # cosine (pre-normalized) and inner product: dist = 1 - dot
        scores = 1.0 - dots
    big = torch.tensor(BIG, dtype=torch.float32, device=scores.device)
    scores = torch.where(mask[None, :] > 0, scores, big)
    d, rows = topk(scores, k)
    return d, rows.to(torch.int32)


class FlatIndex(BaseIndex):
    # update_with_ids (= add_with_ids) overwrites rows in place — the
    # container's update() keeps rows stable instead of dead-mark + append
    supports_inplace_update = True

    def __init__(self, dim: int, metric: Metric = Metric.COSINE, chunk: int = 65536,
                 scan_mode: str = 'int8',
                 device: Optional[Union[str, torch.device]] = None, **kwargs):
        super().__init__(dim=dim, metric=metric, **kwargs)
        if scan_mode not in ('int8', 'int4', 'bf16', 'exact'):
            raise ValueError(f'unknown scan_mode: {scan_mode!r}')
        if scan_mode == 'int4' and dim % 2:
            raise ValueError('int4 scan_mode requires an even dim')
        self.scan_mode = scan_mode
        self.device = resolve_device(device)
        # growth policy flows from BaseIndex (reference base.py:29-57 knobs:
        # initial_size / expand_step_size / expand_mode)
        grow = dict(device=self.device, chunk=chunk,
                    expand_mode=self.expand_mode,
                    expand_step=self.expand_step_size,
                    initial_capacity=self.initial_size)
        self._buf = DeviceBuffer((dim,), np.float32, **grow)
        self._norms = DeviceBuffer((), np.float32, **grow)
        if scan_mode in ('int8', 'int4'):
            store_dim = dim if scan_mode == 'int8' else dim // 2
            self._scan_buf = DeviceBuffer((store_dim,), np.int8, **grow)
            self._scale = DeviceBuffer((), np.float32, **grow)
        elif scan_mode == 'bf16':
            # the host keeps float32 values rounded to bf16, the device bf16
            self._scan_buf = DeviceBuffer((dim,), np.float32,
                                          device_dtype=torch.bfloat16, **grow)
            self._scale = None
        else:
            self._scan_buf = None
            self._scale = None

    @property
    def size(self) -> int:
        return self._buf.size

    @property
    def capacity(self) -> int:
        return self._buf.capacity

    def _prep(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32).reshape(-1, self.dim)
        if self.metric == Metric.COSINE:
            x = l2_normalize(torch.from_numpy(x)).numpy()
        return x

    def add_with_ids(self, x: np.ndarray, ids: np.ndarray):
        x = self._prep(x)
        ids = np.asarray(ids)
        self._buf.write(ids, x)
        self._norms.write(ids, np.sum(x * x, axis=1))
        self._write_scan(ids, x)

    def _write_scan(self, rows: np.ndarray, x: np.ndarray):
        """Write the scan copy of float32 rows ``x`` at ``rows``."""
        if self.scan_mode in ('int8', 'int4'):
            qz = quantize_rows_int8 if self.scan_mode == 'int8' else quantize_rows_int4
            codes, scale = qz(x)
            self._scan_buf.write(rows, codes)
            self._scale.write(rows, scale)
        elif self.scan_mode == 'bf16':
            self._scan_buf.write(rows, x)

    def search(self, query: np.ndarray, limit: int = 10, mask: Optional[np.ndarray] = None):
        q = np.asarray(query, dtype=np.float32).reshape(-1, self.dim)
        with span('annlite.index.prep'):
            scan = self._scanner(limit, mask)
            q = upload(q, self.device)
            if self.metric == Metric.COSINE:
                q = l2_normalize(q)
        with span('annlite.index.dispatch'):
            d, idx = scan(q)
        with wait():
            return d.cpu().numpy(), idx.cpu().numpy()

    def device_searcher(self, limit: int = 10, mask: Optional[np.ndarray] = None):
        """Device-resident search callable: ``query [Q, D] float32 (a tensor
        on the index's device, or anything ``torch.as_tensor`` takes) ->
        (dists [Q, limit], rows [Q, limit])`` as tensors on the device,
        without host transfers of the corpus.  Captures the current buffers
        and mask — rebuild after writes."""
        scan = self._scanner(limit, mask)
        cosine = self.metric == Metric.COSINE
        device = self.device

        def run(query):
            q = torch.as_tensor(query, dtype=torch.float32, device=device)
            return scan(l2_normalize(q) if cosine else q)

        return run

    def _scanner(self, limit: int, mask: Optional[np.ndarray]):
        """The scan over the current buffers and ``mask``: ``q [Q, D]`` on
        the device, normalized for cosine -> ``(dists, rows)``."""
        x = self._buf.device_view()
        norms = self._norms.device_view()
        m = upload(padded_mask(mask, self.size, x.shape[0]), self.device)
        k = min(limit, max(self.size, 1))
        metric = self.metric
        mode = self.scan_mode
        if mode != 'exact':
            scan = self._scan_buf.device_view()
            scale = self._scale.device_view() if self._scale is not None else None

        def run(q):
            if mode == 'exact':
                return _flat_search(q, x, norms, m, k, int(metric))
            return scan_topk(q, scan, scale, norms, m, k, metric, x_f32=x,
                             packed_int4=mode == 'int4')

        return run

    def reset(self):
        self._buf.reset()
        self._norms.reset()
        if self._scan_buf is not None:
            self._scan_buf.reset()
        if self._scale is not None:
            self._scale.reset()

    # ----- snapshot state (see AnnLite.dump_index) -----

    def state_arrays(self):
        return {
            'kind': np.array('flat'),
            'vectors': self._buf.host_view().copy(),
            'norms': self._norms.host_view().copy(),
        }

    def load_state_arrays(self, state):
        self.reset()
        v = state['vectors']
        if v.size:
            rows = np.arange(v.shape[0])
            self._buf.write(rows, v)
            self._norms.write(rows, state['norms'])
            self._write_scan(rows, v)
