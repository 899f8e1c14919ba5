"""PQ linear-scan index — the port of `annlite_tpu/index/pq_scan.py`.

ADC over the whole (masked) code matrix (`ops/adc.py`), with an optional
exact rerank stage.  Codes live transposed ``[M, N]`` (a ``DeviceBuffer``
growing along its last axis), so the kernels read neighbouring rows'
codes from neighbouring bytes.

Rerank (``rerank=R > 0``): the ADC scan shortlists R candidates per query,
their full vectors (kept on the device as bfloat16) are gathered and scored
exactly in float32, and the top-``limit`` of the shortlist is returned.
"""
from typing import Optional, Union

import numpy as np
import torch

from ..codecs import PQCodec
from ..device import resolve_device
from ..enums import Metric
from ..math import l2_normalize
from ..ops import BIG
from ..ops.adc import adc_topk
from ..ops.topk import topk
from ..profile import span, upload, wait
from .base import BaseIndex, padded_mask
from .buffer import DeviceBuffer


def _warn_if_low_raw_recall(pq_codec, x_sample, floor, where, max_sample=4096):
    """Rerank=0 recall-floor guard: estimate the within-sample raw-ADC
    recall@10 on the first sizeable ingest and warn when it sits below
    ``floor`` — raw-PQ recall depends strongly on the data."""
    import warnings

    from ..codecs.pq import estimate_adc_self_recall

    r = estimate_adc_self_recall(pq_codec, x_sample[:max_sample])
    if r < floor:
        warnings.warn(
            f'{where}: estimated raw-PQ recall@10 is {r:.2f} '
            f'(< floor {floor:.2f}) on this data — rerank=0 serves the raw '
            f'ADC ranking with no exact correction. Set rerank>0 (e.g. '
            f'rerank=100) or raise n_subvectors.',
            RuntimeWarning, stacklevel=3,
        )
    return r


def _rerank(query, cand_idx, cand_adc_d, vectors, limit, metric_val):
    """Exact-score the shortlist: query [Q, D], cand_idx [Q, R], vectors
    [N_pad, D] (bf16) -> (dists [Q, limit], rows [Q, limit]); a gather and a
    float32 distance in plain PyTorch (no kernel in the JAX package either)."""
    cand = vectors[cand_idx.long()].float()  # [Q, R, D]
    if metric_val == int(Metric.EUCLIDEAN):
        d = torch.sum((query[:, None, :] - cand) ** 2, dim=-1)
    else:  # cosine (pre-normalized at insert) / inner product
        d = 1.0 - torch.einsum('qd,qrd->qr', query, cand)
    # keep masked-out/padded shortlist entries out of the final top-k
    big = torch.tensor(BIG, dtype=torch.float32, device=d.device)
    d = torch.where(cand_adc_d < BIG / 2, d, big)
    d, pos = topk(d, limit)
    return d, torch.gather(cand_idx, 1, pos)


class PQScanIndex(BaseIndex):
    # update_with_ids (= add_with_ids) re-encodes + overwrites rows in place
    supports_inplace_update = True

    def __init__(
        self,
        dim: int,
        pq_codec: PQCodec,
        chunk: int = 65536,
        exact_topk: bool = False,
        rerank: int = 0,
        recall_guard: bool = True,
        recall_floor: float = 0.85,
        device: Optional[Union[str, torch.device]] = None,
        **kwargs,
    ):
        super().__init__(dim=dim, metric=pq_codec.metric, **kwargs)
        if not pq_codec.is_trained:
            raise RuntimeError('PQCodec must be trained before building PQScanIndex')
        self.device = resolve_device(device)
        self.pq_codec = pq_codec
        self.n_subvectors = pq_codec.n_subvectors
        self.exact_topk = exact_topk
        self.rerank = rerank
        # rerank=0 serves the RAW ADC ranking, whose recall depends on the
        # data: estimate it once at ingest and warn
        self.recall_guard = recall_guard and rerank == 0
        self.recall_floor = recall_floor
        self._guard_done = False
        self._guard_rows: list = []  # sample accumulated across batches
        grow = dict(device=self.device, chunk=chunk, expand_mode=self.expand_mode,
                    expand_step=self.expand_step_size,
                    initial_capacity=self.initial_size)
        # u8/u16/u32 per the codec's n_clusters; the kernels take u8 and u16
        self._codes_t = DeviceBuffer(
            (self.n_subvectors,), np.dtype(pq_codec.code_dtype), grow_axis=1, **grow)
        # bf16 rerank rows: the host keeps them as float32 values rounded to
        # bf16, the device as bf16
        self._vectors = (
            DeviceBuffer((dim,), np.float32, device_dtype=torch.bfloat16, **grow)
            if rerank > 0 else None
        )

    @property
    def size(self) -> int:
        return self._codes_t.size

    @property
    def capacity(self) -> int:
        return self._codes_t.capacity

    def _prep(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32).reshape(-1, self.dim)
        if self.pq_codec.normalize_input:
            x = l2_normalize(torch.from_numpy(x)).numpy()
        return x

    def add_with_ids(self, x: np.ndarray, ids: np.ndarray, codes: Optional[np.ndarray] = None):
        """Encode (or take precomputed codes) and write at global rows."""
        x = self._prep(x)
        if codes is None:
            codes = self.pq_codec.encode(x)
        self._codes_t.write(np.asarray(ids), codes.T)
        if self._vectors is not None:
            self._vectors.write(np.asarray(ids), x)
        if self.recall_guard and not self._guard_done:
            # accumulate across batches so streaming small-batch ingests
            # still trip the guard once 512 rows have been seen
            self._guard_rows.append(x[:2048])
            if sum(len(r) for r in self._guard_rows) >= 512:
                self._guard_done = True
                sample = np.concatenate(self._guard_rows)[:2048]
                self._guard_rows = []
                _warn_if_low_raw_recall(self.pq_codec, sample, self.recall_floor,
                                        'PQScanIndex(rerank=0)')

    def search(self, query: np.ndarray, limit: int = 10, mask: Optional[np.ndarray] = None):
        with span('annlite.index.prep'):
            q = upload(self._prep(query), self.device)
            dtable = self.pq_codec.dist_mat(q).to(self.device)
            codes_t = self._codes_t.device_view()
            n_pad = codes_t.shape[1]
            k = min(limit, max(self.size, 1))
            mt = upload(padded_mask(mask, self.size, n_pad), self.device)
            vectors = self._vectors.device_view() if self.rerank > 0 else None
        with span('annlite.index.dispatch'):
            if self.rerank > 0:
                r = min(max(self.rerank, k), n_pad)
                # adc_topk finishes the first-pass top-k with the deep select
                # on the card: the [Q, N] score matrix is never written
                adc_d, cand = adc_topk(dtable, codes_t, r, mt, exact=self.exact_topk)
                d, idx = _rerank(q, cand, adc_d, vectors, k, int(self.metric))
            else:
                d, idx = adc_topk(dtable, codes_t, k, mt, exact=self.exact_topk)
        with wait():
            return d.cpu().numpy(), idx.cpu().numpy()

    def reset(self):
        self._codes_t.reset()
        if self._vectors is not None:
            self._vectors.reset()

    # ----- snapshot state (see AnnLite.dump_index) -----

    def state_arrays(self):
        out = {
            'kind': np.array('pq_scan'),
            'codes_t': self._codes_t.host_view().copy(),
        }
        if self._vectors is not None:
            out['vectors'] = self._vectors.host_view().copy()
        return out

    def load_state_arrays(self, state):
        self.reset()
        ct = state['codes_t']
        if ct.size:
            rows = np.arange(ct.shape[1])
            self._codes_t.write(rows, ct)
            if self._vectors is not None and 'vectors' in state:
                self._vectors.write(rows, np.asarray(state['vectors'], dtype=np.float32))
