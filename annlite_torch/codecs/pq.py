"""Product Quantization codec — the port of `annlite_tpu/codecs/pq.py`.

- code dtype u8/u16/u32 chosen by ``n_clusters``;
- cosine => l2-normalized inputs;
- ``fit``: per-subspace k-means, all M subspaces as one batch
  (`codecs/kmeans.py`); ``partial_fit``: minibatch k-means;
- ``encode``: nearest codeword per subspace, in chunks of rows;
- ``get_dist_mat``: squared-L2 ADC tables ``[n, M, K]``, or ``1/K - dot``
  for inner product and cosine.

The codebooks live on the host (numpy, what ``dump`` writes) and on the
codec's ``device`` (``None`` means the card), where training, encoding and
the ADC tables are computed.
"""
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..enums import Metric, parse_metric
from ..math import dot_f32, l2_normalize
from .base import BaseCodec
from .kmeans import KMeansState, _generator, _init_centroids, assign, kmeans_fit_multi, minibatch_update


def _dist_mat_l2(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Batch ADC tables, squared L2: ``x [n, D] -> [n, M, K]``.

    The direct ``(q - c)^2`` broadcast, not the matrix-product identity: the
    table is small (``n*M*K*ds`` work against the ``n*N*M`` scan that follows)
    and the direct form avoids the cancellation of ``|q|^2 + |c|^2 - 2q.c``
    in float32, so the tables stay exact."""
    n = x.shape[0]
    m, k, ds = codebooks.shape
    diff = x.reshape(n, m, 1, ds) - codebooks[None]  # [n, M, K, ds]
    return torch.sum(diff * diff, dim=-1)


def _dist_mat_ip(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Batch ADC tables, inner-product flavour: ``1/K - dot`` per subspace
    (summed over M, a rank-equivalent ``1 - dot`` style distance)."""
    n = x.shape[0]
    m, k, ds = codebooks.shape
    xs = x.reshape(n, m, ds).transpose(0, 1)  # [M, n, ds]
    dots = dot_f32(xs, codebooks).transpose(0, 1)  # [n, M, K]
    return 1.0 / k - dots


class PQCodec(BaseCodec):
    """Product Quantization [Jegou11]."""

    # assignment materializes an [M, chunk, K] float32 distance tensor (4 GB
    # at M = 64, K = 256): the row axis is encoded in chunks of this size
    ENCODE_CHUNK = 1 << 16

    def __init__(
        self,
        dim: int,
        n_subvectors: int = 8,
        n_clusters: int = 256,
        metric: Metric = Metric.EUCLIDEAN,
        n_init: int = 4,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(require_train=True)
        if dim % n_subvectors != 0:
            raise ValueError(
                'input dimension must be dividable by number of sub-space'
            )
        self.dim = dim
        self.n_subvectors = n_subvectors
        self.n_clusters = n_clusters
        self.d_subvector = dim // n_subvectors
        self.metric = parse_metric(metric)
        self.n_init = n_init
        self.seed = seed
        self.device = resolve_device(device)

        self.code_dtype = (
            np.uint8
            if n_clusters <= 2**8
            else (np.uint16 if n_clusters <= 2**16 else np.uint32)
        )
        self.normalize_input = self.metric == Metric.COSINE
        self._set_codebooks(np.zeros(
            (n_subvectors, n_clusters, self.d_subvector), dtype=np.float32))
        self._mb_state: Optional[KMeansState] = None

    def __hash__(self):
        return hash(
            (
                self.__class__.__name__,
                self.dim,
                self.n_subvectors,
                self.n_clusters,
                self.metric,
                str(self.code_dtype),
            )
        )

    def _set_codebooks(self, cb):
        """Keep the codebooks on the host (numpy) and on the device."""
        if isinstance(cb, torch.Tensor):
            self._cb = cb.to(device=self.device, dtype=torch.float32)
            self._codebooks = self._cb.cpu().numpy()
        else:
            self._codebooks = np.array(cb, dtype=np.float32)
            self._cb = torch.from_numpy(self._codebooks).to(self.device)

    # ----- training -----

    def _prep(self, x) -> torch.Tensor:
        """``x`` as a float32 tensor on the codec's device, l2-normalized for
        cosine."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if x.ndim != 2:
            raise ValueError('expected [n, dim] input')
        if self.normalize_input:
            x = l2_normalize(x)
        return x

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, D] -> [M, n, ds]``."""
        return x.reshape(x.shape[0], self.n_subvectors,
                         self.d_subvector).transpose(0, 1).contiguous()

    def fit(self, x, iter: int = 25, warm_start: bool = False):
        """``warm_start=True`` refines the existing codebooks in place
        instead of refitting from a cold init."""
        xs = self._split(self._prep(x))
        init = self._cb if warm_start else None
        cb = kmeans_fit_multi(self.seed, xs, self.n_clusters, iters=iter,
                              n_init=self.n_init, init=init)
        self._set_codebooks(cb)
        self._is_trained = True
        return self

    def partial_fit(self, x):
        """Streaming minibatch training over all subspaces at once."""
        xs = self._split(self._prep(x))
        if self._mb_state is None:
            c0 = _init_centroids(_generator(self.seed), xs, self.n_clusters)
            self._mb_state = KMeansState(
                centroids=c0,
                counts=torch.zeros((self.n_subvectors, self.n_clusters),
                                   dtype=torch.float32, device=self.device))
        self._mb_state = minibatch_update(self._mb_state, xs)
        return self

    def build_codebook(self):
        """Freeze minibatch centroids into the codebook."""
        if self._mb_state is None:
            raise RuntimeError('no partial_fit state to build a codebook from')
        self._set_codebooks(self._mb_state.centroids)
        self._is_trained = True
        return self

    # ----- encode / decode -----

    def encode(self, x) -> np.ndarray:
        """Codes ``[n, M]`` in ``code_dtype``, computed on the codec's device
        in chunks of ``ENCODE_CHUNK`` rows."""
        self._check_trained()
        x = self._prep(x)
        out = np.empty((x.shape[0], self.n_subvectors), dtype=self.code_dtype)
        for s in range(0, x.shape[0], self.ENCODE_CHUNK):
            codes = assign(self._split(x[s:s + self.ENCODE_CHUNK]), self._cb).T
            out[s:s + self.ENCODE_CHUNK] = codes.cpu().numpy()
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        self._check_trained()
        c = torch.from_numpy(np.asarray(codes).astype(np.int64)).to(self.device)
        sub = torch.stack([self._cb[m][c[:, m]] for m in range(self.n_subvectors)],
                          dim=1)  # [n, M, ds]
        return sub.reshape(c.shape[0], -1).cpu().numpy()

    # ----- ADC tables -----

    def precompute_adc(self, query: np.ndarray) -> 'DistanceTable':
        """Single-query M x K table."""
        self._check_trained()
        q = np.asarray(query, dtype=np.float32).reshape(1, -1)
        return DistanceTable(self.get_dist_mat(q)[0])

    def dist_mat(self, x) -> torch.Tensor:
        """Batch ADC tables ``[n, M, K]`` float32 on the codec's device."""
        self._check_trained()
        x = self._prep(x)
        if self.metric == Metric.EUCLIDEAN:
            return _dist_mat_l2(x, self._cb).contiguous()
        if self.metric in (Metric.INNER_PRODUCT, Metric.COSINE):
            return _dist_mat_ip(x, self._cb).contiguous()
        raise ValueError(f'unsupported metric {self.metric}')

    def get_dist_mat(self, x: np.ndarray) -> np.ndarray:
        """Batch ADC tables ``[n, M, K]`` as numpy."""
        return np.ascontiguousarray(self.dist_mat(x).cpu().numpy())

    @property
    def codebooks(self) -> np.ndarray:
        return self._codebooks

    # ----- serde -----

    def _state(self):
        return {
            'params': {
                'dim': self.dim,
                'n_subvectors': self.n_subvectors,
                'n_clusters': self.n_clusters,
                'metric': int(self.metric),
                'n_init': self.n_init,
                'seed': self.seed,
                'is_trained': self._is_trained,
            },
            'arrays': {'codebooks': self._codebooks},
        }

    def _restore(self, params, arrays, device=None):
        self.__init__(
            dim=params['dim'],
            n_subvectors=params['n_subvectors'],
            n_clusters=params['n_clusters'],
            metric=Metric(params['metric']),
            n_init=params['n_init'],
            seed=params['seed'],
            device=device,
        )
        self._set_codebooks(arrays['codebooks'])
        self._is_trained = params['is_trained']


class DistanceTable:
    """Single-query ADC table."""

    def __init__(self, dtable: np.ndarray):
        if dtable.ndim != 2:
            raise ValueError(f'expected an [M, K] table, got {dtable.shape}')
        self.dtable = np.asarray(dtable, dtype=np.float32)

    def adist(self, codes: np.ndarray) -> np.ndarray:
        """Asymmetric distances [n] for codes [n, M]."""
        codes = np.asarray(codes)
        m = codes.shape[1]
        return self.dtable[np.arange(m)[None, :], codes.astype(np.int64)].sum(
            axis=1, dtype=np.float32
        )


def estimate_adc_self_recall(
    pq: 'PQCodec', x_sample: np.ndarray, k: int = 10,
    n_queries: int = 64, seed: int = 0,
) -> float:
    """Within-sample recall@k of the raw ADC ranking (rerank=0) against exact
    distances — a cheap build-time proxy for corpus-level raw-PQ recall.
    Queries are drawn from the sample and the ground truth is computed
    within it, so the estimate costs O(n_queries * len(sample)) host work."""
    x = pq._prep(np.asarray(x_sample, dtype=np.float32)).cpu().numpy()
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    qi = rng.choice(n, size=min(n_queries, n), replace=False)
    q = x[qi]
    codes = pq.encode(x).astype(np.int64)          # [n, M]
    dt = pq.get_dist_mat(q)                        # [Q, M, K]
    m_idx = np.arange(pq.n_subvectors)[None, :]
    adc = np.stack([dt[j][m_idx, codes].sum(axis=1) for j in range(len(q))])
    if pq.metric == Metric.EUCLIDEAN:
        exact = (
            (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
            - 2.0 * q @ x.T
        )
    else:  # IP / cosine (inputs already normalized by _prep for cosine)
        exact = -(q @ x.T)
    k = min(k, n)
    gt = np.argpartition(exact, k - 1, axis=1)[:, :k]
    got = np.argpartition(adc, k - 1, axis=1)[:, :k]
    return float(np.mean([
        len(set(gt[j]) & set(got[j])) / k for j in range(len(q))
    ]))
