"""Vector-Quantization codec, the IVF coarse quantizer — the port of
`annlite_tpu/codecs/vq.py`: fit / partial_fit by k-means (spherical for
cosine), nearest-centroid ``encode``, soft assignment ``encode_multi``, no-op
``decode``.  Computes on ``device`` (``None`` means the card)."""
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..enums import Metric, parse_metric
from ..math import dot_f32, l2_normalize
from .base import BaseCodec
from .kmeans import KMeansState, assign, kmeans_fit, minibatch_init, minibatch_update


class VQCodec(BaseCodec):
    def __init__(
        self,
        n_clusters: int,
        metric: Metric = Metric.EUCLIDEAN,
        iter: int = 50,
        n_init: int = 4,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(require_train=True)
        self.n_clusters = n_clusters
        self.metric = parse_metric(metric)
        self.iter = iter
        self.n_init = n_init
        self.seed = seed
        self.device = resolve_device(device)
        self.normalize_input = self.metric == Metric.COSINE
        self._codebook: Optional[np.ndarray] = None
        self._cb: Optional[torch.Tensor] = None
        self._mb_state: Optional[KMeansState] = None

    def _set_codebook(self, cb):
        if isinstance(cb, torch.Tensor):
            self._cb = cb.to(device=self.device, dtype=torch.float32)
            self._codebook = self._cb.cpu().numpy()
        else:
            self._codebook = np.array(cb, dtype=np.float32)
            self._cb = torch.from_numpy(self._codebook).to(self.device)

    def _prep(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if self.normalize_input:
            x = l2_normalize(x)
        return x

    def fit(self, x):
        # cosine metric -> spherical k-means: inputs are pre-normalized by
        # _prep and centroids are kept on the unit sphere, so assignment is a
        # pure max-inner-product rule
        cb, _ = kmeans_fit(self.seed, self._prep(x), self.n_clusters,
                           iters=self.iter, n_init=self.n_init,
                           spherical=self.normalize_input)
        self._set_codebook(cb)
        self._is_trained = True
        return self

    def partial_fit(self, x):
        x = self._prep(x)
        if self._mb_state is None:
            self._mb_state = minibatch_init(self.seed, x, self.n_clusters)
        self._mb_state = minibatch_update(self._mb_state, x)
        return self

    def build_codebook(self):
        if self._mb_state is None:
            raise RuntimeError('no partial_fit state to build a codebook from')
        cb = self._mb_state.centroids.cpu().numpy()
        if self.normalize_input:  # spherical: project onto the unit sphere
            n = np.linalg.norm(cb, axis=1, keepdims=True)
            cb = np.where(n > 1e-12, cb / np.maximum(n, 1e-12), cb)
        self._set_codebook(cb)
        self._is_trained = True
        return self

    def encode(self, x) -> np.ndarray:
        """Nearest-centroid cell assignment [n] (int32, as the JAX
        package's)."""
        self._check_trained()
        return assign(self._prep(x), self._cb).to(torch.int32).cpu().numpy()

    def encode_multi(
        self, x, n_assign: int = 2, margin: float = 0.05
    ) -> np.ndarray:
        """Soft assignment for IVF boundary points: ``[n, n_assign]`` cells,
        column 0 the nearest centroid, later columns the next-nearest IF
        within ``margin`` of it (else -1).  Cosine margin is an absolute
        inner-product gap; euclidean a relative squared-distance gap."""
        self._check_trained()
        xp = self._prep(x)
        cb = self._cb
        dots = dot_f32(xp, cb)
        if self.normalize_input:  # cosine: rank by IP, gap in IP units
            score = dots
        else:
            d2 = (torch.sum(xp * xp, dim=1)[:, None]
                  + torch.sum(cb * cb, dim=1)[None, :] - 2.0 * dots)
            score = -d2
        k = min(n_assign, score.shape[1])
        # descending, ties to the lower index (lax.top_k's rule)
        top, cells = torch.sort(score, dim=1, descending=True, stable=True)
        top = top[:, :k].cpu().numpy()
        cells = cells[:, :k].cpu().numpy().astype(np.int32)
        if self.normalize_input:
            ok = (top[:, :1] - top) < margin
        else:
            d2_top = -top
            ok = (d2_top - d2_top[:, :1]) < margin * np.maximum(
                d2_top[:, :1], 1e-12)
        ok[:, 0] = True
        out = np.where(ok, cells, -1)
        if k < n_assign:
            out = np.pad(out, ((0, 0), (0, n_assign - k)),
                         constant_values=-1)
        return out

    def decode(self, x):
        """No-op, like the reference."""
        return None

    @property
    def codebook(self) -> np.ndarray:
        self._check_trained()
        return self._codebook

    def _state(self):
        return {
            'params': {
                'n_clusters': self.n_clusters,
                'metric': int(self.metric),
                'iter': self.iter,
                'n_init': self.n_init,
                'seed': self.seed,
                'is_trained': self._is_trained,
            },
            'arrays': {
                'codebook': self._codebook
                if self._codebook is not None
                else np.zeros((0, 0), dtype=np.float32)
            },
        }

    def _restore(self, params, arrays, device=None):
        self.__init__(
            n_clusters=params['n_clusters'],
            metric=Metric(params['metric']),
            iter=params['iter'],
            n_init=params['n_init'],
            seed=params['seed'],
            device=device,
        )
        cb = arrays['codebook']
        if cb.size:
            self._set_codebook(cb)
        self._is_trained = params['is_trained']
