"""PCA projector codec (dimensionality reduction) — the port of
`annlite_tpu/codecs/projector.py`.

Streaming second moments (float32 products, TF32 off) on the codec's
``device`` (``None`` means the card) and ``torch.linalg.eigh``: ``partial_fit``
over a stream gives exactly what ``fit`` gives over its concatenation.  The
moments and the fitted basis live on the host as numpy, the same arrays the
JAX codec keeps, so a ``projector.npz`` written by either package loads in
the other.
"""
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..math import dot_f32
from .base import BaseCodec


def _finalize(n: float, s1: torch.Tensor, s2: torch.Tensor, n_components: int):
    """Moments -> (mean, components ``[C, D]``, explained variance, total
    variance), float32; each component's largest-magnitude entry is made
    positive."""
    n = torch.tensor(n, dtype=torch.float32, device=s1.device)
    mean = s1 / n
    cov = s2 / (n - 1.0) - (n / (n - 1.0)) * torch.outer(mean, mean)
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    eigvals = torch.flip(eigvals, [0])
    comps = torch.flip(eigvecs, [1])[:, :n_components].T  # [C, D]
    idx = torch.argmax(torch.abs(comps), dim=1)
    signs = torch.sign(comps[torch.arange(comps.shape[0], device=comps.device), idx])
    comps = comps * signs[:, None]
    ev = torch.clamp_min(eigvals[:n_components], 0.0)
    total_var = torch.sum(torch.clamp_min(eigvals, 0.0))
    return mean, comps, ev, total_var


class ProjectorCodec(BaseCodec):
    def __init__(
        self,
        dim: int,
        n_components: int = 128,
        whiten: bool = False,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(require_train=True)
        if n_components > dim:
            raise ValueError('n_components must be <= dim')
        self.dim = dim
        self.n_components = n_components
        self.whiten = whiten
        self.seed = seed
        self.device = resolve_device(device)
        self._n = 0.0
        self._s1 = np.zeros((dim,), dtype=np.float64)
        self._s2 = np.zeros((dim, dim), dtype=np.float64)
        self._mean: Optional[np.ndarray] = None
        self._components: Optional[np.ndarray] = None
        self._explained_variance: Optional[np.ndarray] = None
        self._total_var: float = 0.0
        self._basis_dev = None  # (mean, components, scale) on the device

    def __hash__(self):
        return hash((self.__class__.__name__, self.dim, self.n_components, self.whiten))

    def _t(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def fit(self, x: np.ndarray):
        self._n = 0.0
        self._s1[:] = 0
        self._s2[:] = 0
        return self.partial_fit(x)

    def partial_fit(self, x: np.ndarray):
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f'expected [n, {self.dim}] input')
        xt = self._t(x)
        s1 = self._t(self._s1) + torch.sum(xt, dim=0)
        s2 = self._t(self._s2) + dot_f32(xt.T, xt.T)
        self._s1 = s1.cpu().numpy().astype(np.float64)
        self._s2 = s2.cpu().numpy().astype(np.float64)
        self._n += x.shape[0]
        if self._n >= 2:
            self._finalize()
        return self

    def _finalize(self):
        mean, comps, ev, tv = _finalize(self._n, self._t(self._s1), self._t(self._s2),
                                        self.n_components)
        self._mean = mean.cpu().numpy()
        self._components = comps.cpu().numpy()
        self._explained_variance = ev.cpu().numpy()
        self._total_var = float(tv)
        self._basis_dev = None
        self._is_trained = True

    def _basis(self):
        """(mean, components, whitening scale) on the device, copied once."""
        if self._basis_dev is None:
            self._basis_dev = (self._t(self._mean), self._t(self._components), torch.sqrt(
                torch.clamp_min(self._t(self._explained_variance), 1e-12)))
        return self._basis_dev

    def encode_tensor(self, x) -> torch.Tensor:
        """``[n, dim] -> [n, n_components]`` float32 as a tensor on the
        codec's device (a serving path projects its queries here)."""
        self._check_trained()
        mean, comps, scale = self._basis()
        y = dot_f32(self._t(x) - mean, comps)
        return y / scale if self.whiten else y

    def encode(self, x: np.ndarray) -> np.ndarray:
        """``[n, dim] -> [n, n_components]`` float32, computed on the device."""
        return self.encode_tensor(x).cpu().numpy()

    def decode(self, y: np.ndarray) -> np.ndarray:
        self._check_trained()
        mean, comps, scale = self._basis()
        y = self._t(y)
        if self.whiten:
            y = y * scale
        return (dot_f32(y, comps.T) + mean).cpu().numpy()

    # ----- stats -----

    @property
    def components(self) -> np.ndarray:
        self._check_trained()
        return self._components

    @property
    def mean(self) -> np.ndarray:
        self._check_trained()
        return self._mean

    @property
    def explained_variance(self) -> np.ndarray:
        self._check_trained()
        return self._explained_variance

    @property
    def explained_variance_ratio(self) -> np.ndarray:
        self._check_trained()
        return self._explained_variance / max(self._total_var, 1e-12)

    @property
    def var(self) -> np.ndarray:
        self._check_trained()
        n = max(self._n, 2.0)
        return (self._s2.diagonal() / (n - 1.0)
                - (n / (n - 1.0)) * self._mean**2).astype(np.float32)

    # ----- serde (the JAX codec's keys) -----

    def _state(self):
        return {
            'params': {
                'dim': self.dim,
                'n_components': self.n_components,
                'whiten': self.whiten,
                'seed': self.seed,
                'is_trained': self._is_trained,
                'n': self._n,
                'total_var': self._total_var,
            },
            'arrays': {
                's1': self._s1,
                's2': self._s2,
                'mean': self._mean if self._mean is not None else np.zeros(0),
                'components': (self._components if self._components is not None
                               else np.zeros((0, 0))),
                'explained_variance': (self._explained_variance
                                       if self._explained_variance is not None
                                       else np.zeros(0)),
            },
        }

    def _restore(self, params, arrays, device=None):
        self.__init__(dim=params['dim'], n_components=params['n_components'],
                      whiten=params['whiten'], seed=params['seed'], device=device)
        self._n = params['n']
        self._total_var = params['total_var']
        self._s1 = np.asarray(arrays['s1'], dtype=np.float64)
        self._s2 = np.asarray(arrays['s2'], dtype=np.float64)
        if arrays['mean'].size:
            self._mean = np.asarray(arrays['mean'], dtype=np.float32)
            self._components = np.asarray(arrays['components'], dtype=np.float32)
            self._explained_variance = np.asarray(arrays['explained_variance'],
                                                  dtype=np.float32)
        self._is_trained = params['is_trained']
