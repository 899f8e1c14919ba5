"""OPQ, Optimized Product Quantization (Ge et al., CVPR'13) — the port of
`annlite_tpu/codecs/opq.py`.

A learned orthogonal rotation ``R`` is applied before PQ so the subspace
split aligns with the data's structure.  Training alternates:

1. fit the PQ codebooks on ``x @ R`` (warm-started after the first sweep);
2. update ``R`` by orthogonal Procrustes, ``R = U V^T`` from the SVD of
   ``x^T x_hat`` (data against its decoded reconstruction), float32 products
   with TF32 off.

An ``OPQCodec`` is a drop-in :class:`PQCodec` whose ``_prep`` rotates its
input: ``encode`` and the ADC tables (``dist_mat``) see ``x @ R``, each
rotated once, and ``decode`` rotates back into the original space.  ``R``
lives on the host (numpy, what ``pq.npz`` holds) and on the codec's device.
"""
import numpy as np
import torch

from ..math import dot_f32, l2_normalize
from .pq import PQCodec


def _procrustes_update(x: torch.Tensor, recon_rot: torch.Tensor) -> torch.Tensor:
    """``R = argmin_R ||x R - recon_rot||_F``  s.t.  ``R^T R = I``."""
    m = dot_f32(x.T, recon_rot.T)  # x^T recon_rot
    u, _, vt = torch.linalg.svd(m, full_matrices=False)
    return dot_f32(u, vt.T)


def _eigenvalue_allocation(x: np.ndarray, m: int) -> np.ndarray:
    """Parametric OPQ init (Ge et al. §4, eigenvalue allocation): rotate onto
    the PCA basis, then deal the principal directions, in descending
    eigenvalue order, to the least-loaded of the M subspaces that still has
    room.  The load is the sum of eigenvalues (the variance), not the
    paper's log-product, which on bimodal spectra (a few signal dimensions
    over a noise floor) stacks all the signal into a few subspaces."""
    d = x.shape[1]
    ds = d // m
    cov = np.cov(x.astype(np.float64).T)
    w, v = np.linalg.eigh(cov)           # ascending
    w, v = w[::-1], v[:, ::-1]           # descending eigenvalues
    buckets = [[] for _ in range(m)]
    load = np.zeros(m)
    for i in range(d):
        free = [b for b in range(m) if len(buckets[b]) < ds]
        b = min(free, key=lambda j: load[j])
        buckets[b].append(i)
        load[b] += float(w[i])
    perm = [i for b in buckets for i in b]
    return np.ascontiguousarray(v[:, perm], dtype=np.float32)


class OPQCodec(PQCodec):
    """PQ with a learned orthogonal pre-rotation."""

    def __init__(self, *args, opq_iters: int = 8, opq_init: str = 'eigen', **kwargs):
        super().__init__(*args, **kwargs)
        if opq_init not in ('eigen', 'identity'):
            raise ValueError(f'unknown opq_init {opq_init!r}')
        self.opq_iters = opq_iters
        self.opq_init = opq_init
        self._set_rotation(np.eye(self.dim, dtype=np.float32))
        self.fit_trace: list = []  # reconstruction MSE per sweep

    def _set_rotation(self, rot):
        """Keep ``R`` on the host (numpy) and on the device; ``None`` turns
        the rotation off (the inner fits)."""
        if rot is None:
            self._rot = None
            return
        if isinstance(rot, torch.Tensor):
            self._rot = rot.to(device=self.device, dtype=torch.float32)
            self._rotation = self._rot.cpu().numpy()
        else:
            self._rotation = np.array(rot, dtype=np.float32)
            self._rot = torch.from_numpy(self._rotation).to(self.device)

    @property
    def rotation(self) -> np.ndarray:
        return self._rotation

    def fit(self, x, iter: int = 25):
        """Non-parametric OPQ alternation (Ge et al. §3) from the
        eigenvalue-allocation init (§4), codebooks warm-started: sweep 0 runs
        the full k-means in the initial rotation, later sweeps refine the
        previous codebooks for a few Lloyd iterations after each Procrustes
        update.  ``fit_trace`` records each sweep's reconstruction MSE."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32).to(self.device)
        if self.normalize_input:
            x = l2_normalize(x)
        rot = torch.from_numpy(
            _eigenvalue_allocation(x.cpu().numpy(), self.n_subvectors)
            if self.opq_init == 'eigen' else np.eye(self.dim, dtype=np.float32)
        ).to(self.device)
        self.fit_trace = []
        # the parent's fit/encode run through this class's _prep, which
        # rotates: the rotation is off while they work on rotated rows, or
        # every inner call would add one more R (codebooks trained on x R^2
        # while inference encodes x R, and OPQ would measure as plain PQ)
        saved, self.normalize_input = self.normalize_input, False
        try:
            for it in range(self.opq_iters):
                xr = dot_f32(x, rot.T)  # x @ R
                self._set_rotation(None)
                super().fit(xr, iter=iter if it == 0 else max(iter // 4, 4),
                            warm_start=it > 0)
                recon = super().decode(super().encode(xr))
                xr_np = xr.cpu().numpy()
                self.fit_trace.append(float(np.mean((xr_np - recon) ** 2)))
                if it < self.opq_iters - 1:
                    rot = _procrustes_update(x, torch.from_numpy(recon).to(self.device))
        finally:
            self.normalize_input = saved
            self._set_rotation(rot)
        self._is_trained = True
        return self

    # ----- inference: rotate, then delegate -----

    def _prep(self, x) -> torch.Tensor:
        x = super()._prep(x)
        return x if self._rot is None else dot_f32(x, self._rot.T)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Decode to the original space (rotated back)."""
        recon_rot = torch.from_numpy(super().decode(codes)).to(self.device)
        return dot_f32(recon_rot, self._rot).cpu().numpy()

    # ----- serde (the JAX codec's keys) -----

    def _state(self):
        st = super()._state()
        st['params']['opq_iters'] = self.opq_iters
        st['params']['opq_init'] = self.opq_init
        st['arrays']['rotation'] = self._rotation
        return st

    def _restore(self, params, arrays, device=None):
        params = dict(params)
        opq_iters = params.pop('opq_iters', 5)
        opq_init = params.pop('opq_init', 'eigen')
        super()._restore(params, arrays, device)
        self.opq_iters = opq_iters
        self.opq_init = opq_init
        self._set_rotation(arrays.get('rotation', np.eye(self.dim, dtype=np.float32)))
