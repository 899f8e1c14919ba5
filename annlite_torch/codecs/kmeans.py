"""k-means (Lloyd + minibatch) — the port of `annlite_tpu/codecs/kmeans.py`.

Assignment is one float32 matrix product (``|x|^2 + |c|^2 - 2 x.c``, TF32
off, :func:`~annlite_torch.math.dot_f32`) and the centroid update another
(``onehot(labels)^T @ x``), so an iteration is two products and no scatter,
which also keeps the sums in a fixed order from run to run.  The M subspaces
of a PQ codebook set are a batch dimension written out: every function here
takes ``x [..., n, d]`` and centroids ``[..., k, d]`` with the same leading
dimensions.

Random initial centroids come from a ``torch.Generator`` seeded from
``seed``; they are not the JAX package's draws (``jax.random`` differs), so
parity with it is held on given initial centroids (``init=``, and the
minibatch update from a given state).
"""
from typing import NamedTuple, Optional, Tuple

import torch

from ..math import dot_f32


class KMeansState(NamedTuple):
    """Streaming k-means state (for minibatch / partial_fit)."""

    centroids: torch.Tensor  # [..., k, d]
    counts: torch.Tensor  # [..., k] — per-centroid cumulative assign counts


def _pairwise_sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``[..., n, d] x [..., k, d] -> [..., n, k]`` squared distances."""
    return (torch.sum(x * x, dim=-1)[..., :, None]
            + torch.sum(c * c, dim=-1)[..., None, :]
            - 2.0 * dot_f32(x, c))


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid labels ``[..., n]`` int64 (first index on ties, as
    ``jnp.argmin``)."""
    return torch.argmin(_pairwise_sq(x, centroids), dim=-1)


def _onehot_sums(labels: torch.Tensor, x: torch.Tensor, k: int):
    """``(counts [..., k], sums [..., k, d])`` of the rows of each label."""
    onehot = torch.zeros(labels.shape + (k,), dtype=torch.float32,
                         device=labels.device)
    onehot.scatter_(-1, labels[..., None], 1.0)  # [..., n, k]
    counts = torch.sum(onehot, dim=-2)
    sums = dot_f32(onehot.transpose(-1, -2), x.transpose(-1, -2))  # [..., k, d]
    return counts, sums


def _centroid_update(counts, sums, centroids):
    """The mean of each centroid's rows; a centroid with none keeps its
    place."""
    return torch.where(counts[..., None] > 0,
                       sums / torch.clamp_min(counts[..., None], 1.0), centroids)


def _lloyd_step(x, centroids, spherical: bool = False):
    """One Lloyd iteration -> ``(new_centroids, inertia [...])``; the inertia
    is that of the assignment to the centroids passed in."""
    d2 = _pairwise_sq(x, centroids)
    labels = torch.argmin(d2, dim=-1)
    k = centroids.shape[-2]
    counts, sums = _onehot_sums(labels, x, k)
    new_centroids = _centroid_update(counts, sums, centroids)
    if spherical:
        # spherical k-means (cosine coarse quantizer): project the centroids
        # back onto the unit sphere each iteration, so assignment is a pure
        # max-inner-product rule
        norm = torch.linalg.norm(new_centroids, dim=-1, keepdim=True)
        new_centroids = torch.where(
            norm > 1e-12, new_centroids / torch.clamp_min(norm, 1e-12),
            new_centroids)
    inertia = torch.sum(torch.amin(d2, dim=-1), dim=-1)
    return new_centroids, inertia


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def _init_centroids(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k distinct rows of ``x [..., n, d]`` (drawn independently for each
    leading index), without replacement."""
    n = x.shape[-2]
    if k > n:
        raise ValueError(f'k-means needs at least k={k} rows, got {n}')
    lead = x.shape[:-2]
    flat = x.reshape((-1,) + x.shape[-2:])
    idx = torch.stack([torch.randperm(n, generator=gen)[:k]
                       for _ in range(flat.shape[0])]).to(x.device)
    c0 = torch.gather(flat, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))
    return c0.reshape(lead + (k, x.shape[-1]))


def _lloyd(x, c0, iters: int, spherical: bool = False):
    """``iters`` Lloyd steps from ``c0`` -> ``(centroids, last inertia)``."""
    c = c0
    inertia = torch.zeros(x.shape[:-2], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        c, inertia = _lloyd_step(x, c, spherical=spherical)
    return c, inertia


def kmeans_fit(seed: int, x: torch.Tensor, k: int, iters: int = 25,
               n_init: int = 4, spherical: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-batch Lloyd with ``n_init`` restarts; returns the best
    ``(centroids [k, d], inertia)``.  ``spherical=True`` renormalizes the
    centroids each iteration (cosine coarse quantization)."""
    x = x.to(torch.float32)
    gen = _generator(seed)
    best = None
    for _ in range(n_init):
        c, inertia = _lloyd(x, _init_centroids(gen, x, k), iters, spherical)
        if best is None or bool(inertia < best[1]):
            best = (c, inertia)
    return best


def kmeans_fit_multi(seed: int, x: torch.Tensor, k: int, iters: int = 25,
                     n_init: int = 1, init: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Train M independent codebooks at once: ``x [M, n, d] -> [M, k, d]``,
    keeping each subspace's best of ``n_init`` restarts.  ``init [M, k, d]``
    warm-starts Lloyd from given codebooks (no restarts)."""
    x = x.to(torch.float32)
    if init is not None:
        return _lloyd(x, init.to(device=x.device, dtype=torch.float32), iters)[0]
    gen = _generator(seed)
    best_c, best_i = None, None
    for _ in range(n_init):
        c, inertia = _lloyd(x, _init_centroids(gen, x, k), iters)
        if best_c is None:
            best_c, best_i = c, inertia
        else:
            better = inertia < best_i
            best_c = torch.where(better[:, None, None], c, best_c)
            best_i = torch.where(better, inertia, best_i)
    return best_c


def minibatch_update(state: KMeansState, x: torch.Tensor) -> KMeansState:
    """One streaming minibatch update (Sculley 2010): a per-centroid learning
    rate of 1/count, i.e. the running mean of the assigned points."""
    labels = assign(x, state.centroids)
    k = state.centroids.shape[-2]
    batch_counts, batch_sums = _onehot_sums(labels, x, k)
    new_counts = state.counts + batch_counts
    # running mean: c_new = c + (sum - count*c) / new_count
    delta = batch_sums - batch_counts[..., None] * state.centroids
    centroids = state.centroids + torch.where(
        new_counts[..., None] > 0,
        delta / torch.clamp_min(new_counts[..., None], 1.0), 0.0)
    return KMeansState(centroids=centroids, counts=new_counts)


def minibatch_init(seed: int, x: torch.Tensor, k: int) -> KMeansState:
    x = x.to(torch.float32)
    c0 = _init_centroids(_generator(seed), x, k)
    return KMeansState(centroids=c0, counts=torch.zeros(
        c0.shape[:-1], dtype=torch.float32, device=x.device))
