"""Core distance math — the port of `annlite_tpu/math.py`.

Pairwise distances are one float32 matrix product plus rank-1 corrections.
The JAX package asks for ``Precision.HIGHEST``; here that is a plain float32
product with TF32 off (PyTorch's default), checked by :func:`dot_f32`.
``top_k`` is a stable ascending sort, so ties go to the lower index as with
``jax.lax.top_k``.
"""
import torch

from .enums import Metric, parse_metric

_EPS = 1e-12


def dot_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y.T`` in full float32 (batched over leading dimensions: ``[...,
    n, d] x [..., m, d] -> [..., n, m]``).  On the card that needs TF32 off
    for matrix products, the default, which the caller may have changed."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            'annlite_torch needs float32 products without TF32: set '
            'torch.backends.cuda.matmul.allow_tf32 = False'
        )
    return torch.matmul(x.float(), y.float().transpose(-1, -2))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Row-normalize ``x`` to unit L2 norm (zero rows stay zero)."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp_min(norm, _EPS)


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared-L2: ``[n, d] x [m, d] -> [n, m]``, clamped at 0."""
    d2 = _sq_norms(x)[:, None] + _sq_norms(y)[None, :] - 2.0 * dot_f32(x, y)
    return torch.clamp_min(d2, 0.0)


def euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sqeuclidean(x, y))


def cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine *distance* (1 - cos similarity)."""
    return 1.0 - dot_f32(l2_normalize(x), l2_normalize(y))


def inner_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise inner-product *distance* (1 - dot), hnswlib's IP convention."""
    return 1.0 - dot_f32(x, y)


def cdist(x, y, metric: Metric = Metric.EUCLIDEAN) -> torch.Tensor:
    """Pairwise distance dispatch.  For EUCLIDEAN this returns *squared* L2,
    which is rank-equivalent; callers needing true L2 should sqrt."""
    metric = parse_metric(metric)
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    if metric == Metric.COSINE:
        return cosine(x, y)
    if metric == Metric.INNER_PRODUCT:
        return inner_product(x, y)
    return sqeuclidean(x, y)


def top_k(dists, k: int):
    """Smallest-``k`` per row: ``(dists[n, k], idx[n, k])`` sorted ascending,
    ties to the lower index."""
    dists = torch.as_tensor(dists)
    k = min(int(k), dists.shape[-1])
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]
