"""Top-k reduction — the port of `annlite_tpu/ops/topk.py`.

The JAX package has two strategies: an exact ``lax.top_k`` and a refined
``approx_min_k``.  On the CPU ``approx_min_k`` is exact, and the port holds
itself to that: both branches here are one exact stable ascending sort, so
ties go to the lower index as with ``lax.top_k``.  The port's large
reductions happen inside the scan kernel (`ops/fused_scan.py`), which leaves
a sort of at most ``[Q, N/32]`` candidates here.
"""
import torch


def exact_topk(scores: torch.Tensor, k: int):
    vals, idx = torch.sort(scores, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def topk(scores: torch.Tensor, k: int):
    """The JAX function's ``exact`` switch has no counterpart: both of its
    branches are exact here."""
    k = min(k, scores.shape[-1])
    return exact_topk(scores, k)
