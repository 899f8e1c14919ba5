"""Batched RobustPrune (DiskANN Alg. 2) — the port of `annlite_tpu/ops/prune.py`.

The prune for a whole batch of points runs as one sequence of tensor ops:
pools arrive as fixed-width ``[P, L]`` id and distance tensors with member
vectors ``[P, L, D]``, the member-to-member distances are one batched
float32 product (``math.dot_f32``, TF32 refused), and the greedy diversity
selection is an ``R``-step loop over ``[P, L]`` masks.

Selection contract (that of the JAX function and of `csrc/vamana.cpp`):
- ids < 0 and the point itself are dropped; of duplicate ids one copy is
  kept (the nearest);
- members are visited in ascending distance to the point, ties by id;
- a selected member eliminates every later candidate ``j`` with
  ``alpha * d(sel, j) <= d(p, j)``;
- after ``R`` steps the remaining slots are filled with the nearest
  surviving candidates (saturation), then padded with -1.

What the JAX function does in TPU forms, the port does in their natural
forms, with the same results: the vectors are reordered by a gather, not a
permutation matmul, and a pick's row of the pairwise matrix is a row gather,
not a one-hot product (both forms are exact).  Every sort whose order
matters is a stable ``torch.sort``; the JAX two-key sort ``(id, d)`` is two
stable passes (by ``d``, then by id).
"""
import torch

from ..math import dot_f32
from . import BIG
from .beam import NO_ID


def _pairwise(vecs: torch.Tensor, metric_ip: bool) -> torch.Tensor:
    """``[P, L, D] -> [P, L, L]`` member-to-member distances: one batched
    float32 product (``1 - dot``, or ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0)."""
    dots = dot_f32(vecs, vecs)
    if metric_ip:
        return 1.0 - dots
    n2 = torch.sum(vecs * vecs, dim=-1)
    return torch.clamp_min(n2[:, :, None] + n2[:, None, :] - 2.0 * dots, 0.0)


def _sort_rows(key: torch.Tensor, *cols: torch.Tensor):
    """Stable ascending sort of each row by ``key``, carrying ``cols``."""
    key_s, order = torch.sort(key, dim=1, stable=True)
    return (key_s,) + tuple(torch.gather(c, 1, order) for c in cols)


def robust_prune_batch(
    pool_ids: torch.Tensor,   # [P, L] int32, pad/invalid < 0
    pool_d: torch.Tensor,     # [P, L] float32 distance point -> member
    pool_vecs: torch.Tensor,  # [P, L, D] float32 member vectors (junk rows ok where invalid)
    self_ids: torch.Tensor,   # [P] int32 the point being pruned
    alpha: float,
    r: int,
    metric_ip: bool = False,
    saturate: bool = True,
) -> torch.Tensor:
    """Prune each pool to ``<= r`` diverse out-neighbours -> ids ``[P, r]``
    int32 (pad -1).  Pools may contain duplicates and the point itself; both
    are dropped."""
    p, l = pool_ids.shape
    dev = pool_ids.device
    ids = torch.where(pool_ids >= 0, pool_ids.to(torch.int32), NO_ID)
    ids = torch.where(ids == self_ids.to(torch.int32)[:, None], NO_ID, ids)
    d = torch.where(ids < NO_ID, pool_d.float(), BIG)
    lane = torch.arange(l, device=dev).expand(p, l)

    # dedup by id (one copy: the nearest), then order by distance
    d1, ids1, lane1 = _sort_rows(d, ids, lane)
    ids_s, d_s, lane_s = _sort_rows(ids1, d1, lane1)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    d_s = torch.where(dup | (ids_s >= NO_ID), BIG, d_s)
    d_o, ids_o, lane_o = _sort_rows(d_s, ids_s, lane_s)

    vecs_o = torch.gather(pool_vecs.float(), 1,
                          lane_o[:, :, None].expand(p, l, pool_vecs.shape[2]))
    pw = _pairwise(vecs_o, metric_ip)  # [P, L, L]

    valid = d_o < BIG
    iota = torch.arange(l, device=dev)[None, :]
    rows = torch.arange(p, device=dev)
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    selected = torch.zeros((p, l), dtype=torch.bool, device=dev)
    removed = torch.zeros_like(selected)
    for _ in range(r):
        avail = valid & ~selected & ~removed
        # pools are d-ascending: the first available lane is the closest
        i_star = torch.argmax(avail.to(torch.uint8), dim=1)
        any_avail = avail.any(dim=1)
        pick = (iota == i_star[:, None]) & any_avail[:, None]
        selected = selected | pick
        # eliminate the candidates the pick alpha-dominates
        prow = pw[rows, i_star]  # [P, L]
        dominated = (alpha_t * prow <= d_o) & any_avail[:, None]
        removed = removed | (dominated & ~selected)

    # selected (d-ascending), then, saturating, the surviving candidates by
    # distance; invalid last: a stable sort on the group keeps the d order
    rest = torch.where(valid, 1, 2) if saturate else torch.full_like(ids_o, 2)
    group = torch.where(selected, 0, rest).to(torch.int32)
    _, ids_f = _sort_rows(group, ids_o)
    keep_n = torch.sum(group < 2, dim=1)
    out = ids_f[:, :r]
    out = torch.where(torch.arange(out.shape[1], device=dev)[None, :] < keep_n[:, None], out, -1)
    return torch.where(out >= NO_ID, -1, out).to(torch.int32)
