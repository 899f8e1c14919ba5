"""Batched best-first beam search over a dense adjacency — the port of
`annlite_tpu/ops/beam.py`.

Every query keeps a fixed-width distance-sorted candidate list ``[Q, L]``;
each iteration expands the best ``B`` unexpanded nodes, gathers their
neighbour rows from the adjacency ``[N, R]`` (pad -1), scores all ``B*R``
neighbours at once and merges by sort.  The contracts of the JAX loop are
kept exactly, so that the two packages return the same ids and distances on
the same graph:

- every multi-operand ``lax.sort`` with one key is stable; here it is a
  stable ``torch.sort`` of the key plus gathers of the payload columns;
- duplicates are removed by an id sort with the key ``id*2 + (1-exp)``, so
  the expanded copy of a node wins;
- empty slots hold the id ``NO_ID`` and a distance ``>= BIG``;
- the result is a slice of the distance-sorted list.

The loop's condition (an iteration budget, and some unexpanded node left)
needs the device's answer on the host.  An iteration without a frontier
changes nothing (the two stable sorts reproduce the list as it was), so the
port reads the condition only every ``_CHECK_EVERY`` iterations: one host
synchronisation per few iterations instead of one per iteration, and the
same result as the JAX loop.

Scorers: full-precision rows, the int8 row-quantized copy, PQ codes with a
per-query table (K8, `ops/adc.py` ``lut_pq_scores``) and the
packed-neighbour layout.  The loop itself has no kernel: its sorts, gathers
and cumsum are PyTorch's.
"""
from typing import Optional

import torch

from ..math import dot_f32
from . import BIG
from .adc import lut_pq_scores

# Sentinel id for empty slots.  Must sort after any real id AND keep the
# dedup key ``id*2 + 1`` inside int32 (hence 2**29, not 2**30).
NO_ID = 2**29
# iterations between two reads of the loop condition on the host
_CHECK_EVERY = 4


def _check_corpus_fits(n: int):
    """Real ids >= NO_ID would alias the empty-slot sentinel and be silently
    dropped — fail loudly instead (the dedup key id*2+1 caps ids at 2**29)."""
    if n >= NO_ID:
        raise ValueError(
            f'corpus of {n} rows exceeds the beam id ceiling ({NO_ID}); '
            f'shard the index below 2**29 rows'
        )


def _valid_safe(ids: torch.Tensor, n: int):
    valid = (ids >= 0) & (ids < n)
    return valid, torch.where(valid, ids, 0).long()


def _qc_dot(queries: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``einsum('qd,qcd->qc')`` in float32 (TF32 off, as ``dot_f32``)."""
    return dot_f32(queries[:, None, :], vecs)[:, 0, :]


def make_vector_scorer(vectors, queries, metric_euclidean: bool):
    """Full-precision scorer: ids [Q, C] -> dists [Q, C].  ``vectors`` may be
    bf16; masked ids (< 0 or >= N) score BIG."""
    n = vectors.shape[0]

    def score(ids):
        valid, safe = _valid_safe(ids, n)
        vecs = vectors[safe].float()  # [Q, C, D]
        if metric_euclidean:
            d = torch.sum((queries[:, None, :] - vecs) ** 2, dim=-1)
        else:
            d = 1.0 - _qc_dot(queries, vecs)
        return torch.where(valid, d, BIG)

    return score


def make_int8_scorer(vecs_i8, scales, norms, queries, metric_euclidean: bool):
    """Quantized traversal scorer: ids [Q, C] -> approx dists [Q, C] from
    the int8 row-quantized copy ``vecs_i8 [N, D]`` (per-row ``scales``; for
    L2 the true float32 ``norms``).  The JAX scorer multiplies in bf16 with
    float32 sums: the queries are rounded to bf16 here too, and the int8
    values are exact in it.  Approximate: rerank the returned pool."""
    n = vecs_i8.shape[0]
    qb = queries.to(torch.bfloat16).float()
    qn = torch.sum(queries * queries, dim=1)

    def score(ids):
        valid, safe = _valid_safe(ids, n)
        dots = _qc_dot(qb, vecs_i8[safe].float()) * scales[safe]
        if metric_euclidean:
            d = qn[:, None] + norms[safe] - 2.0 * dots
        else:
            d = 1.0 - dots
        return torch.where(valid, d, BIG)

    return score


def make_pq_scorer(codes, dtable):
    """ADC scorer over the rows' codes: ids [Q, C] -> dists [Q, C].
    ``codes [N, M]`` row-major u8/u16, ``dtable [Q, M, K]``.  On the card one
    launch of K8 gathers, scores and masks."""
    dtable = dtable.float().contiguous()

    def score(ids):
        return lut_pq_scores(ids, codes, dtable)

    return score


def _sort_by(key: torch.Tensor, *cols: torch.Tensor):
    """``lax.sort((key, *cols), num_keys=1)``: a stable sort of ``key`` along
    the last axis carrying the payload columns."""
    key_s, perm = torch.sort(key, dim=1, stable=True)
    return (key_s, *(torch.gather(c, 1, perm) for c in cols))


def _sorted_seed(entry_ids, score_fn, L):
    """Score entry points, pad to L, and sort by distance."""
    q, e = entry_ids.shape
    d_entry = score_fn(entry_ids)
    ids0 = torch.where(d_entry < BIG, entry_ids.to(torch.int32), NO_ID)
    pad_ids = torch.full((q, L - e), NO_ID, dtype=torch.int32, device=ids0.device)
    pad_d = torch.full((q, L - e), BIG, dtype=torch.float32, device=ids0.device)
    ids0 = torch.cat([ids0, pad_ids], dim=1)
    d0 = torch.cat([d_entry, pad_d], dim=1)
    exp0 = torch.zeros((q, L), dtype=torch.int32, device=ids0.device)
    return _sort_by(d0, ids0, exp0)


def _beam_loop(adjacency, entry_ids, L, B, iters, k, score_fn, expand_fn=None):
    """``expand_fn(safe_sel [Q, B], sel_valid [Q, B]) -> (nbr_ids [Q, B*R],
    nbr_dists [Q, B*R])`` overrides the default expand step (adjacency
    gather + ``score_fn``): the packed-neighbour layout uses it."""
    q = entry_ids.shape[0]
    r = adjacency.shape[1]
    dev = adjacency.device
    d, ids, exp = _sorted_seed(entry_ids, score_fn, L)
    lane = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    slot = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    for i in range(iters):
        # the JAX loop's condition, read every few iterations (see above)
        if i % _CHECK_EVERY == 0 and not bool(((exp == 0) & (d < BIG)).any()):
            break
        # ---- frontier: first B unexpanded alive slots (list is d-sorted) --
        cand = (exp == 0) & (d < BIG)
        rank = torch.cumsum(cand.to(torch.int64), dim=1)  # 1-based
        sel = cand & (rank <= B)
        exp = exp | sel.to(torch.int32)
        skey = torch.where(sel, rank, B + 1 + lane)
        _, sel_ids = _sort_by(skey, ids)
        sel_ids = sel_ids[:, :B]
        sel_valid = slot < torch.clamp_max(rank[:, -1:], B)
        # ---- expand: gather neighbour rows -> [Q, B*R] ----
        safe_sel = torch.where(sel_valid, sel_ids, 0).long()
        if expand_fn is not None:
            nbrs, nd = expand_fn(safe_sel, sel_valid)
        else:
            nbrs = torch.where(sel_valid[:, :, None], adjacency[safe_sel], -1)
            nbrs = nbrs.reshape(q, B * r)
            nd = score_fn(nbrs)
        nbrs = torch.where(nd < BIG, nbrs.to(torch.int32), NO_ID)
        # ---- merge: dedup by id (expanded copy wins), re-sort by d, trim --
        all_ids = torch.cat([ids, nbrs], dim=1)
        all_d = torch.cat([d, nd], dim=1)
        all_exp = torch.cat([exp, torch.zeros_like(nbrs)], dim=1)
        dkey = all_ids * 2 + (1 - all_exp)  # same id adjacent, expanded first
        _, ids_s, d_s, exp_s = _sort_by(dkey, all_ids, all_d, all_exp)
        dup = torch.zeros_like(ids_s, dtype=torch.bool)
        dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
        d_s = torch.where(dup | (ids_s >= NO_ID), BIG, d_s)
        d2, ids2, exp2 = _sort_by(d_s, ids_s, exp_s)
        d, ids, exp = d2[:, :L], ids2[:, :L], exp2[:, :L]
    return d[:, :k], ids[:, :k]  # list is d-sorted: top-k is a slice


def _resolve_iters(iters, L, B):
    """Default iteration budget: enough to expand ~2L nodes (each iteration
    expands B), floored at 16 so narrow beams still converge."""
    return iters if iters is not None else max(2 * L // B, 16)


def beam_search_vectors(
    adjacency, entry_ids, vectors, queries, metric_euclidean: bool,
    k: int = 10, L: int = 64, B: int = 16, iters: Optional[int] = None,
):
    """Full-precision beam search.  adjacency [N, R] int32 (pad -1);
    entry_ids [Q, E]; returns (dists [Q, k], ids [Q, k]) — unreachable slots
    have id NO_ID.  ``L`` plays the role of hnswlib's ``ef``."""
    _check_corpus_fits(adjacency.shape[0])
    B = min(B, L)
    iters = _resolve_iters(iters, L, B)
    score = make_vector_scorer(vectors, queries.float(), bool(metric_euclidean))
    return _beam_loop(adjacency, entry_ids, L, B, iters, k, score)


def beam_search_vectors_bounded(
    adjacency, entry_ids, vectors, queries, n, metric_euclidean, L, B, iters, k
):
    """Beam search over a capacity-padded buffer: rows with id >= ``n`` are
    invalid (graph construction routes around the batch being inserted)."""
    _check_corpus_fits(adjacency.shape[0])
    base = make_vector_scorer(vectors, queries.float(), bool(metric_euclidean))

    def score(ids):
        return torch.where(ids < n, base(ids), BIG)

    return _beam_loop(adjacency, entry_ids, L, B, iters, k, score)


def beam_search_pq(
    adjacency, entry_ids, codes, dtable,
    k: int = 10, L: int = 64, B: int = 16, iters: Optional[int] = None,
):
    """ADC beam search over PQ codes [N, M] with per-query table [Q, M, K]."""
    _check_corpus_fits(adjacency.shape[0])
    B = min(B, L)
    iters = _resolve_iters(iters, L, B)
    return _beam_loop(adjacency, entry_ids, L, B, iters, k, make_pq_scorer(codes, dtable))


def beam_search_int8(
    adjacency, entry_ids, vecs_i8, scales, norms, queries,
    metric_euclidean: bool,
    k: int = 10, L: int = 64, B: int = 16, iters: Optional[int] = None,
):
    """Beam search scoring traversal with the int8 corpus copy (half the
    gather bytes of bf16).  Approximate — rerank the returned pool."""
    _check_corpus_fits(adjacency.shape[0])
    B = min(B, L)
    iters = _resolve_iters(iters, L, B)
    if norms is None:
        norms = scales  # placeholder with a gatherable shape (IP/cosine)
    score = make_int8_scorer(vecs_i8, scales, norms, queries.float(),
                             bool(metric_euclidean))
    return _beam_loop(adjacency, entry_ids, L, B, iters, k, score)


# ---------------------------------------------------------------------------
# packed-neighbour layout (DiskANN-style): one gathered row per EXPANDED node
# carries all R neighbour vectors, int8-quantized
# ---------------------------------------------------------------------------

def pack_neighbors(adjacency, vectors, need_norms: bool, chunk: int = 8192):
    """Layout transform for serving: ``packed[u] = int8(vectors[adj[u]])``
    flattened to ``[N, R*D]``, with per-neighbour ``scale [N, R]`` (and
    ``norms [N, R]`` for L2), on the device of ``vectors``.  One expansion
    then gathers B contiguous rows of R*D bytes instead of B*R scattered
    vector rows; it costs R times the corpus at int8.  The division by 127
    is a product with the float32 reciprocal, as XLA compiles it."""
    n, r = adjacency.shape
    d = vectors.shape[1]
    adjacency = torch.as_tensor(adjacency).to(vectors.device)
    outs, scales, norms = [], [], []
    for s in range(0, n, chunk):
        safe = torch.clamp(adjacency[s:s + chunk].long(), 0, vectors.shape[0] - 1)
        g = vectors[safe].float()  # [C, R, D]
        sc = torch.amax(torch.abs(g), dim=-1) * (1.0 / 127.0)  # [C, R]
        q8 = torch.clamp(torch.round(g / torch.clamp_min(sc, 1e-12)[..., None]),
                         -127, 127).to(torch.int8)
        outs.append(q8.reshape(safe.shape[0], r * d))
        scales.append(sc)
        if need_norms:
            norms.append(torch.sum(g * g, dim=-1))
    packed = torch.cat(outs)
    scale = torch.cat(scales)
    nrm = torch.cat(norms) if need_norms else None
    return packed, scale, nrm


def beam_search_packed(
    adjacency, entry_ids, packed, scale, norms, seed_vectors, queries,
    metric_euclidean: bool,
    k: int = 10, L: int = 64, B: int = 16, iters: Optional[int] = None,
):
    """Beam search over the packed-neighbour layout (`pack_neighbors`):
    expansion gathers ONE contiguous ``R*D``-byte row per expanded node
    instead of R scattered vector rows.  Traversal scores are int8-dequant
    approximations — pair with an exact rerank stage for final ranking."""
    _check_corpus_fits(adjacency.shape[0])
    B = min(B, L)
    iters = _resolve_iters(iters, L, B)
    queries = queries.float()
    q, r = entry_ids.shape[0], adjacency.shape[1]
    d = queries.shape[1]
    n = seed_vectors.shape[0]
    if metric_euclidean:
        q_norms = torch.sum(queries * queries, dim=1)
    else:
        q_norms = torch.zeros(q, dtype=torch.float32, device=queries.device)
        norms = scale  # unused placeholder with a gatherable shape
    seed_score = make_vector_scorer(seed_vectors, queries, bool(metric_euclidean))

    def expand(safe_sel, sel_valid):
        nbr_ids = torch.where(sel_valid[:, :, None], adjacency[safe_sel], -1)
        nbr_ids = nbr_ids.reshape(q, B * r)
        pv = packed[safe_sel].reshape(q, B * r, d).float()
        sc = scale[safe_sel].reshape(q, B * r)
        dots = _qc_dot(queries, pv) * sc
        if metric_euclidean:
            nd = q_norms[:, None] + norms[safe_sel].reshape(q, B * r) - 2.0 * dots
        else:
            nd = 1.0 - dots
        valid = (nbr_ids >= 0) & (nbr_ids < n)
        return nbr_ids, torch.where(valid, nd, BIG)

    return _beam_loop(adjacency, entry_ids, L, B, iters, k, seed_score, expand_fn=expand)
