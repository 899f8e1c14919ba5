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
packed-neighbour layout.  On the card a PQ search is one kernel,
``beam_pq`` (`csrc/beam_pq.cu`): one CTA runs one query's whole loop, seed,
frontier, expansion, table lookups and both merge sorts, with the table and
the list in shared memory (:func:`beam_pq_kernel`; its plain twin, which
follows its algorithm step by step, is :func:`_beam_pq_ref`).  A geometry
whose sort buffer exceeds :data:`MAX_SORT` slots keeps the eager loop
around K8 (:func:`beam_pq_plan` decides).  The other traversals run the
eager loop: its sorts, gathers and cumsum are PyTorch's.
"""
from typing import NamedTuple, Optional

import torch

from ..math import dot_f32
from ..profile import count, wait
from . import BIG, _ext
from .adc import _code_bytes, _lut_pq_scores_ref, lut_pq_scores

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
    ran = 0
    for i in range(iters):
        # the JAX loop's condition, read every few iterations (see above)
        if i % _CHECK_EVERY == 0:
            frontier = ((exp == 0) & (d < BIG)).any()
            with wait():
                more = bool(frontier)
            del frontier  # freed before the iteration's work, as a temporary was
            if not more:
                break
        ran += 1
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
    count('graph.iters', ran)
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


# ---------------------------------------------------------------------------
# the PQ search as one kernel (beam_pq)
# ---------------------------------------------------------------------------

# The most slots of the kernel's sort buffer: P = next_pow2(L + B*R) above
# it (ef 4096 at B 8, R 32, say) keeps the eager loop around K8.  At the
# ceiling the state takes 96 KB of shared memory, beside a 64 KB table.
MAX_SORT = 4096
SMEM_LIMIT = 232448  # 227 KB: what a CTA of an H100 may use


class BeamPqPlan(NamedTuple):
    """Launch geometry of ``beam_pq``: ``sort_len`` slots of each sort
    buffer, ``threads`` per CTA, the table in shared memory or read from
    global memory (L2), and the CTA's dynamic shared memory in bytes."""
    sort_len: int
    threads: int
    table_in_smem: bool
    smem_bytes: int


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _sort_len(L: int, B: int, R: int) -> int:
    """Slots of ``beam_pq``'s sorts: the list and one iteration's new
    entries, rounded up to a power of two, at least 64 (a warp's keys)."""
    return max(64, _next_pow2(L + B * R))


def beam_pq_plan(L: int, B: int, R: int, M: int, K: int) -> Optional[BeamPqPlan]:
    """The plan of one PQ search in one ``beam_pq`` launch, or None where
    the sort buffer would exceed :data:`MAX_SORT` slots (the search then
    takes the eager loop around K8).  The layout is ``csrc/beam_pq.cu``'s:
    the table (when it fits, and its rows of M * K floats are whole 16-byte
    copies; otherwise it is read from L2), 24 bytes per sort slot, the
    selection of B ids and its count, one mbarrier.  Each thread holds two
    of the sort's keys in registers, four or eight above 1,024 slots (at
    most 512 threads)."""
    B = min(B, L)
    p = _sort_len(L, B, R)
    if p > MAX_SORT:
        return None
    state = 24 * p + (B + 2) // 2 * 8 + 8
    table = (4 * M * K + 15) // 16 * 16
    in_smem = table + state <= SMEM_LIMIT and (M * K) % 4 == 0
    threads = p // max(2, p // 512)
    return BeamPqPlan(p, threads, in_smem, state + (table if in_smem else 0))


def _f32_order_key(d: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving uint32 image of float32 ``d`` (-0.0
    folded to +0.0), as int64."""
    bits = torch.where(d == 0, torch.zeros_like(d), d).view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >= 2**31, 0xFFFFFFFF - bits, bits + 2**31)


def _beam_pq_ref(adjacency, entry_ids, codes, dtable, L, B, iters, k):
    """Plain twin of ``beam_pq``: its algorithm step by step, one query at a
    time, with ``_lut_pq_scores_ref`` as the scorer.  Each query stops at
    its first iteration without a frontier; each stable sort is a sort of
    unique composite keys ``value * P + position`` over ``P`` slots
    (:func:`_sort_len`), the padding after every real key.  Returns
    ``(d [Q, k], ids [Q, k], iterations [Q])``; the eager loop's answer."""
    n, r = adjacency.shape
    q, e = entry_ids.shape
    p = _sort_len(L, B, r)
    pad = torch.full((p,), 1 << 62, dtype=torch.int64)
    slot = torch.arange(p, dtype=torch.int64)
    big = torch.tensor(BIG, dtype=torch.float32)

    def sort_keys(hi):  # sorted composite keys over p slots, the real ones
        return torch.sort(torch.cat([hi * p + slot[:len(hi)], pad[len(hi):]])).values[:len(hi)]

    out_d, out_ids, out_it = [], [], []
    for qi in range(q):
        def score(ids):
            return _lut_pq_scores_ref(ids[None], codes, dtable[qi:qi + 1])[0]

        eids = entry_ids[qi].to(torch.int32)
        d = torch.cat([score(eids), big.expand(L - e)])
        dk = torch.cat([torch.where(d[:e] < BIG, eids, NO_ID).long(),
                        torch.full((L - e,), NO_ID, dtype=torch.int64)]) * 2 + 1
        order = sort_keys(_f32_order_key(d)) % p  # the seed: by d
        d, dk = d[order], dk[order]
        it = 0
        while it < iters:
            cand = ((dk & 1) == 1) & (d < BIG)
            chosen = cand.nonzero()[:B, 0]
            if len(chosen) == 0:
                break
            sel = dk[chosen] >> 1
            dk[chosen] -= 1  # exp = 1
            nbrs = torch.cat([adjacency[sel].reshape(-1).to(torch.int32),
                              torch.full(((B - len(chosen)) * r,), -1, dtype=torch.int32)])
            nd = score(nbrs)
            ndk = torch.where(nd < BIG, nbrs, NO_ID).long() * 2 + 1
            all_d, all_dk = torch.cat([d, nd]), torch.cat([dk, ndk])
            key1 = sort_keys(all_dk)  # stable by dkey
            dk1, pos1 = key1 // p, key1 % p
            id1 = dk1 >> 1
            dup = torch.cat([torch.zeros(1, dtype=torch.bool), id1[1:] == id1[:-1]])
            d1 = torch.where(dup | (id1 >= NO_ID), big, all_d[pos1])
            j = sort_keys(_f32_order_key(d1))[:L] % p  # stable by d
            d, dk = d1[j], dk1[j]
            it += 1
        out_d.append(d[:k])
        out_ids.append((dk[:k] >> 1).to(torch.int32))
        out_it.append(it)
    return torch.stack(out_d), torch.stack(out_ids), torch.tensor(out_it, dtype=torch.int32)


def beam_pq_kernel(adjacency, entry_ids, codes, dtable, k: int, L: int, B: int, iters: int):
    """Launch ``beam_pq`` (`csrc/beam_pq.cu`): the whole PQ beam search of
    every query, one CTA each -> ``(d [Q, k], ids [Q, k], iterations [Q])``
    as :func:`_beam_pq_ref`.  ``adjacency [N, R]`` int32, ``entry_ids [Q,
    E]`` int32 (E <= L), ``codes [N, M]`` u8/u16, ``dtable [Q, M, K]``
    float32, all contiguous on the card; B <= L, k <= L.  Raises beyond the
    sort ceiling (:func:`beam_pq_plan`)."""
    for t in (adjacency, entry_ids, codes, dtable):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError('beam_pq: expected contiguous CUDA tensors')
    n, r = adjacency.shape
    q, e = entry_ids.shape
    _, m, kc = dtable.shape
    if (adjacency.dtype != torch.int32 or entry_ids.dtype != torch.int32
            or dtable.dtype != torch.float32 or dtable.shape[0] != q or codes.dim() != 2
            or codes.shape != (n, m) or not 1 <= e <= L or not 1 <= B <= L
            or not 1 <= k <= L or iters < 0 or q == 0):
        raise ValueError('beam_pq: unsupported inputs')
    _check_corpus_fits(n)
    plan = beam_pq_plan(L, B, r, m, kc)
    if plan is None:
        raise ValueError(f'beam_pq: a sort buffer of more than {MAX_SORT} slots')
    dev = dtable.device
    d = torch.empty((q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    its = torch.empty((q,), dtype=torch.int32, device=dev)
    lib = _ext.library('beam_pq')
    with torch.cuda.device(dev):
        _ext.check(lib.annlite_beam_pq(
            adjacency.data_ptr(), entry_ids.data_ptr(), codes.data_ptr(), dtable.data_ptr(),
            d.data_ptr(), ids.data_ptr(), its.data_ptr(), n, r, e, m, kc, q, L, B, iters, k,
            _code_bytes(codes), plan.sort_len, plan.threads, int(plan.table_in_smem),
            _ext.stream_ptr(dtable)), 'beam_pq')
    count('launch.beam_pq')
    return d, ids, its


def beam_search_pq(
    adjacency, entry_ids, codes, dtable,
    k: int = 10, L: int = 64, B: int = 16, iters: Optional[int] = None,
):
    """ADC beam search over PQ codes [N, M] with per-query table [Q, M, K].
    On the CPU the eager loop with the plain scorer; on the card one
    ``beam_pq`` launch, or, beyond its sort ceiling, the eager loop around
    K8 (:func:`beam_pq_plan`)."""
    _check_corpus_fits(adjacency.shape[0])
    B = min(B, L)
    iters = _resolve_iters(iters, L, B)
    if adjacency.device.type == 'cpu' or beam_pq_plan(
            L, B, adjacency.shape[1], codes.shape[1], dtable.shape[2]) is None:
        return _beam_loop(adjacency, entry_ids, L, B, iters, k, make_pq_scorer(codes, dtable))
    d, ids, _ = beam_pq_kernel(adjacency.to(torch.int32).contiguous(),
                               entry_ids.to(torch.int32).contiguous(), codes.contiguous(),
                               dtable.float().contiguous(), k, L, B, iters)
    return d, ids


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
