"""Sharded search on one process — the port of `annlite_tpu/parallel/mesh.py`.

The JAX package lays a `jax.sharding.Mesh` over its chips and runs each
search as one `shard_map` program: the codes or rows sharded on N, queries
and tables replicated, a local top-k on every chip, and an `all_gather` of
the k winners merged by a last top-k, so the traffic between chips is
O(P·Q·k), never O(Q·N).  Here one process drives a list of shard devices
(:class:`Mesh`): a sharded tensor is a list of per-shard tensors, each on its
shard's device, and a search runs the port's own single-device step on every
shard (the kernels of `ops/`), then moves the ``[Q, k]`` winners to the first
device and merges them (:func:`_merge_topk`).  Several shards may share one
card: their launches queue on its stream back to back.

Every shard's work is queued before the first host synchronisation (no
``.item()``, ``.cpu()`` or ``.tolist()`` per shard), so shards on several
cards overlap; the vector-scored beam reads its loop condition on the host
every few iterations (`ops/beam.py`), the one exception.

Also the data-parallel Lloyd step (:func:`sharded_lloyd_step`): per-shard
centroid sums and counts, summed on the first device (the ``psum``).
"""
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..codecs.kmeans import _centroid_update, _onehot_sums, _pairwise_sq
from ..device import resolve_device
from ..enums import Metric
from ..index.graph import _rerank, _sample_entries
from ..math import dot_f32
from ..ops import BIG
from ..ops.adc import adc_scores
from ..ops.beam import beam_search_pq, beam_search_vectors
from ..ops.ivf import ivf_scan_topk
from ..ops.scan import scan_topk
from ..ops.topk import topk

SHARD_AXIS = 'shard'
# virtual shards of a CPU mesh by default: the JAX suite's 8 CPU devices
CPU_SHARDS = 8

Sharded = Sequence[torch.Tensor]


class Mesh:
    """P shards, one ``torch.device`` each; a device may hold several."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        if not devices:
            raise ValueError('a mesh needs at least one shard')
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f'Mesh({[str(d) for d in self.devices]})'


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """``n_devices`` shards on ``device`` (``None`` means the card).  On CUDA
    the default is one shard per visible card, and more shards than cards go
    round-robin over them (``make_mesh(4, 'cuda')`` on one card: 4 shards on
    ``cuda:0``); a device with an index keeps every shard on that card.  On
    the CPU the shards are virtual, :data:`CPU_SHARDS` by default."""
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return Mesh([dev] * (CPU_SHARDS if n_devices is None else n_devices))
    cards = ([dev] if dev.index is not None else
             [torch.device('cuda', i) for i in range(torch.cuda.device_count())])
    n = len(cards) if n_devices is None else n_devices
    return Mesh([cards[i % len(cards)] for i in range(n)])


def _place(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``a`` on ``device`` (never a view of the host
    array, which keeps changing)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _split(mesh: Mesh, x: np.ndarray, axis: int) -> List[torch.Tensor]:
    """``x`` cut into P equal pieces along ``axis``, one per shard."""
    return [_place(part, dev)
            for part, dev in zip(np.split(x, mesh.size, axis=axis), mesh.devices)]


def _padded_codes(codes_t: np.ndarray, n_shards: int) -> np.ndarray:
    """Transposed codes ``[M, N]`` padded with zero codes to a multiple of
    ``n_shards`` columns."""
    n = codes_t.shape[1]
    n_pad = -(-n // n_shards) * n_shards
    return codes_t if n_pad == n else np.pad(codes_t, ((0, 0), (0, n_pad - n)))


def _padded_mask(mask: np.ndarray, n_pad: int) -> np.ndarray:
    """An int8 row mask padded with 0 to ``n_pad`` rows."""
    out = np.zeros(n_pad, dtype=np.int8)
    out[: len(mask)] = np.asarray(mask).astype(np.int8)
    return out


def shard_codes(mesh: Mesh, codes_t: np.ndarray) -> List[torch.Tensor]:
    """Transposed codes ``[M, N]`` with N sharded over the mesh (N padded with
    zero codes to a multiple of P): one ``[M, N/P]`` tensor per shard."""
    return _split(mesh, _padded_codes(codes_t, mesh.size), 1)


def shard_mask(mesh: Mesh, mask: np.ndarray, n_pad: int) -> List[torch.Tensor]:
    """An int8 row mask padded with 0 to ``n_pad`` rows, sharded on N."""
    return _split(mesh, _padded_mask(mask, n_pad), 0)


def shard_rows(mesh: Mesh, x: np.ndarray, n_pad: Optional[int] = None,
               pad_value=0) -> List[torch.Tensor]:
    """A row-major array ``[N, ...]`` (or ``[N]``) with N sharded over the
    mesh, padded with ``pad_value`` to ``n_pad`` rows (by default the next
    multiple of P)."""
    x = np.asarray(x)
    n = x.shape[0]
    if n_pad is None:
        n_pad = -(-n // mesh.size) * mesh.size
    if n_pad != n:
        x = np.pad(x, ((0, n_pad - n),) + ((0, 0),) * (x.ndim - 1),
                   constant_values=pad_value)
    return _split(mesh, x, 0)


def replicate(mesh: Mesh, x) -> List[torch.Tensor]:
    """``x`` (numpy or a tensor) on every shard's device: one tensor per
    shard, copied once to each device and shared by its shards."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    on = {}
    for dev in mesh.devices:
        if dev not in on:
            on[dev] = t.to(dev)
    return [on[dev] for dev in mesh.devices]


def _per_shard(mesh: Mesh, x) -> Sharded:
    """A sharded argument as given, or a replicated one from ``x``."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f'{len(x)} shards given to a mesh of {mesh.size}')
        return x
    return replicate(mesh, x)


def _merge_topk(mesh: Mesh, d: Sharded, gidx: Sharded, k: int):
    """Each shard's ``[Q, k]`` candidates moved to the first device and
    concatenated in shard order, then the best ``k``: a stable sort, so ties
    go to the lower shard, as ``lax.top_k`` keeps the lower index of the
    gathered row.  The merge every sharded search ends in."""
    dev = mesh.devices[0]
    d_all = torch.cat([t.to(dev) for t in d], dim=1)
    i_all = torch.cat([t.to(dev) for t in gidx], dim=1)
    vals, pos = topk(d_all, k)
    return vals, torch.gather(i_all, 1, pos)


def sharded_adc_topk(mesh: Mesh, dtable, codes_t: Sharded, mask: Sharded, k: int,
                     first_shard: int = 0):
    """Distributed masked ADC search: per shard the full ADC scores (K5,
    `ops/adc.py` ``adc_scores``) and an exact top-k, global row
    ``idx + (first_shard + shard) * local_n``, then the merge.

    dtable ``[Q, M, K]`` replicated (or one tensor); codes_t ``[M, N]`` and
    mask ``[N]`` sharded on N.  ``first_shard`` is the global number of this
    mesh's first shard (nonzero on the later hosts of a hybrid mesh).
    Returns ``(dists [Q, k], global_idx [Q, k])`` on the first device."""
    dtable = _per_shard(mesh, dtable)
    ds, gs = [], []
    for s, (dt, ct, mk) in enumerate(zip(dtable, codes_t, mask)):
        d, idx = topk(adc_scores(dt, ct, mk), k)
        ds.append(d)
        gs.append(idx + (first_shard + s) * ct.shape[1])
    return _merge_topk(mesh, ds, gs, k)


def sharded_scan_topk(mesh: Mesh, q, x_scan: Sharded, row_scale: Sharded,
                      norms_sq: Sharded, mask: Sharded, x_f32: Sharded, k: int,
                      metric, rerank: Optional[int] = None):
    """Distributed quantized flat search: per shard `ops/scan.py`
    ``scan_topk`` with the exact rerank over the shard's float32 rows (the
    fused K1/K2 scan and K3 rerank where the shard's geometry allows), global
    row ``idx + shard * local_n`` (-1 for a slot at ``BIG``), then the merge.

    q ``[Q, D]`` replicated (or one tensor); the rest row-sharded on N.
    Returns exact ``(dists [Q, k], global_idx [Q, k])`` on the first device."""
    if rerank is None:
        rerank = max(4 * k, 32)
    q = _per_shard(mesh, q)
    local_n = x_scan[0].shape[0]
    r = min(rerank, local_n)
    kk = min(k, r)
    ds, gs = [], []
    for s, (qs, xs, rs, ns, mk, xf) in enumerate(
            zip(q, x_scan, row_scale, norms_sq, mask, x_f32)):
        d, idx = scan_topk(qs, xs, rs, ns, mk, kk, metric, x_f32=xf, rerank=r)
        ds.append(d)
        gs.append(torch.where(d >= BIG, -1, idx.long() + s * local_n))
    return _merge_topk(mesh, ds, gs, kk)


def sharded_ivf_topk(
    mesh: Mesh,
    sel_local: Sharded,      # per shard [S] (or [1, S]) LOCAL block ids, pad -1
    dtable,                  # [Q, M, K] replicated
    codes_blocks: Sharded,   # per shard [n_blocks/P, M, BS] u8/u16
    mask_blocks: Sharded,    # per shard [n_blocks/P, BS] int8
    row_map: Sharded,        # per shard [n_blocks/P, BS] int32 GLOBAL rows
    k: int,
    *,
    queries=None,            # [Q, D] replicated float32 (for the rerank)
    vec_blocks: Optional[Sharded] = None,  # per shard [n_blocks/P, BS, D]
    rerank: int = 0,
    metric=None,
):
    """Distributed probed-block IVF-PQ search: each shard scans only its
    probed blocks with `ops/ivf.py` ``ivf_scan_topk`` (K6 + ``lane8_merge``
    at 16 or more selections, else K7), optionally reranks its shortlist
    against its slot-major vectors in float32 (never TF32), then the merge.
    A shard given only -1 selections returns ``BIG`` / -1.  The JAX
    function's ``exact`` switch has no counterpart: both top-k branches are
    exact here (`ops/topk.py`).  Returns ``(dists [Q, k], rows [Q, k])`` on
    the first device."""
    do_rerank = rerank > 0 and vec_blocks is not None and queries is not None
    euclidean = metric is not None and int(metric) == int(Metric.EUCLIDEAN)
    dtable = _per_shard(mesh, dtable)
    q = _per_shard(mesh, queries) if do_rerank else [None] * mesh.size
    vb = vec_blocks if do_rerank else [None] * mesh.size
    ds, rs = [], []
    for sel, dt, cb, mb, rm, qs, v in zip(sel_local, dtable, codes_blocks, mask_blocks,
                                          row_map, q, vb):
        sel = sel.reshape(-1)
        kk = min(max(k, rerank) if do_rerank else k, sel.shape[0] * cb.shape[2])
        if do_rerank:
            d, rows, blks, slots = ivf_scan_topk(sel, dt, cb, mb, rm, kk, return_addr=True)
            cvec = v[blks, slots].float()  # [Q, kk, D]
            if euclidean:
                rd = torch.sum((qs[:, None, :] - cvec) ** 2, dim=-1)
            else:
                rd = 1.0 - dot_f32(qs[:, None, :], cvec)[:, 0, :]
            d, pos = topk(torch.where(d < BIG / 2, rd, BIG), min(k, kk))
            rows = torch.gather(rows, 1, pos)
        else:
            d, rows = ivf_scan_topk(sel, dt, cb, mb, rm, kk)
        ds.append(d)
        rs.append(torch.where(d < BIG / 2, rows.long(), -1))
    return _merge_topk(mesh, ds, rs, k)


def sharded_beam_topk(
    mesh: Mesh,
    adjacency: Sharded,   # per shard [cap, W] int32 LOCAL node ids, pad -1
    vectors: Sharded,     # per shard [cap, D] traversal/rerank vectors
    medoids: Sharded,     # per shard [1] int32 entry point
    queries,              # [Q, D] replicated float32
    metric_euclidean: bool,
    k: int,
    *,
    L: int = 64,
    B: int = 16,
    rerank: int = 0,
    codes: Optional[Sharded] = None,   # per shard [cap, M] u8/u16 (PQ traversal)
    dtable=None,                       # [Q, M, K] replicated (PQ traversal)
    alive: Optional[Sharded] = None,   # per shard [cap] int8, 0 = soft-deleted
    sample_vecs: Optional[Sharded] = None,  # per shard [S, D] entry samples
    sample_ids: Optional[Sharded] = None,   # per shard [S] int32 LOCAL ids
    entry_width: int = 8,
):
    """Distributed graph serving: each shard beams over its own sub-graph
    (`ops/beam.py` ``beam_search_pq``, one ``beam_pq`` launch on the card,
    when ``codes``/``dtable`` are given, else ``beam_search_vectors``),
    seeded with its nearest ``entry_width`` sampled nodes (clamped to the
    shard's sample) or its medoid, masks dead nodes, reranks locally, then
    the merge.  Global ids are round-robin: ``local * P + shard``."""
    use_pq = codes is not None and dtable is not None
    has_sample = sample_vecs is not None and sample_ids is not None
    p = mesh.size
    q = _per_shard(mesh, queries)
    dt = _per_shard(mesh, dtable) if use_pq else [None] * p
    ef = max(L, 4 * k)
    ds, gs = [], []
    for s in range(p):
        adj, qs = adjacency[s], q[s]
        cap = adj.shape[0]
        if has_sample:
            entry = _sample_entries(sample_vecs[s], sample_ids[s], qs, metric_euclidean,
                                    entry_width)
        else:
            entry = medoids[s].reshape(1, 1).to(torch.int32).expand(qs.shape[0], 1)
        if use_pq:
            d, ids = beam_search_pq(adj, entry, codes[s], dt[s], k=ef, L=ef, B=B)
        else:
            d, ids = beam_search_vectors(adj, entry, vectors[s], qs, metric_euclidean,
                                         k=ef, L=ef, B=B)
        valid = (ids >= 0) & (ids < cap)
        if alive is not None:
            valid = valid & (alive[s][torch.where(valid, ids, 0).long()] > 0)
        d = torch.where(valid, d, BIG)
        if rerank > 0:
            d, ids = _rerank(qs, ids, d, vectors[s], metric_euclidean, rerank, k)
        else:
            d, pos = topk(d, k)
            ids = torch.gather(ids, 1, pos)
        ds.append(d)
        gs.append(torch.where(d < BIG / 2, ids.long() * p + s, -1))
    return _merge_topk(mesh, ds, gs, k)


def _lloyd_stats(mesh: Mesh, x_sharded: Sharded, centroids):
    """Per-shard ``(sums [k, d], counts [k], inertia)`` of one Lloyd
    assignment, summed on the first device in shard order."""
    c = _per_shard(mesh, centroids)
    dev = mesh.devices[0]
    sums = counts = inertia = None
    for xs, cs in zip(x_sharded, c):
        d2 = _pairwise_sq(xs, cs)
        n, s = _onehot_sums(torch.argmin(d2, dim=-1), xs, cs.shape[0])
        parts = (s.to(dev), n.to(dev), torch.sum(torch.amin(d2, dim=-1)).to(dev))
        if sums is None:
            sums, counts, inertia = parts
        else:
            sums, counts, inertia = sums + parts[0], counts + parts[1], inertia + parts[2]
    return sums, counts, inertia


def sharded_lloyd_step(mesh: Mesh, x_sharded: Sharded, centroids):
    """One data-parallel k-means step: assignments per shard
    (`codecs/kmeans.py` ``_pairwise_sq``, ``_onehot_sums``), centroid sums
    and counts summed on the first device.  Returns ``(new_centroids [k, d],
    inertia)`` there; padding rows count as rows, as in the JAX step."""
    sums, counts, inertia = _lloyd_stats(mesh, x_sharded, centroids)
    c0 = _per_shard(mesh, centroids)[0]
    return _centroid_update(counts, sums, c0.to(mesh.devices[0])), inertia
