"""Graph ANN index: Vamana construction + batched beam search on the card —
the port of `annlite_tpu/index/graph.py`.

Construction runs on the host in native code (``build_mode='host'``:
`csrc/vamana.cpp` through `index/vamana_lib.py`, a dense padded adjacency
``[N, R]``) or batched on the device (``build_mode='device'``:
`index/device_build.py`, a W-wide adjacency of R out-edges plus slack
back-edge columns, which serving traverses).  The search runs on the device
(`ops/beam.py`), scoring with the resident rows or, with a PQ codec, with
per-query ADC tables (K8), followed by an exact rerank over bf16 rows.  An
OPQ codec's tables are built from the rotated queries (the codec's
``dist_mat`` rotates them once); the rerank stays in the original space.

Filtered search: traversal still routes through every visited node.  The
traversal over the rows (``beam_search_vectors``) takes the predicate
inside: only passing rows enter the result list, which holds the best
passing rows of every row the search scored, as hnswlib's
``searchKnnWithFilter`` keeps them, so a list comes back full wherever the
walk scored ``limit`` passing rows.  The table, int8 and packed traversals
apply it at selection (masked candidates leave the ``ef`` list, as the
reference does for every traversal).  Below ``filter_fallback_selectivity``
a masked exact scan replaces the traversal (the reference's brute-force
fallback when candidates < limit; on the card `ops/masked_scan.py`'s
kernel, which reads the passing rows only).  Soft-deleted rows behave like
filtered ones.

A device-built index that is synced and streams appends or updates patches
its serving state (new codes only, fresh entry samples) instead of marking
itself dirty, which would re-encode every row at the next search.  Each
patch makes a new serving state and the builder never writes a buffer it
handed out in place, so a ``device_searcher`` keeps the state it was built
on.
"""
from dataclasses import dataclass, replace
from typing import Optional, Union

import numpy as np
import torch

from ..codecs import PQCodec
from ..device import resolve_device
from ..enums import Metric
from ..math import dot_f32, l2_normalize
from ..ops import BIG
from ..ops.beam import (beam_search_int8, beam_search_packed, beam_search_pq,
                        beam_search_vectors, pack_neighbors)
from ..ops.masked_scan import _distances, masked_scan
from ..ops.topk import topk
from ..profile import count, span, upload, wait
from .base import BaseIndex
from .device_build import DeviceVamanaBuilder
from .vamana_lib import VamanaGraph


@dataclass
class _Serving:
    """The device state one search reads; ``_sync_device`` makes a new one
    after writes, so a ``device_searcher`` keeps the state it was built on."""
    adj: torch.Tensor                   # [N, R] int32, pad -1
    medoid: int
    vectors: Optional[torch.Tensor]     # [N, D] float32, or bf16 with a codec
    codes: Optional[torch.Tensor]       # [N, M] u8/u16, row-major
    packed: Optional[tuple]             # (int8 [N, R*D], scale [N, R], norms)
    int8: Optional[tuple]               # (int8 [N, D], scale [N], norms [N])
    entry_ids: Optional[torch.Tensor]   # [S] sampled node ids
    entry_vecs: Optional[torch.Tensor]  # [S, D] their rows


class GraphIndex(BaseIndex):
    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.COSINE,
        max_degree: int = 32,
        alpha: float = 1.2,
        l_build: int = 64,
        ef_search: int = 64,
        beam_width: int = 16,
        pq_codec: Optional[PQCodec] = None,
        rerank: int = 0,
        n_threads: int = 0,
        build_mode: str = 'host',
        build_batch_size: int = 16384,
        build_iters: Optional[int] = None,
        traverse: str = 'auto',
        entry_mode: str = 'sample',
        n_entry_samples: int = 4096,
        entry_width: int = 8,
        filter_fallback_selectivity: float = 0.25,
        device: Optional[Union[str, torch.device]] = None,
        **kwargs,
    ):
        super().__init__(dim=dim, metric=metric, **kwargs)
        if build_mode not in ('host', 'device'):
            raise ValueError(f'unknown build_mode {build_mode!r}')
        if traverse not in ('auto', 'pq', 'vectors', 'packed', 'int8'):
            raise ValueError(f'unknown traverse {traverse!r}')
        if entry_mode not in ('medoid', 'sample'):
            raise ValueError(f'unknown entry_mode {entry_mode!r}')
        # 'auto': score traversal with resident rows whenever they exist;
        # 'pq' forces table traversal (the low-memory mode at rerank 0, no
        # row copy); 'packed': the packed-neighbour int8 layout; 'int8': an
        # int8 row-quantized traversal copy.  'packed' and 'int8' always
        # rerank exactly.
        self.traverse = traverse
        # 'sample': seed each query's beam with its nearest `entry_width` of
        # `n_entry_samples` stride-sampled rows instead of the medoid
        self.entry_mode = entry_mode
        self.n_entry_samples = n_entry_samples
        self.entry_width = entry_width
        self.max_degree = max_degree
        self.alpha = alpha
        self.l_build = l_build
        self.ef_search = ef_search
        self.beam_width = beam_width
        self.pq_codec = pq_codec
        self.rerank = rerank
        self.n_threads = n_threads
        self.build_mode = build_mode
        # the device build's insert batch and pools-stage beam iteration
        # budget (None: max(L/B + 4, 10))
        self.build_batch_size = build_batch_size
        self.build_iters = build_iters
        self.filter_fallback_selectivity = filter_fallback_selectivity
        self.device = resolve_device(device)
        # rerank=0 + traverse='pq' serves the raw table ranking: guard its
        # data-dependent recall floor (see index/pq_scan.py)
        self._recall_guard_pending = (
            pq_codec is not None and rerank == 0 and traverse == 'pq'
        )
        self._guard_rows: list = []  # sample accumulated across batches
        self.reset()

    @property
    def size(self) -> int:
        return self._graph.size

    @property
    def capacity(self) -> int:
        return self._graph.size

    def _prep(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32).reshape(-1, self.dim)
        if self.metric == Metric.COSINE:
            x = l2_normalize(torch.from_numpy(x)).numpy()
        return x

    def add_with_ids(self, x: np.ndarray, ids: np.ndarray):
        """Graph nodes are global rows — inserts must be contiguous appends
        (the container guarantees this)."""
        ids = np.asarray(ids)
        if len(ids) and not (ids[0] == self.size and np.all(np.diff(ids) == 1)):
            raise ValueError(
                f'GraphIndex requires contiguous appends; got rows starting '
                f'{ids[:3]} at size {self.size}'
            )
        x = self._prep(x)
        can_patch = self._can_patch()
        if self.build_mode == 'device':
            self._graph.add(x)
            self._vectors = self._graph.vectors  # the builder owns the host copy
        else:
            self._graph.add(x, n_threads=self.n_threads)
            self._vectors = np.concatenate([self._vectors, x])
        self._alive = np.concatenate([self._alive, np.ones(len(ids), bool)])
        if can_patch:
            # streaming ingest on a synced device-built index: encode only the
            # new rows (a dirty flag would re-encode all N at the next search)
            self._patch_device()
        else:
            self._dirty = True
        if self._recall_guard_pending:
            # accumulate across batches: small streaming batches must still
            # trip the one-shot >=512-row check
            self._guard_rows.append(x[:2048])
            if sum(len(r) for r in self._guard_rows) >= 512:
                from .pq_scan import _warn_if_low_raw_recall

                sample = np.concatenate(self._guard_rows)[:2048]
                self._recall_guard_pending = False
                self._guard_rows = []
                _warn_if_low_raw_recall(self.pq_codec, sample, 0.85,
                                        "GraphIndex(traverse='pq', rerank=0)")

    # the container's update() keeps rows in place instead of dead-mark +
    # append (no dead-row growth on write-heavy workloads)
    supports_inplace_update = True

    def update_with_ids(self, x: np.ndarray, ids: np.ndarray):
        """In-place point update (reference `updatePoint`): overwrite the
        rows and rewire their edges at the new location; row ids and the
        graph size stay."""
        ids = np.ascontiguousarray(ids, dtype=np.int32).reshape(-1)
        x = self._prep(x)
        if len(ids) == 0:
            return
        if ids.min() < 0 or ids.max() >= self.size:
            raise ValueError('update_with_ids requires existing rows; got '
                             f'{ids.min()}..{ids.max()} at size {self.size}')
        can_patch = self._can_patch()
        self._graph.update(ids, x)
        if self.build_mode == 'device':
            self._vectors = self._graph.vectors
        else:
            self._vectors[ids] = x
        self._alive[ids] = True
        if can_patch:
            # the builder's buffers are current: re-encode only these rows
            self._patch_device(updated=ids)
        else:
            self._dirty = True

    def _can_patch(self) -> bool:
        """A synced device-built index patches its serving state after a
        write; the packed and int8 traversal copies are rebuilt instead."""
        return (not self._dirty and self.build_mode == 'device'
                and self.traverse not in ('packed', 'int8'))

    def _device_views(self):
        """The builder's device rows and W-wide adjacency, cut to the live
        ``n`` rows (views: nothing is copied)."""
        vecs, adj = self._graph.device_arrays()
        return vecs[: self.size], adj[: self.size]

    def _patch_device(self, updated: Optional[np.ndarray] = None):
        """A new serving state after an append (``updated=None``: codes of
        the new rows appended, entry samples drawn anew) or an in-place
        update of rows ``updated`` (their codes and entry rows refreshed)."""
        s = self._serving
        vecs, adj = self._device_views()
        vectors = s.vectors
        if vectors is not None:
            vectors = vecs if vectors.dtype == torch.float32 else vecs.to(vectors.dtype)
        codes, entry_ids, entry_vecs = s.codes, s.entry_ids, s.entry_vecs
        if updated is None:
            n_old = 0 if codes is None else codes.shape[0]
            if codes is not None:
                new = self.pq_codec.encode(self._vectors[n_old:])
                codes = torch.cat([codes, torch.from_numpy(new).to(self.device)])
            entry_ids, entry_vecs = self._entries(vectors)
        else:
            if codes is not None:
                # the builder keeps the last of duplicate ids: encode its rows
                rows = torch.from_numpy(updated.astype(np.int64)).to(self.device)
                codes = codes.clone()
                codes[rows] = torch.from_numpy(
                    self.pq_codec.encode(self._vectors[updated])).to(self.device)
            if entry_vecs is not None:
                # an updated row may be one of the sampled beam seeds
                entry_vecs = vectors[entry_ids.long()]
        self._serving = replace(s, adj=adj, medoid=int(self._graph.medoid), vectors=vectors,
                                codes=codes, entry_ids=entry_ids, entry_vecs=entry_vecs)

    def _entries(self, vectors):
        """Beam seeds of the vector-scored traversal: ``n_entry_samples``
        stride-sampled rows and their vectors, or (None, None)."""
        # vector-scored traversal only: under the coarse table scores the
        # medoid's longer walk is the recall
        if (self.entry_mode != 'sample' or not self.size
                or self._table_traversal(vectors is not None)):
            return None, None
        s = min(self.n_entry_samples, self.size)
        # deterministic stride sample, spread over insert order
        ids = (np.arange(s, dtype=np.int64) * self.size // s).astype(np.int32)
        entry_ids = upload(ids, self.device)
        return entry_ids, vectors[entry_ids.long()]

    def delete_rows(self, rows):
        """Soft delete: traversal still routes through dead nodes but they
        are masked out of the candidate list before rerank/selection.
        Reclaim with compaction."""
        self._alive[np.asarray(rows)] = False
        self._dirty = True

    @property
    def n_deleted(self) -> int:
        return int((~self._alive).sum())

    @property
    def dead_fraction(self) -> float:
        n = self._alive.shape[0]
        return float(self.n_deleted) / n if n else 0.0

    def _table_traversal(self, has_vectors: bool) -> bool:
        """True when traversal scores with the PQ tables (vs resident rows)."""
        return self.pq_codec is not None and (self.traverse == 'pq' or not has_vectors)

    def _pq_traverse(self) -> bool:
        return self._table_traversal(self._sync_device().vectors is not None)

    def _sync_device(self) -> _Serving:
        if not self._dirty:
            return self._serving
        dev = self.device
        vectors = codes = packed = int8 = None
        dev_vecs = None
        if self.build_mode == 'device' and self.size:
            # the builder's buffers, cut to the live rows
            dev_vecs, adj = self._device_views()
        else:
            adj = upload(self._graph.adjacency(), dev)
        if self.pq_codec is not None:
            codes = upload(self.pq_codec.encode(self._vectors), dev)
        # traverse='vectors'/'packed'/'int8' keep the resident copy even at
        # rerank=0: bf16 with a codec, float32 without
        if (self.pq_codec is None or self.rerank > 0
                or self.traverse in ('vectors', 'packed', 'int8')):
            dt = torch.bfloat16 if self.pq_codec is not None else torch.float32
            vectors = (upload(self._vectors, dev) if dev_vecs is None else dev_vecs).to(dt)
        if self.traverse == 'packed' and self.size:
            packed = pack_neighbors(adj, vectors,
                                    need_norms=self.metric == Metric.EUCLIDEAN)
        if self.traverse == 'int8' and self.size:
            int8 = _quantize_rows_int8(upload(self._vectors, dev))
        entry_ids, entry_vecs = self._entries(vectors)
        self._serving = _Serving(adj, int(self._graph.medoid), vectors, codes, packed,
                                 int8, entry_ids, entry_vecs)
        self._dirty = False
        return self._serving

    def _needs_rerank(self) -> bool:
        if self.traverse in ('packed', 'int8'):
            return True  # int8 traversal scores are approximate
        return self.pq_codec is not None and self.rerank > 0

    def _effective_rerank(self, limit: int) -> int:
        r = self.rerank if self.rerank > 0 else 0
        if self.traverse in ('packed', 'int8'):
            r = max(r, 4 * limit)
        return r

    def _search_device(self, s: _Serving, q: torch.Tensor, limit: int,
                       mask: Optional[torch.Tensor]):
        """Traversal, selection mask and rerank on the device: ``q [Q, D]``
        (normalized for cosine) -> ``(dists [Q, <=limit], rows)``."""
        ef = max(self.ef_search, 4 * limit)
        euclid = self.metric == Metric.EUCLIDEAN
        kw = dict(k=ef, L=ef, B=self.beam_width)
        if s.entry_vecs is not None:
            entry = _sample_entries(s.entry_vecs, s.entry_ids, q, euclid,
                                    min(self.entry_width, ef))
        else:
            entry = torch.full((q.shape[0], 1), s.medoid, dtype=torch.int32,
                               device=q.device)
        if s.packed is not None:
            d, ids = beam_search_packed(s.adj, entry, *s.packed, s.vectors, q, euclid, **kw)
        elif s.int8 is not None:
            d, ids = beam_search_int8(s.adj, entry, *s.int8, q, euclid, **kw)
        elif self._table_traversal(s.vectors is not None):
            dtable = self.pq_codec.dist_mat(q).to(q.device)
            d, ids = beam_search_pq(s.adj, entry, s.codes, dtable, **kw)
        else:
            if mask is not None:
                # the predicate inside the traversal: its result holds passing
                # rows only, as many as the rerank reads or the search returns
                kw['k'] = ef if self._needs_rerank() else limit
                count('graph.filtered_queries', q.shape[0])
            d, ids = beam_search_vectors(s.adj, entry, s.vectors, q, euclid, passes=mask, **kw)
            mask = None  # applied inside the traversal
        if mask is not None:
            # predicate and soft-deletes applied at selection, BEFORE the
            # rerank, so no rerank slot goes to a dead candidate
            d, ids = _mask_candidates(d, ids, mask)
        if self._needs_rerank():
            # table or int8 traversal, or traversal on the bf16 copy: refine
            # the boundary at full precision
            return _rerank(q, ids, d, s.vectors, euclid, self._effective_rerank(limit), limit)
        return d[:, :limit], ids[:, :limit]

    def search(self, query: np.ndarray, limit: int = 10, mask: Optional[np.ndarray] = None):
        if self.size == 0:
            nq = len(np.atleast_2d(query))
            return (np.zeros((nq, 0), dtype=np.float32), np.zeros((nq, 0), dtype=np.int64))
        with span('annlite.index.prep'):
            query = self._prep(query)
            s = self._sync_device()
            if self.n_deleted:
                # dead rows behave like filtered rows: excluded at selection,
                # but traversal distances stay real so routes through them hold
                alive = self._alive
                mask = alive if mask is None else (
                    np.asarray(mask, dtype=bool)[: len(alive)] & alive)
            if mask is not None and len(mask) >= self.size and np.all(mask):
                # every row passes: selection would return the distance-sorted
                # list as it is, so neither upload nor apply the mask
                mask = None
            q = upload(query, self.device)
            mask_t = None if mask is None else upload(np.asarray(mask, dtype=bool), self.device)
        with span('annlite.index.dispatch'):
            if (mask is not None and s.vectors is not None
                    and float(np.mean(mask)) < self.filter_fallback_selectivity):
                # selective predicate: traversal would mostly visit non-passing
                # nodes — a masked exact scan instead
                count('graph.fallback_queries', q.shape[0])
                with span('annlite.index.fallback'):
                    d, ids = _masked_exact_scan(s.vectors, q, mask_t,
                                                self.metric == Metric.EUCLIDEAN,
                                                min(limit, self.size))
            else:
                d, ids = self._search_device(s, q, limit, mask_t)
        with wait():
            return d.cpu().numpy(), ids.cpu().numpy()

    def device_searcher(self, limit: int = 10):
        """Device-resident search callable: ``query [Q, D] float32 (a tensor
        on the index's device, or anything ``torch.as_tensor`` takes) ->
        (dists [Q, limit], rows [Q, limit])`` as tensors on the device.  It
        captures the current index state and its deletes: rebuild after
        writes."""
        s = self._sync_device()
        alive = (torch.from_numpy(self._alive.copy()).to(self.device)
                 if self.n_deleted else None)
        cosine = self.metric == Metric.COSINE
        device = self.device

        def run(query):
            q = torch.as_tensor(query, dtype=torch.float32, device=device)
            if cosine:
                q = l2_normalize(q)
            return self._search_device(s, q, limit, alive)

        return run

    def check_integrity(self) -> dict:
        """Graph-health report (hnswlib's ``checkIntegrity``): edge validity,
        in-link coverage, medoid reachability, degree histogram, dead
        fraction."""
        n = self.size
        if n == 0:
            return {'n': 0, 'ok': True}
        return graph_integrity_report(self._adjacency_state()[:n], int(self._graph.medoid),
                                      n, dead_fraction=self.dead_fraction)

    def _adjacency_state(self) -> np.ndarray:
        """What snapshots and integrity reports read: a device-built graph's
        full W-wide adjacency (its slack back-edges carry recall), the host
        build's R-wide one."""
        if self.build_mode == 'device':
            return self._graph.raw_adjacency()
        return self._graph.adjacency()

    def reset(self):
        metric_ip = self.metric != Metric.EUCLIDEAN
        if self.build_mode == 'device':
            self._graph = DeviceVamanaBuilder(
                self.dim, max_degree=self.max_degree, alpha=self.alpha, metric_ip=metric_ip,
                l_build=self.l_build, batch_size=self.build_batch_size,
                beam_width=self.beam_width, build_iters=self.build_iters, device=self.device)
        else:
            self._graph = VamanaGraph(self.dim, max_degree=self.max_degree, alpha=self.alpha,
                                      metric_ip=metric_ip, l_build=self.l_build)
        self._vectors = np.zeros((0, self.dim), dtype=np.float32)  # host copy
        self._alive = np.zeros(0, dtype=bool)  # soft-delete bitmap
        self._serving = None
        self._dirty = True

    # ----- snapshot state (see AnnLite.dump_index) -----

    def state_arrays(self):
        return {
            'kind': np.array('graph'),
            'vectors': self._vectors.copy(),
            'adjacency': self._adjacency_state(),
            'alive': self._alive.copy(),
        }

    def load_state_arrays(self, state):
        self.reset()
        v = np.asarray(state['vectors'], dtype=np.float32)
        if v.size:
            adj = np.asarray(state['adjacency'])
            if self.build_mode == 'host' and adj.shape[1] > self.max_degree:
                # a W-wide device-built snapshot into the R-wide builder: keep
                # each row's R NEAREST neighbours (the slack back-edges carry
                # connectivity that column truncation would drop)
                adj = consolidate_adjacency(v, adj, self.max_degree,
                                            metric_ip=self.metric != Metric.EUCLIDEAN)
            self._graph.load(v, adj)
            self._vectors = self._graph.vectors if self.build_mode == 'device' else v.copy()
        self._alive = (np.array(state['alive'], dtype=bool) if 'alive' in state
                       else np.ones(v.shape[0], dtype=bool))
        self._dirty = True


def graph_integrity_report(
    adj: np.ndarray, medoid: int, n: int, dead_fraction: float = 0.0
) -> dict:
    """Core of ``check_integrity``: edge validity, in-link coverage,
    medoid-BFS reachability, degree stats."""
    adj = np.asarray(adj)[:n]
    valid = adj >= 0
    edges = adj[valid]
    out_of_range = int((edges >= n).sum())
    self_loops = int((adj == np.arange(n)[:, None]).sum())
    deg = valid.sum(axis=1)
    inlinked = np.zeros(n, dtype=bool)
    inlinked[np.clip(edges, 0, n - 1)] = True
    seen = np.zeros(n, dtype=bool)
    seen[medoid] = True
    frontier = np.array([medoid])
    while len(frontier):
        nxt = adj[frontier].reshape(-1)
        nxt = np.unique(nxt[(nxt >= 0) & (nxt < n)])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    reachable = float(seen.mean())
    return {
        'n': n,
        'medoid': int(medoid),
        'reachable_fraction': reachable,
        'no_inlink_count': int((~inlinked).sum() - (not inlinked[medoid])),
        'out_of_range_edges': out_of_range,
        'self_loops': self_loops,
        'degree_min': int(deg.min()),
        'degree_mean': float(deg.mean()),
        'degree_max': int(deg.max()),
        'isolated_count': int((deg == 0).sum()),
        'dead_fraction': float(dead_fraction),
        'ok': out_of_range == 0 and self_loops == 0 and reachable >= 0.99,
    }


def consolidate_adjacency(
    vectors: np.ndarray,
    adj: np.ndarray,
    r: int,
    metric_ip: bool = False,
    chunk: int = 8192,
) -> np.ndarray:
    """Reduce a W-wide adjacency (R out-edges + slack back-edge columns) to
    R columns by keeping each node's R NEAREST neighbours — a load-time
    consolidation for the R-bound C++ builder.  O(N*W*D) host work."""
    n, w = adj.shape
    if w <= r:
        return adj
    out = np.full((n, r), -1, dtype=np.int32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        a = adj[lo:hi]  # [C, W]
        nb = vectors[np.clip(a, 0, len(vectors) - 1)]  # [C, W, D]
        v = vectors[lo:hi]  # [C, D]
        if metric_ip:
            d = 1.0 - np.einsum('cd,cwd->cw', v, nb)
        else:
            diff = nb - v[:, None, :]
            d = np.einsum('cwd,cwd->cw', diff, diff)
        d = np.where(a >= 0, d, np.inf)
        pick = np.argsort(d, axis=1, kind='stable')[:, :r]
        vals = np.take_along_axis(a, pick, axis=1)
        keep = np.take_along_axis(d, pick, axis=1) < np.inf
        out[lo:hi] = np.where(keep, vals, -1)
    return out


def _quantize_rows_int8(v: torch.Tensor):
    """Row-quantized int8 traversal copy: (x8 [N, D], scale [N], norms [N] —
    true float32 row norms, so L2 scores stay consistent).  The division by
    127 is a product with the float32 reciprocal, as XLA compiles it."""
    v = v.float()
    sc = torch.amax(torch.abs(v), dim=1) * (1.0 / 127.0)
    q8 = torch.clamp(torch.round(v / torch.clamp_min(sc, 1e-12)[:, None]),
                     -127, 127).to(torch.int8)
    return q8, sc, torch.sum(v * v, dim=1)


def _sample_entries(sample_vecs, sample_ids, q, euclid: bool, e: int):
    """Per-query beam seeds: the nearest ``e`` of the sampled nodes (ties to
    the lower sample, as ``lax.top_k``)."""
    d = _distances(q, sample_vecs.float(), euclid)
    _, pos = topk(d, min(e, d.shape[1]))
    return sample_ids[pos].to(torch.int32)


def _mask_candidates(d, ids, mask):
    """Drop non-passing candidates (filter predicate and/or soft-deletes)
    and re-sort, keeping the width: masked slots score BIG."""
    n = mask.shape[0]
    valid = (ids >= 0) & (ids < n)
    passing = valid & mask[torch.clamp(ids, 0, n - 1).long()]
    d, pos = topk(torch.where(passing, d, BIG), d.shape[1])
    return d, torch.gather(ids, 1, pos)


def _rerank(q, cand_ids, cand_d, vecs, euclid: bool, r: int, limit: int):
    """Exact float32 distances of the first ``r`` candidates -> the best
    ``min(limit, r)``."""
    r = min(r, cand_ids.shape[1])
    cand_ids, cand_d = cand_ids[:, :r], cand_d[:, :r]
    cvec = vecs[torch.clamp(cand_ids, 0, vecs.shape[0] - 1).long()].float()
    if euclid:
        d = torch.sum((q[:, None, :] - cvec) ** 2, dim=-1)
    else:
        d = 1.0 - dot_f32(q[:, None, :], cvec)[:, 0, :]
    d, pos = topk(torch.where(cand_d < BIG / 2, d, BIG), min(limit, r))
    return d, torch.gather(cand_ids, 1, pos)


def _masked_exact_scan(vecs, q, mask, euclid: bool, limit: int):
    """Exact scan restricted to mask-passing rows (the filter fallback): on
    the card one ``masked_scan`` launch and its merge (`ops/masked_scan.py`)."""
    return masked_scan(vecs, q, mask, euclid, limit)
