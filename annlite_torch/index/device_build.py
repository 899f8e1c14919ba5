"""Batched Vamana graph construction on the device — the port of
`annlite_tpu/index/device_build.py`.

The host builder (`csrc/vamana.cpp`) inserts one point at a time.  Here the
two compute-heavy stages run batched on the device:

1. **Candidate pools**: the whole insert batch runs one beam search over
   the current graph (`ops/beam.py` ``beam_search_vectors_bounded``, the
   eager loop), merged with an exact intra-batch top-k (one matrix product)
   so batch-mates can link to each other.
2. **RobustPrune**, vectorized over the batch (`ops/prune.py`
   ``robust_prune_batch``), including the overflow re-prunes of back-edge
   targets.

The host keeps the authoritative adjacency and stitches back-edges with
vectorized numpy (grouping, the in-link guarantee, reachability repair,
the medoid); changed rows are pushed to the device buffer between batches.

Differences from the JAX module, none of which changes a result:
- no ``_bucket`` padding of batches, pools or pushed rows: it existed to
  spare XLA recompiles, and every stage is per row, so padding cannot
  change what a row gets;
- the intra-batch top-k is exact (a stable sort, `ops/topk.py`) over the
  bf16-rounded rows' float32 products, where the JAX module takes
  ``approx_min_k`` (exact on the CPU);
- buffers handed out by :meth:`DeviceVamanaBuilder.device_arrays` are not
  written in place: the first write to each after the hand-out goes to a
  clone, later ones in place until the next hand-out.  A holder (a
  ``GraphIndex`` serving state, a ``device_searcher``) keeps a stale but
  intact snapshot, as JAX's immutable arrays give it;
- the pools stage's chunk shrinks with ``dim * beam_width * W`` against the
  budget of the defaults (d 128, beam 16, W 48), not with ``dim`` alone: its
  gather is ``[chunk, B * W, d]``.
"""
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..math import dot_f32
from ..ops import BIG
from ..ops.beam import _resolve_iters, beam_search_vectors_bounded
from ..ops.prune import robust_prune_batch
from ..ops.topk import topk
from ..profile import span

GROW_CHUNK = 1 << 17  # capacity growth quantum
PAD_Q = 16384         # query chunk of the pools stage at the default widths
INTRA_TILE = 2048     # query tile of the intra-batch top-k
INC_CAP = 32          # incoming back-edges kept per overflowing row's re-prune
ENTRY_SAMPLES = 1024  # evenly spaced nodes the pools' beams are seeded from
ENTRY_WIDTH = 8       # nearest samples each pools beam starts from


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _build_pools(adj, vecs_pool, q, sids, n: int, metric_ip: bool,
                 L: int, B: int, iters: int, E: int) -> torch.Tensor:
    """Entry seeding + a bounded beam for one chunk of queries -> pool ids
    ``[chunk, L]``.  Seeding: each query's nearest ``E`` of the ``sids``
    sampled nodes (one ``[chunk, S]`` product, ties to the lower sample); with
    ``E = 0`` every query starts at ``sids[0]`` (the medoid)."""
    if E > 0:
        sv = vecs_pool[sids.long()].float()
        dots = dot_f32(q, sv)
        if metric_ip:
            d = 1.0 - dots
        else:
            d = torch.sum(q * q, dim=1)[:, None] + torch.sum(sv * sv, dim=1)[None, :] - 2.0 * dots
        _, pos = topk(d, min(E, d.shape[1]))
        entry = sids[pos].to(torch.int32)
    else:
        entry = sids[:1][None, :].expand(q.shape[0], 1).to(torch.int32)
    _, ids = beam_search_vectors_bounded(adj, entry, vecs_pool, q, n, not metric_ip,
                                         L, B, iters, L)
    return ids


def _intra_topk(x: torch.Tensor, metric_ip: bool, k: int) -> torch.Tensor:
    """Intra-batch kNN ``[P, D] -> [P, k]`` row indices, in query tiles of
    ``INTRA_TILE``: products of the bf16-rounded rows accumulated in float32,
    squared norms of the float32 rows; self masked by index (a distance
    sentinel would not be metric-proof).  Columns past ``P - 1`` neighbours
    hold -1."""
    p = x.shape[0]
    xb = x.to(torch.bfloat16).float()
    n2 = torch.sum(x * x, dim=1)
    cols = torch.arange(p, device=x.device)
    out = torch.full((p, k), -1, dtype=torch.int64, device=x.device)
    kk = min(k, p)
    for s in range(0, p, INTRA_TILE):
        e = min(s + INTRA_TILE, p)
        dots = dot_f32(xb[s:e], xb)
        d = 1.0 - dots if metric_ip else n2[s:e, None] + n2[None, :] - 2.0 * dots
        d = torch.where(cols[s:e, None] == cols[None, :], BIG, d)
        vals, idx = topk(d, kk)
        out[s:e, :kk] = torch.where(vals < BIG, idx, -1)
    return out


def _prune_call(pool_ids: torch.Tensor, self_ids: torch.Tensor, vecs: torch.Tensor,
                alpha: float, r: int, metric_ip: bool) -> torch.Tensor:
    """Gather the pool's rows, score them against the point, prune."""
    cap = vecs.shape[0]
    pool_vecs = vecs[torch.clamp(pool_ids, 0, cap - 1).long()]  # [P, L, D]
    self_vecs = vecs[torch.clamp(self_ids, 0, cap - 1).long()]
    if metric_ip:
        pool_d = 1.0 - dot_f32(self_vecs[:, None, :], pool_vecs)[:, 0, :]
    else:
        diff = pool_vecs - self_vecs[:, None, :]
        pool_d = torch.sum(diff * diff, dim=-1)
    return robust_prune_batch(pool_ids, pool_d, pool_vecs, self_ids, alpha, r,
                              metric_ip=metric_ip)


class DeviceVamanaBuilder:
    """Batched Vamana construction with device-side search and prune.

    Produces what `csrc/vamana.cpp` produces: a dense padded adjacency
    ``int32 [n, R]`` (pad -1) and a medoid entry point; the live graph keeps
    ``slack`` more columns of back-edges (:meth:`raw_adjacency`).
    ``device=None`` means the card.
    """

    # pairwise and gathered tensors scale as chunk * L^2 (+ chunk * L * D):
    # cap the prune chunk
    PRUNE_CHUNK = 32768

    def __init__(
        self,
        dim: int,
        max_degree: int = 32,
        alpha: float = 1.2,
        metric_ip: bool = False,
        l_build: int = 64,
        batch_size: int = 16384,
        beam_width: int = 16,
        slack: Optional[int] = None,
        build_iters: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.dim = dim
        self.r = max_degree
        self.alpha = float(alpha)
        self.metric_ip = metric_ip
        self.l_build = max(l_build, max_degree)
        self.batch_size = batch_size
        self.beam_width = beam_width
        # seeded beams start inside the query's neighbourhood, so the default
        # budget is max(L/B + 4, 10) iterations, not max(2L/B, 16); the slack
        # back-edges and the reachability repair protect recall
        if build_iters is None:
            build_iters = max(self.l_build // beam_width + 4, 10)
        self.build_iters = build_iters
        # rows carry `slack` more columns so back-edges accumulate without a
        # prune; a row is re-pruned (down to R) once it exceeds W = R + slack
        self.slack = slack if slack is not None else min(max_degree // 2, 16)
        self.w = self.r + self.slack
        self.device = resolve_device(device)
        self.n = 0
        self.medoid = 0
        self._sum = np.zeros(dim, dtype=np.float64)  # running centroid
        self._vecs_host = np.zeros((0, dim), dtype=np.float32)  # capacity rows
        self._adj_host = np.zeros((0, self.w), dtype=np.int32)  # capacity rows
        self._vecs_dev = None       # [cap, D] float32
        self._adj_dev = None        # [cap, W] int32
        # [cap, D] bf16 scoring copy: the beam gathers half the bytes, scores
        # accumulate in float32 and the prune reads the float32 rows
        self._vecs_pool_dev = None
        # names of the buffers device_arrays() handed out that were not
        # written since: the next write to each goes to a clone
        self._shared: set = set()

    # ---------------- capacity / device sync ----------------

    @property
    def capacity(self) -> int:
        return len(self._vecs_host)

    @property
    def size(self) -> int:
        return self.n

    @property
    def vectors(self) -> np.ndarray:
        return self._vecs_host[: self.n]

    @property
    def _escaped(self) -> bool:
        """True while a handed-out buffer has not been replaced."""
        return bool(self._shared)

    def raw_adjacency(self) -> np.ndarray:
        """The live W-wide graph (R + slack columns, pad -1): what serving
        should traverse, since the slack back-edges carry recall."""
        return self._adj_host[: self.n].copy()

    def adjacency(self) -> np.ndarray:
        """Strict R-degree artifact (RobustPrune applied to rows that grew
        into their slack), for parity with the host builder's export.
        Non-mutating; lossy at scale, since a batch-built graph's
        connectivity lives partly in the slack back-edges: prefer
        :meth:`raw_adjacency` unless a strict R bound is required."""
        adj = self._adj_host[: self.n].copy()
        deg = (adj >= 0).sum(axis=1)
        rows = np.flatnonzero(deg > self.r).astype(np.int32)
        if len(rows):
            adj[rows] = -1
            adj[rows, : self.r] = self._device_prune(rows, self._adj_host[rows])
        return adj[:, : self.r]

    def device_arrays(self):
        """(vectors ``[cap, D]`` float32, adjacency ``[cap, W]`` int32) on the
        device; rows >= n are padding (adjacency -1, never routed into).

        Marks both as handed out: the builder writes neither in place again
        (the next write to each goes to a clone), so a holder keeps a stale
        but intact snapshot."""
        self._shared = {'vecs', 'adj'}
        return self._vecs_dev, self._adj_dev

    def _own(self, name: str) -> torch.Tensor:
        """The buffer ``name`` ('vecs' or 'adj'), ready for an in-place write:
        cloned first if it was handed out since its last write."""
        attr = '_vecs_dev' if name == 'vecs' else '_adj_dev'
        buf = getattr(self, attr)
        if name in self._shared:
            buf = buf.clone()
            setattr(self, attr, buf)
            self._shared.discard(name)
        return buf

    def _alloc(self, cap: int, vecs: np.ndarray, adj: np.ndarray):
        """Fresh device buffers of ``cap`` rows holding ``vecs`` and ``adj``."""
        dev = self.device
        self._vecs_dev = torch.zeros((cap, self.dim), dtype=torch.float32, device=dev)
        self._adj_dev = torch.full((cap, self.w), -1, dtype=torch.int32, device=dev)
        if len(vecs):
            self._vecs_dev[: len(vecs)] = torch.from_numpy(vecs).to(dev)
            self._adj_dev[: len(adj)] = torch.from_numpy(adj).to(dev)
        self._vecs_pool_dev = self._vecs_dev.to(torch.bfloat16)
        self._shared = set()

    def _ensure_capacity(self, n_new: int):
        need = self.n + n_new
        if need <= self.capacity:
            return
        cap = _round_up(need, GROW_CHUNK)
        vh = np.zeros((cap, self.dim), dtype=np.float32)
        vh[: self.n] = self._vecs_host[: self.n]
        ah = np.full((cap, self.w), -1, dtype=np.int32)
        ah[: self.n] = self._adj_host[: self.n]
        self._vecs_host, self._adj_host = vh, ah
        self._alloc(cap, vh[: self.n], ah[: self.n])

    def _write_vecs(self, rows: torch.Tensor, x: np.ndarray):
        """Rows ``rows`` of the float32 buffer and of the scoring copy := x."""
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self._own('vecs')[rows] = xd
        self._vecs_pool_dev[rows] = xd.to(torch.bfloat16)

    def _push_rows(self, rows: np.ndarray):
        """Push updated adjacency rows (host-authoritative) to the device."""
        if rows.size == 0:
            return
        rows = np.unique(rows)
        vals = torch.from_numpy(self._adj_host[rows]).to(self.device)
        self._own('adj')[torch.from_numpy(rows.astype(np.int64)).to(self.device)] = vals

    # ---------------- pools ----------------

    def _build_entry_ids(self) -> np.ndarray:
        """Evenly spaced sample of existing node ids for beam seeding
        (duplicates at tiny n are harmless)."""
        s = ENTRY_SAMPLES
        return (np.arange(s, dtype=np.int64) * self.n // s).astype(np.int32)

    def _pools_chunk(self) -> int:
        """Queries per pools chunk: the gather temp is ``[chunk, B * W, d]``
        bf16 plus its float32 convert, so the chunk halves (down to 2048)
        until ``chunk * d * B * W`` is within the defaults' budget
        (16384 * 128 * 16 * 48)."""
        cq = PAD_Q
        while cq > 2048 and cq * self.dim * self.beam_width * self.w > PAD_Q * 128 * 16 * 48:
            cq //= 2
        return cq

    def _graph_pools(self, x: np.ndarray, entry_width: Optional[int] = None) -> np.ndarray:
        """Beam-search pools ``[len(x), l_build]`` for the batch against the
        current graph.  ``entry_width=0`` forces the medoid seed
        (reachability repair must route from the reachable graph: a sampled
        seed could sit on the island being repaired)."""
        l = self.l_build
        out = np.empty((len(x), l), dtype=np.int32)
        e = ENTRY_WIDTH if entry_width is None else entry_width
        if e > 0:
            sids = torch.from_numpy(self._build_entry_ids()).to(self.device)
            iters = self.build_iters
        else:
            sids = torch.full((1,), self.medoid, dtype=torch.int32, device=self.device)
            # unseeded beams need the full budget to route from the medoid
            iters = _resolve_iters(None, l, self.beam_width)
        cq = self._pools_chunk()
        for s in range(0, len(x), cq):
            q = torch.from_numpy(np.ascontiguousarray(x[s: s + cq])).to(self.device)
            ids = _build_pools(self._adj_dev, self._vecs_pool_dev, q, sids, self.n,
                               self.metric_ip, l, self.beam_width, iters, e)
            out[s: s + len(q)] = ids.cpu().numpy()
        return out

    def _intra_pools(self, x: np.ndarray, base: int) -> np.ndarray:
        """Exact intra-batch top-k (the graph search cannot find batch-mates;
        serial insertion sees them by order) as global ids, -1 pads."""
        idx = _intra_topk(torch.from_numpy(np.ascontiguousarray(x)).to(self.device),
                          self.metric_ip, self.r).cpu().numpy()
        return np.where(idx >= 0, idx + base, -1).astype(np.int32)

    # ---------------- insert ----------------

    def add(self, x: np.ndarray):
        """Insert rows ``x`` in batches; each stage of each batch is a span
        ``annlite.build.<stage>`` of the port's tracer (`profile.py`)."""
        x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, self.dim)
        for s in range(0, len(x), self.batch_size):
            self._add_batch(x[s: s + self.batch_size])
        with span('annlite.build.repair'):
            self._repair_reachability()

    def _add_batch(self, x: np.ndarray):
        p = len(x)
        if p == 0:
            return
        with span('annlite.build.upload'):
            base = self.n
            self._ensure_capacity(p)
            self._vecs_host[base: base + p] = x
            self._write_vecs(slice(base, base + p), x)
            self._sum += x.sum(axis=0, dtype=np.float64)

        # pools: intra-batch exact + graph beam (once a graph exists)
        with span('annlite.build.intra'):
            pools = [self._intra_pools(x, base)]
        if base > 0:
            with span('annlite.build.pools'):
                pools.append(self._graph_pools(x))

        with span('annlite.build.prune'):
            pool_ids = np.concatenate(pools, axis=1)
            new_ids = np.arange(base, base + p, dtype=np.int32)
            out = self._device_prune(new_ids, pool_ids)  # [P, R]
        self.n = base + p
        self._adj_host[new_ids, : self.r] = out

        with span('annlite.build.backedges'):
            touched = self._apply_back_edges(new_ids, out, fresh_from=base)
        with span('annlite.build.push'):
            self._update_medoid()
            self._push_rows(np.concatenate([new_ids, touched]))

    def update(self, ids: np.ndarray, x: np.ndarray):
        """In-place point update (`csrc/vamana.cpp` ``vamana_update``):
        overwrite the stored rows at ``ids``, then rebuild those rows'
        out-edges from fresh beam pools (old neighbours included) and re-wire
        back-edges at the new location.  Stale in-edges from the old
        neighbourhood remain as valid routing edges."""
        ids = np.ascontiguousarray(ids, dtype=np.int32).reshape(-1)
        x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, self.dim)
        if len(ids) == 0:
            return
        if ids.min() < 0 or ids.max() >= self.n:
            raise ValueError('update ids out of range')
        # duplicate ids: the last occurrence wins (the container's by-id
        # semantics), and the centroid sum subtracts each old row once
        if len(np.unique(ids)) != len(ids):
            _, last = np.unique(ids[::-1], return_index=True)
            keep = np.sort(len(ids) - 1 - last)
            ids, x = ids[keep], x[keep]
        self._sum += (x.sum(axis=0, dtype=np.float64)
                      - self._vecs_host[ids].sum(axis=0, dtype=np.float64))
        self._vecs_host[ids] = x
        self._write_vecs(torch.from_numpy(ids.astype(np.int64)).to(self.device), x)
        for s in range(0, len(ids), self.batch_size):
            bi, bx = ids[s: s + self.batch_size], x[s: s + self.batch_size]
            pools = self._graph_pools(bx)
            pool = np.concatenate([self._adj_host[bi], pools], axis=1)
            out = self._device_prune(bi, pool)
            self._adj_host[bi] = -1
            self._adj_host[bi, : self.r] = out
            touched = self._apply_back_edges(bi, out, check_fresh=True)
            self._push_rows(np.concatenate([bi, touched]))
        self._update_medoid()

    def _device_prune(self, self_ids: np.ndarray, pool_ids: np.ndarray) -> np.ndarray:
        p = len(self_ids)
        if p > self.PRUNE_CHUNK:
            return np.concatenate([
                self._device_prune(self_ids[s: s + self.PRUNE_CHUNK],
                                   pool_ids[s: s + self.PRUNE_CHUNK])
                for s in range(0, p, self.PRUNE_CHUNK)
            ])
        dev = self.device
        out = _prune_call(torch.from_numpy(np.ascontiguousarray(pool_ids, dtype=np.int32)).to(dev),
                          torch.from_numpy(np.ascontiguousarray(self_ids, dtype=np.int32)).to(dev),
                          self._vecs_dev, self.alpha, self.r, self.metric_ip)
        return out.cpu().numpy()

    def _apply_back_edges(self, new_ids: np.ndarray, out: np.ndarray,
                          check_fresh: bool = False,
                          fresh_from: Optional[int] = None) -> np.ndarray:
        """Insert reverse edges p -> v into each v's list; re-prune rows that
        overflow W (`csrc/vamana.cpp`'s back-edge path).  Returns the
        modified rows.

        Duplicate-edge checks: ``check_fresh`` checks every target (the
        re-insert paths: repair, update).  Fresh inserts only need
        ``fresh_from=base``: rows from before the batch cannot point at a new
        row, but batch-mates can (mutual kNN pairs from the intra pools)."""
        r = self.r
        src = np.repeat(new_ids, r)
        dst = out.reshape(-1)
        keep = dst >= 0
        src, dst = src[keep], dst[keep]
        if len(dst):
            if check_fresh:
                fresh = ~(self._adj_host[dst] == src[:, None]).any(axis=1)
                src, dst = src[fresh], dst[fresh]
            elif fresh_from is not None:
                bm = dst >= fresh_from
                if bm.any():
                    dup = (self._adj_host[dst[bm]] == src[bm][:, None]).any(axis=1)
                    drop = np.flatnonzero(bm)[dup]
                    if len(drop):
                        keep2 = np.ones(len(dst), dtype=bool)
                        keep2[drop] = False
                        src, dst = src[keep2], dst[keep2]
        if len(dst) == 0:
            return np.empty(0, dtype=np.int64)
        order = np.argsort(dst, kind='stable')
        src, dst = src[order], dst[order]
        uniq, starts, counts = np.unique(dst, return_index=True, return_counts=True)
        deg = (self._adj_host[uniq] >= 0).sum(axis=1)
        total = deg + counts

        # appends that fit in R + slack: one vectorized scatter
        fit = total <= self.w
        if fit.any():
            f_u, f_start, f_cnt, f_deg = uniq[fit], starts[fit], counts[fit], deg[fit]
            csum = np.concatenate([[0], np.cumsum(f_cnt)])
            grp = np.repeat(np.arange(len(f_u)), f_cnt)
            within = np.arange(csum[-1]) - csum[grp]
            self._adj_host[f_u[grp], f_deg[grp] + within] = src[f_start[grp] + within]

        # overflow: re-prune (old neighbours + up to INC_CAP incoming)
        ov = ~fit
        if ov.any():
            o_u, o_start, o_cnt = uniq[ov], starts[ov], counts[ov]
            cap = INC_CAP
            cc = np.minimum(o_cnt, cap)
            inc = np.full((len(o_u), cap), -1, dtype=np.int32)
            csum = np.concatenate([[0], np.cumsum(cc)])
            grp = np.repeat(np.arange(len(o_u)), cc)
            within = np.arange(csum[-1]) - csum[grp]
            inc[grp, within] = src[o_start[grp] + within]
            pool = np.concatenate([self._adj_host[o_u], inc], axis=1)
            pruned = self._device_prune(o_u.astype(np.int32), pool)
            self._adj_host[o_u] = -1
            self._adj_host[o_u, : r] = pruned  # slack drained for later appends

        # in-link guarantee: a new point none of whose back-edges landed is
        # unreachable from the medoid.  A bitmap, not np.isin (which sorts
        # the whole edge list)
        referenced = np.concatenate(
            [self._adj_host[uniq].reshape(-1), self._adj_host[new_ids].reshape(-1)])
        referenced = referenced[referenced >= 0]
        ref_mark = np.zeros(self.n, dtype=bool)
        ref_mark[referenced] = True
        missing = new_ids[~ref_mark[new_ids]]
        forced = []
        for pid in missing:
            tgt = self._adj_host[pid, 0]
            if tgt < 0:
                continue
            empty = np.flatnonzero(self._adj_host[tgt] < 0)
            slot = empty[0] if len(empty) else r - 1
            self._adj_host[tgt, slot] = pid
            forced.append(tgt)
        touched = uniq
        if forced:
            touched = np.concatenate([touched, np.asarray(forced, dtype=uniq.dtype)])
        return touched

    def _reachable_mask(self) -> np.ndarray:
        """BFS from the medoid over the host adjacency (level-set numpy)."""
        mask = np.zeros(self.n, dtype=bool)
        mask[self.medoid] = True
        frontier = np.array([self.medoid])
        while len(frontier):
            nxt = self._adj_host[frontier].reshape(-1)
            nxt = np.unique(nxt[nxt >= 0])
            nxt = nxt[~mask[nxt]]
            mask[nxt] = True
            frontier = nxt
        return mask

    def _repair_reachability(self, max_rounds: int = 4):
        """Batched insertion can leave islands (nodes whose in-links all come
        from batch-mates in a cycle).  Re-insert unreachable nodes with
        pools drawn from the reachable graph; the alpha slack of RobustPrune
        keeps long-range edges both ways, so a few rounds reconnect them."""
        if self.n <= 1:
            return
        for _ in range(max_rounds):
            bad = np.flatnonzero(~self._reachable_mask())
            if len(bad) == 0:
                return
            for s in range(0, len(bad), self.batch_size):
                ids = bad[s: s + self.batch_size].astype(np.int32)
                pools = self._graph_pools(self._vecs_host[ids], entry_width=0)
                pool = np.concatenate([self._adj_host[ids], pools], axis=1)
                out = self._device_prune(ids, pool)
                self._adj_host[ids] = -1
                self._adj_host[ids, : self.r] = out
                touched = self._apply_back_edges(ids, out, check_fresh=True)
                self._push_rows(np.concatenate([ids, touched]))

    def _update_medoid(self):
        """Nearest stored point to the running centroid (sampled), as
        `csrc/vamana.cpp` ``compute_medoid``."""
        c = (self._sum / max(self.n, 1)).astype(np.float32)
        step = max(1, self.n // 10000)
        sample = self._vecs_host[: self.n: step]
        if self.metric_ip:
            d = 1.0 - sample @ c
        else:
            d = ((sample - c) ** 2).sum(axis=1)
        self.medoid = int(np.argmin(d) * step)

    # ---------------- load (snapshot restore) ----------------

    def load(self, vectors: np.ndarray, adjacency: np.ndarray):
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        adjacency = np.ascontiguousarray(adjacency, dtype=np.int32)
        n, r_in = adjacency.shape if adjacency.ndim == 2 else (0, self.r)
        if r_in > self.w:
            raise ValueError(f'adjacency wider ({r_in}) than R+slack ({self.w})')
        cap = _round_up(max(n, 1), GROW_CHUNK)
        self._vecs_host = np.zeros((cap, self.dim), dtype=np.float32)
        self._vecs_host[:n] = vectors
        self._adj_host = np.full((cap, self.w), -1, dtype=np.int32)
        self._adj_host[:n, :r_in] = adjacency
        self.n = n
        self._sum = vectors.sum(axis=0, dtype=np.float64)
        self._alloc(cap, self._vecs_host[:n], self._adj_host[:n])
        if n:
            self._update_medoid()
