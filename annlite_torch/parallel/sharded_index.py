"""Sharded serving indexes — the port of `annlite_tpu/parallel/sharded_index.py`.

`ShardedPQIndex`: PQ codes sharded on N over the mesh's shards, per-query
ADC tables replicated, each shard scored by K5 and the per-shard winners
merged (`parallel/mesh.py`).  `ShardedFlatIndex`: int8 rows sharded on N,
per-shard scan with the exact float32 rerank against the shard's own rows,
the same merge.  `ShardedIVFPQIndex`: the blocked code store's block axis
sharded, each shard scanning its probed blocks.  `ShardedGraphIndex`: rows
assigned round-robin, one Vamana sub-graph per shard.

The host side keeps the JAX classes' bookkeeping (numpy buffers, delete
bitmaps, snapshot states with the same ``kind`` strings); the per-shard
tensors are placed again after each write, at the next search.  None has a
``device_searcher``.
"""
from typing import Optional, Union

import numpy as np
import torch

from ..codecs import PQCodec
from ..enums import Metric
from ..math import l2_normalize
from ..ops.scan import quantize_rows_int8
from ..index.base import BaseIndex
from ..index.ivf_pq import IVFPQIndex, _dedup_candidates
from ..ops.topk import topk
from .mesh import (Mesh, make_mesh, replicate, shard_codes, shard_mask,
                   shard_rows, sharded_adc_topk, sharded_beam_topk, sharded_ivf_topk,
                   sharded_scan_topk)

Device = Optional[Union[str, torch.device]]


def _mesh(mesh: Optional[Mesh], n_devices: Optional[int], device: Device) -> Mesh:
    return mesh if mesh is not None else make_mesh(n_devices, device)


def _normalized(x: np.ndarray, dim: int, normalize: bool) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32).reshape(-1, dim)
    return l2_normalize(torch.from_numpy(x)).numpy() if normalize else x


def _host(d: torch.Tensor, idx: torch.Tensor):
    return d.cpu().numpy(), idx.cpu().numpy()


class ShardedPQIndex(BaseIndex):
    def __init__(
        self,
        dim: int,
        pq_codec: PQCodec,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
        device: Device = None,
        **kwargs,
    ):
        super().__init__(dim=dim, metric=pq_codec.metric, **kwargs)
        if not pq_codec.is_trained:
            raise RuntimeError('PQCodec must be trained before building ShardedPQIndex')
        self.pq_codec = pq_codec
        self.mesh = _mesh(mesh, n_devices, device)
        # u8/u16/u32 per the codec (n_clusters > 256 must not wrap mod 256)
        self._codes = np.zeros((0, pq_codec.n_subvectors), dtype=pq_codec.code_dtype)
        self._alive = np.zeros(0, dtype=bool)
        self._dev_codes = None
        self._dirty = True

    @property
    def size(self) -> int:
        return self._codes.shape[0]

    @property
    def capacity(self) -> int:
        return self._codes.shape[0]

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    def _prep(self, x: np.ndarray) -> np.ndarray:
        return _normalized(x, self.dim, self.pq_codec.normalize_input)

    def add_with_ids(self, x, ids, codes=None):
        x = self._prep(x)
        if codes is None:
            codes = self.pq_codec.encode(x)
        ids = np.asarray(ids)
        hi = int(ids.max()) + 1 if len(ids) else 0
        if hi > self.size:
            grow = hi - self.size
            self._codes = np.concatenate(
                [self._codes, np.zeros((grow, self._codes.shape[1]), self._codes.dtype)])
            self._alive = np.concatenate([self._alive, np.zeros(grow, bool)])
        self._codes[ids] = codes
        self._alive[ids] = True
        self._dirty = True

    def delete_rows(self, rows):
        self._alive[np.asarray(rows)] = False
        self._dirty = True

    def _sync(self):
        if self._dirty or self._dev_codes is None:
            self._dev_codes = None  # drop the old placement before the new one lands
            self._dev_codes = shard_codes(self.mesh, self._codes.T)
            self._dirty = False
        return self._dev_codes

    def search(self, query: np.ndarray, limit: int = 10, mask: Optional[np.ndarray] = None):
        query = self._prep(query)
        ct = self._sync()
        n_pad = ct[0].shape[1] * self.n_shards
        m = self._alive.copy()
        if mask is not None:
            m &= np.asarray(mask[: self.size], dtype=bool)
        mk = shard_mask(self.mesh, m, n_pad)
        dtable = replicate(self.mesh, self.pq_codec.dist_mat(query))
        k = min(limit, max(self.size, 1))
        return _host(*sharded_adc_topk(self.mesh, dtable, ct, mk, k))

    def reset(self):
        self._codes = np.zeros((0, self.pq_codec.n_subvectors), dtype=self.pq_codec.code_dtype)
        self._alive = np.zeros(0, dtype=bool)
        self._dev_codes = None
        self._dirty = True

    # ----- snapshot state -----

    def state_arrays(self):
        return {
            'kind': np.array('sharded_pq'),
            'codes': self._codes.copy(),
            'alive': self._alive.copy(),
        }

    def load_state_arrays(self, state):
        self.reset()
        self._codes = np.asarray(state['codes'], dtype=self.pq_codec.code_dtype)
        self._alive = np.asarray(state['alive'], dtype=bool)
        self._dirty = True


class ShardedFlatIndex(BaseIndex):
    """Exact search over a mesh: int8 scan shards + shard-local float32
    rerank (the sharded twin of `index/flat.py` with ``scan_mode='int8'``).
    Returned distances are exact float32."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.COSINE,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
        device: Device = None,
        **kwargs,
    ):
        super().__init__(dim=dim, metric=metric, **kwargs)
        self.mesh = _mesh(mesh, n_devices, device)
        self._vectors = np.zeros((0, dim), dtype=np.float32)
        self._alive = np.zeros(0, dtype=bool)
        self._placed = None  # per-shard (x8, scale, norms, x_f32)
        self._dirty = True

    @property
    def size(self) -> int:
        return self._vectors.shape[0]

    @property
    def capacity(self) -> int:
        return self._vectors.shape[0]

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    def _prep(self, x: np.ndarray) -> np.ndarray:
        return _normalized(x, self.dim, self.metric == Metric.COSINE)

    def add_with_ids(self, x, ids):
        x = self._prep(x)
        ids = np.asarray(ids)
        hi = int(ids.max()) + 1 if len(ids) else 0
        if hi > self.size:
            grow = hi - self.size
            self._vectors = np.concatenate([self._vectors, np.zeros((grow, self.dim), np.float32)])
            self._alive = np.concatenate([self._alive, np.zeros(grow, bool)])
        self._vectors[ids] = x
        self._alive[ids] = True
        self._dirty = True

    def delete_rows(self, rows):
        self._alive[np.asarray(rows)] = False
        self._dirty = True

    def _sync(self):
        if self._dirty or self._placed is None:
            p = self.n_shards
            # on the card each shard's rows are padded to the fused kernel's
            # 8,192-row block (the padding is masked out), or the shard would
            # take the unfused scan (`ops/fused_scan.py` supports_fused_scan)
            cuda = any(dev.type == 'cuda' for dev in self.mesh.devices)
            unit = p * (8192 if cuda else 1)
            n_pad = max(-(-self.size // unit) * unit, unit)
            codes, scale = quantize_rows_int8(self._vectors)
            norms = np.sum(self._vectors * self._vectors, axis=1, dtype=np.float32)
            self._placed = None  # drop the old placement before the new one lands
            self._placed = tuple(shard_rows(self.mesh, a, n_pad)
                                 for a in (codes, scale, norms, self._vectors))
            self._dirty = False
        return self._placed

    def search(self, query: np.ndarray, limit: int = 10, mask: Optional[np.ndarray] = None):
        query = self._prep(query)
        x8, scale, norms, xf = self._sync()
        m = self._alive.copy()
        if mask is not None:
            m &= np.asarray(mask[: self.size], dtype=bool)
        mk = shard_mask(self.mesh, m, x8[0].shape[0] * self.n_shards)
        k = min(limit, max(self.size, 1))
        return _host(*sharded_scan_topk(self.mesh, replicate(self.mesh, query), x8, scale,
                                        norms, mk, xf, k, self.metric))

    def reset(self):
        self._vectors = np.zeros((0, self.dim), dtype=np.float32)
        self._alive = np.zeros(0, dtype=bool)
        self._placed = None
        self._dirty = True

    # ----- snapshot state -----

    def state_arrays(self):
        return {
            'kind': np.array('sharded_flat'),
            'vectors': self._vectors.copy(),
            'alive': self._alive.copy(),
        }

    def load_state_arrays(self, state):
        self.reset()
        self._vectors = np.asarray(state['vectors'], dtype=np.float32)
        self._alive = np.asarray(state['alive'], dtype=bool)
        self._dirty = True


class ShardedIVFPQIndex(IVFPQIndex):
    """IVF-PQ over a mesh: the blocked code store's BLOCK axis is sharded;
    each shard scans only its probed blocks and reranks its shortlist
    against slot-major bf16 vectors, then the per-shard winners are merged
    (`mesh.sharded_ivf_topk`).  Host bookkeeping is inherited from
    `IVFPQIndex` (`ops/ivf.BlockedCodes`); only placement and search
    differ."""

    def __init__(
        self,
        dim: int,
        pq_codec: PQCodec,
        rerank: int = 0,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
        device: Device = None,
        **kwargs,
    ):
        mesh = _mesh(mesh, n_devices, device)
        # rerank=0 at the parent: rerank vectors live slot-major here, not in
        # the parent's row-major DeviceBuffer
        super().__init__(dim=dim, pq_codec=pq_codec, rerank=0, device=mesh.devices[0],
                         **kwargs)
        self.rerank = rerank
        self.mesh = mesh
        self._vec_blocks = (
            np.zeros((0, self._store.bs, dim), np.float32) if rerank > 0 else None)
        self._placed = None
        self._pdirty = True

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    def add_with_ids(self, x, ids, cells=None, codes=None):
        x = self._prep(x)
        self._add_prepped(x, ids, cells, codes)
        if self._vec_blocks is not None:
            st = self._store
            if self._vec_blocks.shape[0] < st.n_blocks:
                grow = st.n_blocks - self._vec_blocks.shape[0]
                self._vec_blocks = np.concatenate(
                    [self._vec_blocks, np.zeros((grow, st.bs, self.dim), np.float32)])
            # a soft-assigned row (several cells) has one slot per copy: write
            # its vector into each (the JAX class fails on such rows)
            src, addr = [], []
            for i, r in enumerate(np.asarray(ids).astype(np.int64).ravel().tolist()):
                a = st._row_addr[r]
                for b in (a if isinstance(a, list) else [a]):
                    src.append(i)
                    addr.append(b)
            addr = np.asarray(addr, np.int64).reshape(-1, 2)
            self._vec_blocks[addr[:, 0], addr[:, 1]] = x[src]
        self._pdirty = True

    def delete_rows(self, rows):
        super().delete_rows(rows)
        self._pdirty = True

    def _blocks_per_shard(self) -> int:
        return -(-max(self._store.n_blocks, 1) // self.n_shards)

    def _sync_placed(self):
        if not self._pdirty and self._placed is not None:
            return self._placed
        st = self._store
        nb_pad = self._blocks_per_shard() * self.n_shards
        self._placed = None  # drop the old placement before the new one lands
        vb = None
        if self._vec_blocks is not None:
            vb = [t.to(torch.bfloat16) for t in shard_rows(self.mesh, self._vec_blocks, nb_pad)]
        self._placed = (shard_rows(self.mesh, st.codes, nb_pad),
                        shard_rows(self.mesh, st.mask, nb_pad),
                        shard_rows(self.mesh, st.row_map, nb_pad, pad_value=-1), vb)
        self._pdirty = False
        return self._placed

    def _sel_local(self, sel: np.ndarray) -> np.ndarray:
        """Global block ids -> per-shard LOCAL id lists [P, S_max] (pad -1)."""
        n_dev = self.n_shards
        bps = self._blocks_per_shard()
        shard = sel // bps
        local = sel % bps
        counts = np.bincount(shard, minlength=n_dev)
        s_max = max(int(counts.max()) if counts.size else 0, 1)
        out = np.full((n_dev, s_max), -1, np.int32)
        for s in range(n_dev):
            ls = local[shard == s]
            out[s, : len(ls)] = ls
        return out

    def search(
        self,
        query: np.ndarray,
        limit: int = 10,
        mask: Optional[np.ndarray] = None,
        cells: Optional[np.ndarray] = None,
    ):
        query = self._prep(query)
        st = self._store
        q = query.shape[0]
        if cells is None:
            sel = np.arange(st.n_blocks, dtype=np.int64)
        else:
            sel = st.select_blocks(np.unique(np.asarray(cells))).astype(np.int64)
        if sel.size == 0:
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64)
        dtable = replicate(self.mesh, self.pq_codec.dist_mat(query))
        cb, mb, rm, vb = self._sync_placed()
        if mask is not None:
            # the predicate ANDed on each shard through its resident row map:
            # only the [N]-byte predicate is uploaded
            from ..ops.ivf import slot_mask_device

            pred = replicate(self.mesh, np.asarray(mask).astype(np.int8))
            mb = [slot_mask_device(m, r, p) for m, r, p in zip(mb, rm, pred)]
        kwargs = {}
        if self.rerank > 0 and vb is not None:
            kwargs = dict(queries=replicate(self.mesh, query), vec_blocks=vb,
                          rerank=max(self.rerank, limit), metric=self.metric)
        k = min(limit, max(self.size, 1))
        # soft-assigned rows can come back once per probed copy: ask for twice
        # as many and keep each row's best copy, as IVFPQIndex does (the JAX
        # class returns the repeats)
        d, rows = sharded_ivf_topk(
            self.mesh, shard_rows(self.mesh, self._sel_local(sel)), dtable, cb, mb, rm,
            2 * k if st.multi else k, **kwargs)
        if st.multi:
            d, rows = _dedup_candidates(d, rows)
        return _host(d[:, :k], rows[:, :k])

    def reset(self):
        super().reset()
        if self._vec_blocks is not None:
            self._vec_blocks = np.zeros((0, self._store.bs, self.dim), np.float32)
        self._placed = None
        self._pdirty = True

    # ----- snapshot state -----

    def state_arrays(self):
        out = super().state_arrays()
        out['kind'] = np.array('sharded_ivf_pq')
        if self._vec_blocks is not None:
            out['vec_blocks'] = self._vec_blocks.copy()
        return out

    def load_state_arrays(self, state):
        super().load_state_arrays(state)
        if self._vec_blocks is not None and 'vec_blocks' in state:
            self._vec_blocks = np.asarray(state['vec_blocks'], np.float32)
        self._pdirty = True


class ShardedGraphIndex(BaseIndex):
    """Graph serving over a mesh: rows are assigned round-robin to shards
    (global = local·P + shard), each shard builds its OWN sub-graph (the
    host C++ Vamana, or `index/device_build.py` on the shard's device with
    ``build_mode='device'``), and a search beams every sub-graph and merges
    (`mesh.sharded_beam_topk`)."""

    # a mask widens each shard's beam and rerank to 4 * limit
    widens_for_mask = True

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.COSINE,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
        max_degree: int = 32,
        alpha: float = 1.2,
        l_build: int = 64,
        ef_search: int = 64,
        beam_width: int = 16,
        pq_codec: Optional[PQCodec] = None,
        rerank: int = 0,
        build_mode: str = 'host',
        entry_mode: str = 'sample',
        n_entry_samples: int = 256,
        entry_width: int = 8,
        filter_fallback_selectivity: float = 0.25,
        device: Device = None,
        **kwargs,
    ):
        super().__init__(dim=dim, metric=metric, **kwargs)
        if build_mode not in ('host', 'device'):
            raise ValueError(f'unknown build_mode {build_mode!r}')
        self.mesh = _mesh(mesh, n_devices, device)
        # per-shard multi-entry seeding (see index/graph.py entry_mode)
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
        self.build_mode = build_mode
        # below this predicate selectivity a filtered search is an exact scan
        # over the passing rows (as GraphIndex)
        self.filter_fallback_selectivity = filter_fallback_selectivity
        self.reset()

    def _new_graph(self, device: torch.device):
        metric_ip = self.metric != Metric.EUCLIDEAN
        if self.build_mode == 'device':
            from ..index.device_build import DeviceVamanaBuilder

            return DeviceVamanaBuilder(
                self.dim, max_degree=self.max_degree, alpha=self.alpha, metric_ip=metric_ip,
                l_build=self.l_build, beam_width=self.beam_width, device=device)
        from ..index.vamana_lib import VamanaGraph

        return VamanaGraph(self.dim, max_degree=self.max_degree, alpha=self.alpha,
                           metric_ip=metric_ip, l_build=self.l_build)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def size(self) -> int:
        return int(self._alive.shape[0])

    @property
    def capacity(self) -> int:
        return self.size

    def _prep(self, x: np.ndarray) -> np.ndarray:
        return _normalized(x, self.dim, self.metric == Metric.COSINE)

    def _shard_vectors(self, s: int) -> np.ndarray:
        if self.build_mode == 'device':
            return self._shards[s].vectors
        return self._host_vecs[s]

    def _shard_adjacency(self, s: int) -> np.ndarray:
        """What serving traverses: a device build's W-wide graph (its slack
        back-edges carry recall), the host build's R-wide one."""
        g = self._shards[s]
        return np.asarray(g.raw_adjacency() if self.build_mode == 'device'
                          else g.adjacency(), np.int32)

    def add_with_ids(self, x: np.ndarray, ids: np.ndarray):
        ids = np.asarray(ids)
        if len(ids) and not (ids[0] == self.size and np.all(np.diff(ids) == 1)):
            raise ValueError(
                f'ShardedGraphIndex requires contiguous appends; got rows '
                f'starting {ids[:3]} at size {self.size}')
        x = self._prep(x)
        p = self.n_shards
        for s in range(p):
            sel = (ids % p) == s
            if sel.any():
                xs = x[sel]
                if self.build_mode == 'device':
                    self._shards[s].add(xs)
                else:
                    self._shards[s].add(xs, n_threads=0)
                    self._host_vecs[s] = np.concatenate([self._host_vecs[s], xs])
        self._alive = np.concatenate([self._alive, np.ones(len(ids), bool)])
        self._dirty = True

    def delete_rows(self, rows):
        self._alive[np.asarray(rows)] = False
        self._dirty = True

    @property
    def n_deleted(self) -> int:
        return int((~self._alive).sum())

    @property
    def dead_fraction(self) -> float:
        n = self._alive.shape[0]
        return float(self.n_deleted) / n if n else 0.0

    def _sync_placed(self):
        if not self._dirty and self._placed is not None:
            return self._placed
        p = self.n_shards
        adjs = [self._shard_adjacency(s) for s in range(p)]
        vecs = [np.asarray(self._shard_vectors(s), np.float32) for s in range(p)]
        meds = [int(self._shards[s].medoid) for s in range(p)]
        sizes = [a.shape[0] for a in adjs]
        cap = max(max(sizes), 1)
        w = max(a.shape[1] for a in adjs) if max(sizes) else self.max_degree
        adj = np.full((p * cap, w), -1, np.int32)
        vx = np.zeros((p * cap, self.dim), np.float32)
        alive = np.zeros(p * cap, np.int8)
        for s in range(p):
            n_s = sizes[s]
            if n_s:
                adj[s * cap: s * cap + n_s, : adjs[s].shape[1]] = adjs[s][:n_s]
                vx[s * cap: s * cap + n_s] = vecs[s][:n_s]
                # global row of shard-local i is i*p + s
                alive[s * cap: s * cap + n_s] = self._alive[np.arange(n_s) * p + s]
        use_pq = self.pq_codec is not None and self.rerank == 0
        codes_d = None
        if self.pq_codec is not None:
            codes = np.zeros((p * cap, self.pq_codec.n_subvectors), self.pq_codec.code_dtype)
            for s in range(p):
                if sizes[s]:
                    # encode ONLY the rows appended since the last sync
                    cached = self._shard_codes[s]
                    if cached.shape[0] < sizes[s]:
                        fresh = self.pq_codec.encode(vecs[s][cached.shape[0]: sizes[s]])
                        cached = np.concatenate([cached, fresh]) if cached.size else fresh
                        self._shard_codes[s] = cached
                    codes[s * cap: s * cap + sizes[s]] = cached[: sizes[s]]
            codes_d = shard_rows(self.mesh, codes)
        vdt = torch.bfloat16 if self.pq_codec is not None else torch.float32
        if use_pq:
            # the low-memory mode: the table traversal at rerank 0 never reads
            # the vectors, so a 1-row-per-shard placeholder replaces them
            vx = np.zeros((p, self.dim), np.float32)
        sample_vecs = sample_ids = None
        # seeds sampled only for the vector-scored traversal: under the coarse
        # table scores the medoid's longer walk is the recall
        if self.entry_mode == 'sample' and not use_pq:
            ns = max(min(self.n_entry_samples, min(x or 1 for x in sizes)), 1)
            sv = np.zeros((p * ns, self.dim), np.float32)
            si = np.zeros(p * ns, np.int32)
            for s in range(p):
                loc = (np.arange(ns, dtype=np.int64) * max(sizes[s], 1) // ns).astype(np.int32)
                loc = np.minimum(loc, max(sizes[s] - 1, 0))
                si[s * ns: (s + 1) * ns] = loc
                if sizes[s]:
                    sv[s * ns: (s + 1) * ns] = vecs[s][loc]
            sample_vecs = [t.to(vdt) for t in shard_rows(self.mesh, sv)]
            sample_ids = shard_rows(self.mesh, si)
        self._placed = None  # drop the old placement before the new one lands
        self._placed = dict(
            adj=shard_rows(self.mesh, adj, pad_value=-1),
            vecs=[t.to(vdt) for t in shard_rows(self.mesh, vx)],
            medoids=shard_rows(self.mesh, np.asarray(meds, np.int32)),
            alive=shard_rows(self.mesh, alive),
            codes=codes_d,
            use_pq=use_pq,
            cap=cap,
            sample_vecs=sample_vecs,
            sample_ids=sample_ids,
        )
        self._dirty = False
        return self._placed

    def search(self, query: np.ndarray, limit: int = 10, mask: Optional[np.ndarray] = None):
        if self.size == 0:
            q = len(np.atleast_2d(query))
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64)
        query = self._prep(query)
        if (mask is not None and float(np.mean(np.asarray(mask, dtype=bool)))
                < self.filter_fallback_selectivity):
            # selective predicate: the beams would mostly visit non-passing
            # nodes, and the post-merge headroom would pad with BIG rows
            return self._masked_exact_scan(query, np.asarray(mask, bool), limit)
        pl = self._sync_placed()
        k = min(4 * limit if mask is not None else limit, self.size)
        kwargs = {}
        if pl['use_pq']:
            kwargs = dict(codes=pl['codes'],
                          dtable=replicate(self.mesh, self.pq_codec.dist_mat(query)))
        d, ids = _host(*sharded_beam_topk(
            self.mesh, pl['adj'], pl['vecs'], pl['medoids'], replicate(self.mesh, query),
            self.metric == Metric.EUCLIDEAN, k, L=max(self.ef_search, 4 * limit),
            B=self.beam_width, rerank=self.rerank, alive=pl['alive'],
            sample_vecs=pl['sample_vecs'], sample_ids=pl['sample_ids'],
            entry_width=self.entry_width, **kwargs))
        if mask is not None:
            from ..ops import BIG

            m = np.asarray(mask).astype(bool)
            valid = (ids >= 0) & (ids < len(m))
            passing = np.where(valid, m[np.clip(ids, 0, len(m) - 1)], False)
            d = np.where(passing, d, np.float32(BIG))
            order = np.argsort(d, axis=1, kind='stable')
            d = np.take_along_axis(d, order, axis=1)
            ids = np.take_along_axis(ids, order, axis=1)
        return d[:, :limit], ids[:, :limit]

    def check_integrity(self) -> dict:
        """Per-shard graph-health reports + aggregate verdict (see
        `index/graph.py` ``graph_integrity_report``)."""
        from ..index.graph import graph_integrity_report

        shards = []
        for s in range(self.n_shards):
            a = self._shard_adjacency(s)
            if a.shape[0] == 0:
                shards.append({'n': 0, 'ok': True})
                continue
            shards.append(graph_integrity_report(a, int(self._shards[s].medoid), a.shape[0]))
        return {
            'n': self.size,
            'n_shards': self.n_shards,
            'dead_fraction': self.dead_fraction,
            'ok': all(r['ok'] for r in shards),
            'shards': shards,
        }

    def _gather_rows(self, rows: np.ndarray) -> np.ndarray:
        """Vectors of GLOBAL rows from the per-shard host copies (global row g
        lives on shard g % P at local index g // P)."""
        rows = np.asarray(rows)
        out = np.zeros((len(rows), self.dim), np.float32)
        p = self.n_shards
        for s in range(p):
            sel = (rows % p) == s
            if sel.any():
                out[sel] = self._shard_vectors(s)[rows[sel] // p]
        return out

    def _masked_exact_scan(self, query, mask, limit):
        """The exact scan over the passing rows, on the shards' devices.
        Without a codec each shard scans its placed float32 rows under its
        slice of the mask (`index/graph.py` ``_masked_exact_scan``) and the
        winners are merged; with one the placed rows are bf16 or a
        placeholder, so the passing rows' float32 copies are uploaded and
        scored on the first device."""
        from ..index.graph import _distances, _masked_exact_scan

        m = mask[: self.size] & self._alive[: min(len(mask), self.size)]
        rows = np.flatnonzero(m)
        q = np.atleast_2d(query)
        if rows.size == 0:
            return np.zeros((len(q), 0), np.float32), np.zeros((len(q), 0), np.int64)
        k = min(limit, rows.size)
        euclid = self.metric == Metric.EUCLIDEAN
        if self.pq_codec is not None:
            dev0 = self.mesh.devices[0]
            v = torch.from_numpy(self._gather_rows(rows)).to(dev0)
            d, pos = topk(_distances(torch.from_numpy(q).to(dev0), v, euclid), k)
            return _host(d, torch.from_numpy(rows).to(dev0)[pos])
        pl = self._sync_placed()
        p, cap, dev0 = self.n_shards, pl['cap'], self.mesh.devices[0]
        # global row g is shard g % P's local row g // P
        local = np.zeros(p * cap, bool)
        local[(rows % p) * cap + rows // p] = True
        qs = replicate(self.mesh, q)
        ds, gs = [], []
        for s, (v, mk) in enumerate(zip(pl['vecs'], shard_rows(self.mesh, local))):
            d, ids = _masked_exact_scan(v, qs[s], mk, euclid, min(k, cap))
            ds.append(d.to(dev0))
            gs.append((ids.long() * p + s).to(dev0))
        # the winners in global row order, then a stable top-k: ties go to
        # the lower row, as in a scan of the rows in order
        g_all, order = torch.sort(torch.cat(gs, dim=1), dim=1)
        d, pos = topk(torch.gather(torch.cat(ds, dim=1), 1, order), k)
        return _host(d, torch.gather(g_all, 1, pos))

    def reset(self):
        self._shards = [self._new_graph(dev) for dev in self.mesh.devices]
        # host builds keep no vector copy a caller can read: one per shard
        self._host_vecs = [np.zeros((0, self.dim), np.float32) for _ in range(self.n_shards)]
        self._alive = np.zeros(0, dtype=bool)  # global rows
        self._placed = None
        self._dirty = True
        # per-shard PQ-code cache: a sync encodes only appended rows
        self._shard_codes = [
            np.zeros((0, self.pq_codec.n_subvectors), self.pq_codec.code_dtype)
            if self.pq_codec is not None else None
            for _ in range(self.n_shards)
        ]

    # ----- snapshot state -----

    def state_arrays(self):
        p = self.n_shards
        adjs = [self._shard_adjacency(s) for s in range(p)]
        sizes = np.asarray([a.shape[0] for a in adjs], np.int64)
        cap = max(int(sizes.max()), 1)
        w = max(a.shape[1] for a in adjs)
        adj = np.full((p, cap, w), -1, np.int32)
        vx = np.zeros((int(sizes.sum()), self.dim), np.float32)
        for s in range(p):
            if sizes[s]:
                adj[s, : sizes[s], : adjs[s].shape[1]] = adjs[s]
                gl = np.arange(sizes[s]) * p + s
                vx[gl] = np.asarray(self._shard_vectors(s), np.float32)[: sizes[s]]
        return {
            'kind': np.array('sharded_graph'),
            'vectors': vx,
            'adjacency': adj,
            'sizes': sizes,
            'alive': self._alive.copy(),
        }

    def load_state_arrays(self, state):
        self.reset()
        v = np.asarray(state['vectors'], np.float32)
        if not v.size:
            return
        adj = np.asarray(state['adjacency'])
        sizes = np.asarray(state['sizes'])
        p = self.n_shards
        if len(sizes) != p:
            raise ValueError(
                f'snapshot has {len(sizes)} shards, mesh has {p}; re-add vectors to reshard')
        for s in range(p):
            n_s = int(sizes[s])
            if n_s == 0:
                continue
            gl = np.arange(n_s) * p + s
            a = np.ascontiguousarray(adj[s, :n_s])
            if self.build_mode == 'host' and a.shape[1] > self.max_degree:
                # consolidate to the R nearest (plain column truncation drops
                # the connectivity-bearing slack back-edges)
                from ..index.graph import consolidate_adjacency

                a = consolidate_adjacency(np.ascontiguousarray(v[gl]), a, self.max_degree,
                                          metric_ip=self.metric != Metric.EUCLIDEAN)
            self._shards[s].load(v[gl], a)
            if self.build_mode == 'host':
                self._host_vecs[s] = np.ascontiguousarray(v[gl])
        self._alive = np.array(state['alive'], dtype=bool)
        self._dirty = True
