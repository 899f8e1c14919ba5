"""AnnLite — the public facade; the port of `annlite_tpu/index_api.py`.

A default ``AnnLite`` runs the flat index; ``n_subvectors`` adds a PQ codec
and ``index_type='auto'`` resolves to the PQ scan, and with ``n_cells > 1``
also a VQ coarse quantizer and the IVF-PQ index.  ``index_type='graph'``
runs the graph index (a host or, with ``graph_build_mode='device'``, a
device Vamana build; beam search on the device), scored with a PQ codec when
``n_subvectors`` is given.  ``use_opq`` makes the PQ codec an OPQ codec (a
learned rotation before PQ); ``n_components`` puts a PCA projector in front:
the index, the PQ codec and searches then work in the projected space, while
the VQ coarse quantizer keeps the input space, as in the JAX package.
Codec-backed indexes are built once the codecs are trained (``train``, or
``partial_train`` + ``build_codebooks``, or codecs found in the model
directory).  The ``sharded_*`` index types (`parallel/`) shard the rows
over ``make_mesh``'s default mesh on ``device``: one shard per card, or
:data:`~annlite_torch.parallel.mesh.CPU_SHARDS` virtual shards on the CPU.

Snapshots, codec files and ``params_hash`` match the JAX package's, so one
``data_path`` serves both packages: each opens the other's doc store,
tables, codecs and index snapshots.  So do the archives of ``backup`` (local,
or uploaded to an artifact store through `artifacts.py`): either package
restores the other's.
"""
import hashlib
import json
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .codecs import OPQCodec, PQCodec, ProjectorCodec, VQCodec
from .container import CellContainer
from .convert import (flat_index_from_jax_state, graph_index_from_jax_state,
                      ivf_pq_index_from_jax_state, pq_scan_index_from_jax_state,
                      sharded_flat_index_from_jax_state, sharded_graph_index_from_jax_state,
                      sharded_ivf_pq_index_from_jax_state, sharded_pq_index_from_jax_state)
from .device import resolve_device
from .doc import Doc, docs_to_embeddings
from .enums import ExpandMode, Metric, parse_metric
from .helper import setup_logging
from .index.flat import FlatIndex
from .index.graph import GraphIndex
from .index.ivf_pq import IVFPQIndex
from .index.pq_scan import PQScanIndex
from .math import cdist, top_k
from .parallel import ShardedFlatIndex, ShardedGraphIndex, ShardedIVFPQIndex, ShardedPQIndex
from .profile import span

MAX_TRAINING_DATA_SIZE = 10240
INDEX_TYPES = ('auto', 'flat', 'pq_scan', 'graph', 'ivf_pq', 'sharded_pq',
               'sharded_flat', 'sharded_ivf_pq', 'sharded_graph')


class AnnLite:
    def __init__(
        self,
        n_dim: int,
        metric: Union[str, Metric] = Metric.COSINE,
        n_cells: int = 1,
        n_subvectors: Optional[int] = None,
        n_clusters: int = 256,
        n_probe: int = 16,
        n_components: Optional[int] = None,
        initial_size: Optional[int] = None,
        expand_step_size: int = 10240,
        expand_mode: Union[str, 'ExpandMode'] = None,
        columns: Optional[List[Tuple[str, type]]] = None,
        filterable_attrs: Optional[Dict[str, type]] = None,
        data_path: Union[str, Path] = './data',
        create_if_missing: bool = True,
        read_only: bool = False,
        verbose: bool = False,
        exact_topk: bool = False,
        rerank: int = 0,
        scan_mode: str = 'int8',
        index_type: str = 'auto',
        use_opq: bool = False,
        max_degree: int = 32,
        ef_construction: int = 64,
        ef_search: int = 64,
        graph_build_mode: str = 'host',
        auto_compact_dead_fraction: Optional[float] = None,
        n_assign: int = 1,
        assign_margin: float = 0.05,
        device: Optional[Union[str, torch.device]] = None,
        **kwargs,
    ):
        # extra keywords are accepted and ignored, as the JAX facade does: the
        # serving executor and DocumentArray pass user config straight in
        if index_type not in INDEX_TYPES:
            raise ValueError(f'unknown index_type {index_type!r}')
        self.logger = setup_logging(verbose)
        self.n_dim = n_dim
        self.metric = parse_metric(metric)
        self.n_cells = n_cells
        self.n_subvectors = n_subvectors
        self.n_clusters = n_clusters
        # the reference clamps n_probe UP to n_cells, so it always probes
        # every cell; the JAX package clamps DOWN so that IVF pruning is
        # reachable through the facade, and so does the port
        self.n_probe = min(n_probe, n_cells) if n_cells > 1 else 1
        self.n_assign = max(1, int(n_assign))
        self.assign_margin = float(assign_margin)
        self.n_components = n_components
        self.initial_size = initial_size
        self.expand_step_size = expand_step_size
        if expand_mode is None:
            expand_mode = ExpandMode.ADAPTIVE
        elif isinstance(expand_mode, str):
            expand_mode = ExpandMode.from_string(expand_mode)
        self.expand_mode = expand_mode
        self.read_only = read_only
        # only the PQ scan reads it: the full ADC scores (K5) and an exact
        # top-k instead of the deep select
        self.exact_topk = exact_topk
        self.rerank = rerank
        self.scan_mode = scan_mode
        self.index_type = index_type
        self.use_opq = use_opq
        # graph knobs: degree bound and build beam of the Vamana graph, the
        # search beam (ef), the build ('host' or 'device'), and the dead fraction
        # above which a delete compacts the index
        self.max_degree = max_degree
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.graph_build_mode = graph_build_mode
        self.auto_compact_dead_fraction = auto_compact_dead_fraction
        self.device = resolve_device(device)

        if columns is None and filterable_attrs:
            columns = list(filterable_attrs.items())
        self._columns = columns or []

        self.data_path = Path(data_path)
        if create_if_missing:
            self.data_path.mkdir(parents=True, exist_ok=True)
        elif not self.data_path.exists():
            raise FileNotFoundError(
                f'data_path {self.data_path} does not exist and '
                f'create_if_missing=False'
            )

        # the dimension the index and the PQ codec work in
        self.index_dim = n_components if n_components else n_dim

        # ----- codecs (load or init) -----
        self._projector_codec = (
            ProjectorCodec(n_dim, n_components=n_components, device=self.device)
            if n_components else None
        )
        self._vq_codec = (
            VQCodec(n_cells, metric=self.metric, device=self.device)
            if n_cells > 1 else None
        )
        pq_cls = OPQCodec if use_opq else PQCodec
        self._pq_codec = (
            pq_cls(self.index_dim, n_subvectors=n_subvectors, n_clusters=n_clusters,
                   metric=self.metric, device=self.device)
            if n_subvectors else None
        )
        self._load_codecs_if_exist()

        self._container: Optional[CellContainer] = None
        if self.is_trained or not self._requires_training:
            self._build_container()

        # auto-train from stored docs, then restore
        if self._container is None and self._stored_docs_exist():
            self._auto_train_from_store()
        if (
            self._container is not None
            and self.index_size == 0
            and (self._latest_snapshot() is not None or self.total_docs > 0)
        ):
            self._maybe_restore()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    @property
    def _codecs(self):
        return (self._projector_codec, self._vq_codec, self._pq_codec)

    @property
    def _requires_training(self) -> bool:
        return any(c is not None for c in self._codecs)

    @property
    def is_trained(self) -> bool:
        return all(c is None or c.is_trained for c in self._codecs)

    def _kind(self) -> str:
        if self.index_type != 'auto':
            return self.index_type
        if self._pq_codec is not None:
            return 'ivf_pq' if self.n_cells > 1 else 'pq_scan'
        return 'flat'

    def _grow_kwargs(self) -> dict:
        return dict(initial_size=self.initial_size,
                    expand_step_size=self.expand_step_size,
                    expand_mode=self.expand_mode)

    def _index_kwargs(self) -> dict:
        """Constructor arguments of the index of this configuration (all but
        the codec)."""
        kind = self._kind()
        if (kind in ('pq_scan', 'ivf_pq', 'sharded_pq', 'sharded_ivf_pq')
                and self._pq_codec is None):
            raise ValueError(f'index_type={kind} requires n_subvectors')
        if kind in ('graph', 'sharded_graph'):
            return dict(metric=self.metric, max_degree=self.max_degree,
                        l_build=self.ef_construction, ef_search=self.ef_search,
                        rerank=self.rerank, build_mode=self.graph_build_mode,
                        device=self.device)
        if kind in ('ivf_pq', 'sharded_ivf_pq'):
            return dict(rerank=self.rerank, device=self.device)
        if kind == 'sharded_pq':
            return dict(device=self.device)
        if kind == 'sharded_flat':
            return dict(metric=self.metric, device=self.device)
        if kind == 'pq_scan':
            return dict(exact_topk=self.exact_topk, rerank=self.rerank,
                        device=self.device, **self._grow_kwargs())
        return dict(metric=self.metric, scan_mode=self.scan_mode, device=self.device,
                    **self._grow_kwargs())

    def _new_index(self):
        kind = self._kind()
        kw = self._index_kwargs()
        if kind in ('graph', 'sharded_graph'):
            cls = GraphIndex if kind == 'graph' else ShardedGraphIndex
            return cls(self.index_dim, pq_codec=self._pq_codec, **kw)
        codec_indexes = {'ivf_pq': IVFPQIndex, 'pq_scan': PQScanIndex,
                         'sharded_pq': ShardedPQIndex, 'sharded_ivf_pq': ShardedIVFPQIndex}
        if kind in codec_indexes:
            return codec_indexes[kind](self.index_dim, self._pq_codec, **kw)
        cls = ShardedFlatIndex if kind == 'sharded_flat' else FlatIndex
        return cls(self.index_dim, **kw)

    def _build_container(self):
        self._container = CellContainer(
            dim=self.n_dim,
            index=self._new_index(),
            metric=self.metric,
            columns=self._columns,
            data_path=self.data_path,
            projector_codec=self._projector_codec,
        )

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _sanity_check(self, x: np.ndarray):
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.n_dim:
            raise ValueError(
                f'inputs must be a 2D array of dimension {self.n_dim}, got '
                f'shape {x.shape}'
            )
        return x

    def train(self, x: np.ndarray, auto_save: bool = True, force_train: bool = False):
        x = self._sanity_check(x)
        if self.is_trained and not force_train:
            self.logger.warning(
                'The annlite has been trained or is not trainable. '
                'Please use `force_train=True` to retrain.'
            )
            return
        if self._projector_codec:
            self.logger.info(f'Training Projector codec with {x.shape[0]} vectors')
            self._projector_codec.fit(x)
        xp = self._projector_codec.encode(x) if self._projector_codec else x
        if self._vq_codec:
            self.logger.info(f'Training VQ codec (K={self.n_cells})')
            self._vq_codec.fit(x)
        if self._pq_codec:
            self.logger.info(f'Training PQ codec (m={self.n_subvectors})')
            self._pq_codec.fit(xp)
        if auto_save:
            self.dump_model()
        if self._container is None:
            self._build_container()

    def partial_train(self, x: np.ndarray, auto_save: bool = True,
                      force_train: bool = False):
        x = self._sanity_check(x)
        if self.is_trained and not force_train:
            self.logger.warning('The annlite has been trained; use force_train=True')
            return
        proj = self._projector_codec
        if proj:
            proj.partial_fit(x)
        xp = proj.encode(x) if proj and proj.is_trained else x
        if self._vq_codec:
            self._vq_codec.partial_fit(x)
        if self._pq_codec and xp.shape[1] == self.index_dim:
            self._pq_codec.partial_fit(xp)
        if auto_save:
            self.dump_model()

    def build_codebooks(self):
        """Freeze the partial_fit state (needed before use after
        partial_train)."""
        for c in (self._vq_codec, self._pq_codec):
            if c is not None and not c.is_trained:
                c.build_codebook()
        if self._container is None and self.is_trained:
            self._build_container()

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def _check_writable(self):
        if self.read_only:
            raise RuntimeError('the indexer is read-only, cannot modify it')
        if not self.is_trained:
            raise RuntimeError('the indexer is not trained, cannot add new documents')
        if self._container is None:
            self._build_container()

    def _check_trained(self):
        if not self.is_trained:
            raise RuntimeError('the indexer is not trained, cannot search')

    def _cells(self, x: np.ndarray) -> np.ndarray:
        """Each row's IVF cell (``[n]``), or its soft assignment (``[n, a]``,
        -1 pads) when ``n_assign > 1``; cell 0 without a VQ codec."""
        if self._vq_codec is None:
            return np.zeros(x.shape[0], dtype=np.int64)
        if self.n_assign > 1 and getattr(self._container.index, 'wants_cells', False):
            # boundary points are stored in up to n_assign cells (the IVF
            # index dedups at search)
            return self._vq_codec.encode_multi(x, n_assign=self.n_assign,
                                               margin=self.assign_margin)
        return np.asarray(self._vq_codec.encode(x)).reshape(-1)

    def index(self, docs: List[Doc]):
        with span('annlite.ingest'):
            self._check_writable()
            x = self._sanity_check(docs_to_embeddings(docs))
            self._container.insert(x, self._cells(x), docs)

    def update(
        self,
        docs: List[Doc],
        insert_if_not_found: bool = True,
        raise_errors_on_not_found: bool = False,
    ):
        self._check_writable()
        x = self._sanity_check(docs_to_embeddings(docs))
        self._container.update(
            x, self._cells(x), docs, insert_if_not_found, raise_errors_on_not_found
        )

    def delete(
        self,
        docs: Union[List[Doc], List[str]],
        raise_errors_on_not_found: bool = False,
    ):
        self._check_writable()
        ids = [d.id if isinstance(d, Doc) else d for d in docs]
        self._container.delete(ids, raise_errors_on_not_found)
        self._maybe_auto_compact()

    def _maybe_auto_compact(self):
        """Reclaim soft-deleted rows once the dead fraction exceeds
        ``auto_compact_dead_fraction`` (the graph keeps dead nodes in its
        adjacency until compaction)."""
        thr = self.auto_compact_dead_fraction
        if thr is None:
            return
        dead = getattr(self._container.index, 'dead_fraction', None)
        if dead is None:
            alive = self._container._alive
            dead = float((~alive).sum()) / len(alive) if len(alive) else 0.0
        if dead > thr:
            self.logger.info(f'auto-compact: dead fraction {dead:.2f} > {thr:.2f}')
            self.compact()

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _cell_selection(self, query_np: np.ndarray) -> Optional[np.ndarray]:
        """Per-query top-``n_probe`` cells through the VQ codebook."""
        if self._vq_codec is None:
            return None
        cb = torch.from_numpy(np.ascontiguousarray(self._vq_codec.codebook))
        q = torch.from_numpy(np.ascontiguousarray(query_np, dtype=np.float32))
        dists = cdist(q.to(self.device), cb.to(self.device), metric=self.metric)
        _, cells = top_k(dists, k=min(self.n_probe, self.n_cells))
        return cells.cpu().numpy()

    def search(
        self,
        docs: List[Doc],
        filter: Optional[Dict] = None,
        limit: int = 10,
        include_metadata: bool = True,
    ):
        """Attach ``matches`` (with scores) to each query doc."""
        with span('annlite.search'):
            self._check_trained()
            x = docs_to_embeddings(docs)
            match_docs, _, _ = self._container.search_cells(
                x, cells=self._cell_selection(x), filter=filter, limit=limit,
                include_metadata=include_metadata,
            )
            for doc, matches in zip(docs, match_docs):
                doc.matches = matches
            return docs

    def search_by_vectors(
        self,
        query_np: np.ndarray,
        filter: Optional[Dict] = None,
        limit: int = 10,
        include_metadata: bool = False,
    ):
        with span('annlite.search'):
            self._check_trained()
            query_np = self._sanity_check(query_np)
            match_docs, _, _ = self._container.search_cells(
                query_np, cells=self._cell_selection(query_np), filter=filter,
                limit=limit, include_metadata=include_metadata,
            )
            return match_docs

    def search_numpy(
        self, query_np: np.ndarray, filter: Optional[Dict] = None, limit: int = 10
    ):
        """Returns (dists, doc_ids) ragged lists."""
        with span('annlite.search'):
            self._check_trained()
            query_np = self._sanity_check(query_np)
            return self._container.search_numpy(
                query_np, filter=filter, limit=limit,
                cells=self._cell_selection(query_np),
            )

    def device_searcher(self, limit: int = 10, mask: Optional[np.ndarray] = None):
        """Device-resident searcher over the index: ``query [Q, D] float32 ->
        (dists [Q, limit], global_rows [Q, limit])`` as tensors on the
        device, with no host transfer of the corpus — the serving hot path.
        Returns GLOBAL ROWS (map them to doc ids with :meth:`rows_to_docids`).
        The flat and graph indexes have one, as in the JAX package.  The
        graph tracks its deletes itself and takes no mask; the flat index
        does not, so the container's alive bitmap is fused into the captured
        mask: deleted docs never surface.  With ``n_components`` the queries
        are projected on the device first.  Rebuild after writes; after
        :meth:`restore` replaced the index, the searcher raises instead of
        serving the old rows."""
        self._check_trained()
        container = self._container
        idx = container.index
        if not hasattr(idx, 'device_searcher'):
            raise NotImplementedError(
                f'{type(idx).__name__} has no device-resident searcher')
        if hasattr(idx, 'delete_rows'):
            if mask is not None:
                raise ValueError(f'{type(idx).__name__}.device_searcher takes no mask')
            run = idx.device_searcher(limit=limit)
        else:
            alive = self._container._alive
            if mask is None:
                mask = alive
            else:
                u = np.asarray(mask[: len(alive)]).astype(bool)
                mask = u & alive[: len(u)]
            run = idx.device_searcher(limit=limit, mask=mask)
        proj = self._projector_codec

        def search(query):
            if container.index is not idx:
                raise RuntimeError('the index was replaced (restore) after this '
                                   'searcher was taken; take a new one')
            return run(query if proj is None else proj.encode_tensor(query))

        return search

    def serving_searcher(self, limit: int = 10, mask: Optional[np.ndarray] = None):
        """Serving closure: the device-resident searcher plus ONE row->doc-id
        mapping per call.  ``query [Q, D]`` -> ``(dists [Q, limit]
        np.ndarray, doc_ids [Q][limit] list)``.  Rebuild after writes."""
        run = self.device_searcher(limit=limit, mask=mask)
        # materialize the row->doc-id array now: the per-call mapping becomes
        # a numpy index instead of a chunked SELECT
        self._container.cell_table.docids_array()

        def search(query):
            d, rows = run(query)
            return d.cpu().numpy(), self.rows_to_docids(rows.cpu().numpy())

        return search

    def rows_to_docids(self, rows):
        """Map global rows (e.g. a ``device_searcher`` result, any shape) to
        doc ids in ONE batched lookup; invalid/deleted rows map to None.
        Returns a list shaped like ``rows``'s leading axes."""
        if isinstance(rows, torch.Tensor):
            rows = rows.cpu().numpy()
        rows = np.asarray(rows)
        flat = self._container.cell_table.get_docids_by_rows(
            [int(r) for r in rows.reshape(-1)]
        )
        if rows.ndim <= 1:
            return flat
        w = rows.shape[-1]
        return [flat[i : i + w] for i in range(0, len(flat), w)]

    def check_integrity(self) -> dict:
        """Index-health report (hnswlib's ``checkIntegrity``).  For the graph:
        reachability, degrees, invalid edges, dead fraction — run it after a
        restore to validate a snapshot.  Other indexes report size
        consistency."""
        idx = self._container.index
        if hasattr(idx, 'check_integrity'):
            return idx.check_integrity()
        return {
            'n': int(idx.size),
            'table_rows': int(self._container.cell_table.size),
            'ok': int(idx.size) >= int(self._container.cell_table.size),
        }

    def filter(
        self,
        filter: Optional[Dict] = None,
        limit: int = 10,
        offset: int = 0,
        order_by: Optional[str] = None,
        ascending: bool = True,
        include_metadata: bool = True,
    ) -> List[Doc]:
        return self._container.filter_cells(
            filter=filter,
            limit=limit,
            offset=offset,
            order_by=order_by,
            ascending=ascending,
            include_metadata=include_metadata,
        )

    def get_docs(self, **kwargs) -> List[Doc]:
        return self.filter(**kwargs)

    def get_doc_by_id(self, doc_id: str) -> Optional[Doc]:
        return self._container.get_doc_by_id(doc_id)

    # ------------------------------------------------------------------
    # codec passthrough
    # ------------------------------------------------------------------

    def encode(self, x: np.ndarray) -> np.ndarray:
        if self._pq_codec is None:
            raise RuntimeError('PQ codec is not configured')
        x = self._sanity_check(x)
        xp = self._projector_codec.encode(x) if self._projector_codec else x
        return self._pq_codec.encode(xp)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if self._pq_codec is None:
            raise RuntimeError('PQ codec is not configured')
        xp = self._pq_codec.decode(codes)
        if self._projector_codec:
            return self._projector_codec.decode(xp)
        return xp

    # ------------------------------------------------------------------
    # persistence (same layout as the JAX package)
    # ------------------------------------------------------------------

    @property
    def params_hash(self) -> str:
        params = dict(
            n_dim=self.n_dim,
            metric=int(self.metric),
            n_cells=self.n_cells,
            n_subvectors=self.n_subvectors or 0,
            n_clusters=self.n_clusters,
            n_components=self.n_components or 0,
        )
        return hashlib.md5(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]

    @property
    def model_path(self) -> Path:
        return self.data_path / f'parameters-{self.params_hash}'

    @property
    def snapshot_root(self) -> Path:
        return self.data_path / f'snapshot-{self.params_hash}'

    def _load_codecs_if_exist(self):
        p = self.model_path
        try:
            if self._projector_codec and (p / 'projector.npz').exists():
                self._projector_codec = ProjectorCodec.load(p / 'projector.npz',
                                                            device=self.device)
            if self._vq_codec and (p / 'vq.npz').exists():
                self._vq_codec = VQCodec.load(p / 'vq.npz', device=self.device)
            if self._pq_codec and (p / 'pq.npz').exists():
                self._pq_codec = type(self._pq_codec).load(p / 'pq.npz', device=self.device)
        except Exception as e:  # corrupted model dir: retrain
            self.logger.warning(f'failed to load codecs from {p}: {e}')

    def dump_model(self):
        p = self.model_path
        p.mkdir(parents=True, exist_ok=True)
        if self._projector_codec:
            self._projector_codec.dump(p / 'projector.npz')
        if self._vq_codec:
            self._vq_codec.dump(p / 'vq.npz')
        if self._pq_codec:
            self._pq_codec.dump(p / 'pq.npz')

    def dump_index(self) -> Path:
        """Write a snapshot keyed off the data state; rolls back the partial
        dir on failure."""
        if self._container is None:
            raise RuntimeError('nothing to snapshot')
        # latest cell-table commit time + the doc store's monotone
        # transaction id: same state, same name
        latest = self._container.cell_table.get_latest_commit()
        txid = self._container.doc_store.last_transaction_id
        if latest is not None:
            ts = str(latest[-1]).replace(' ', '#').replace(':', '-')
            ts = f'{ts}.{txid:012d}'
        else:
            ts = time.strftime('%Y%m%d%H%M%S') + f'{time.time() % 1:.6f}'[1:]
        snap = self.snapshot_root / f'{ts}-SNAPSHOT'
        if snap.exists():
            # identical data state already snapshotted — refresh it in place
            shutil.rmtree(snap)
        try:
            snap.mkdir(parents=True, exist_ok=False)
            self._container.cell_table.dump(snap / 'cells.db')
            self._container.meta_table.dump(snap / 'metas.db')
            state = self._container.index.state_arrays()
            np.savez_compressed(snap / 'index_state.npz', **state)
            return snap
        except Exception:
            shutil.rmtree(snap, ignore_errors=True)
            raise

    def dump(self):
        self.dump_model()
        return self.dump_index()

    def _latest_snapshot(self) -> Optional[Path]:
        if not self.snapshot_root.exists():
            return None
        snaps = sorted(
            self.snapshot_root.glob('*-SNAPSHOT'),
            key=lambda p: p.stat().st_mtime,
        )
        return snaps[-1] if snaps else None

    def _maybe_restore(self):
        snap = self._latest_snapshot()
        if snap is not None:
            self._restore_from_snapshot(snap)
        elif self.total_docs > 0:
            self._rebuild_index_from_local()

    def _index_from_state(self, state: Dict[str, np.ndarray]):
        """The index of a snapshot's ``state_arrays()``, whichever package
        wrote it."""
        kind = str(np.asarray(state['kind']))
        if kind != self._kind():
            raise ValueError(
                f'snapshot holds a {kind!r} index, this AnnLite serves {self._kind()!r}')
        if kind == 'graph':
            return graph_index_from_jax_state(state, self._pq_codec,
                                              **self._index_kwargs())
        if kind == 'pq_scan':
            return pq_scan_index_from_jax_state(state, self._pq_codec,
                                                **self._index_kwargs())
        if kind == 'ivf_pq':
            return ivf_pq_index_from_jax_state(state, self._pq_codec,
                                               **self._index_kwargs())
        if kind == 'sharded_pq':
            return sharded_pq_index_from_jax_state(state, self._pq_codec,
                                                   **self._index_kwargs())
        if kind == 'sharded_ivf_pq':
            return sharded_ivf_pq_index_from_jax_state(state, self._pq_codec,
                                                       **self._index_kwargs())
        if kind == 'sharded_graph':
            return sharded_graph_index_from_jax_state(state, self._pq_codec,
                                                      **self._index_kwargs())
        if kind == 'sharded_flat':
            return sharded_flat_index_from_jax_state(state, **self._index_kwargs())
        return flat_index_from_jax_state(state, **self._index_kwargs())

    def _restore_from_snapshot(self, snap: Path):
        self.logger.info(f'restoring from snapshot {snap}')
        c = self._container
        c.cell_table.load(snap / 'cells.db')
        c.cell_table._invalidate()
        c.meta_table.load(snap / 'metas.db')
        with np.load(snap / 'index_state.npz', allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        c.index = None  # drop the old index's device buffers first
        c.index = self._index_from_state(state)
        self._rebuild_columns_from_table()

    def _reset_columns(self):
        c = self._container
        c._alive = np.zeros(0, dtype=bool)
        c._cells = np.zeros(0, dtype=np.int32)
        for name in c._col_names:
            c._columns_np[name] = c._empty_col(name)

    def _rebuild_columns_from_table(self):
        c = self._container
        cols = c.cell_table.columns_arrays()
        n = len(cols['_alive'])
        # hard reset (stale longer arrays would leave ghost alive rows)
        self._reset_columns()
        c._grow_columns(n)
        c._alive[:n] = cols['_alive']
        c._cells[:n] = cols['_cell']
        for name in c._col_names:
            c._columns_np[name][:n] = cols[name]

    def _rebuild_index_from_local(self):
        """Re-insert everything from the durable doc store."""
        self.logger.info('rebuilding index from doc store')
        for batch in self._container.documents_generator():
            x = docs_to_embeddings(batch)
            self._container.insert(x, self._cells(x), batch, only_index=True)

    def _stored_docs_exist(self) -> bool:
        return (self.data_path / 'docs' / 'docs.db').exists()

    def _auto_train_from_store(self):
        """Train the codecs from stored docs when opening an untrained index
        over existing data."""
        from .storage.kv import DocStorage

        store = DocStorage(self.data_path / 'docs')
        if store.size == 0:
            store.close()
            self._build_container()
            return
        xs, count = [], 0
        for batch in store.batched_iterator():
            xs.append(docs_to_embeddings(batch))
            count += len(batch)
            if count >= MAX_TRAINING_DATA_SIZE:
                break
        store.close()
        self.train(np.concatenate(xs)[:MAX_TRAINING_DATA_SIZE])
        self._maybe_restore()
        if self.index_size == 0 and self.total_docs > 0:
            self._rebuild_index_from_local()

    def compact(self):
        """Reclaim dead rows (deletes/updates leave bitmap holes): rebuild the
        index + metadata from the durable doc store."""
        self._check_writable()
        c = self._container
        c.index.reset()
        c.cell_table.execute(f'DELETE FROM {c.cell_table.name}')
        c.cell_table.execute(
            f"DELETE FROM sqlite_sequence WHERE name='{c.cell_table.name}'"
        )
        c.cell_table._invalidate()
        c.meta_table.execute(f'DELETE FROM {c.meta_table.name}')
        self._reset_columns()
        self._rebuild_index_from_local()

    def backup(
        self,
        target_name: Optional[str] = None,
        token: Optional[str] = None,
        remote: Optional[str] = None,
    ) -> Path:
        """Archive the codecs, a snapshot and the doc store into
        ``data_path/backups/<name>``, the JAX package's layout.  ``remote``:
        an artifact-store URL ('http(s)://...') or path; the archive is also
        uploaded there as zipped, split, typed artifacts
        (:class:`~annlite_torch.artifacts.Uploader`), so another host, or the
        other package, can :meth:`restore` it.  ``token`` is accepted for the
        reference's signature and unused."""
        self.dump_model()
        snap = self.dump_index()
        name = target_name or f'backup-{snap.name}'
        dest = self.data_path / 'backups' / name
        dest.mkdir(parents=True, exist_ok=True)
        shutil.copytree(self.model_path, dest / self.model_path.name, dirs_exist_ok=True)
        shutil.copytree(snap, dest / 'snapshot', dirs_exist_ok=True)
        self._container.doc_store.dump(dest / 'docs.db')
        if remote is not None:
            from .artifacts import Uploader, make_transport

            Uploader(make_transport(remote)).upload_directory(
                name, dest, skip_if_exists=False
            )
        return dest

    def restore(
        self,
        source_name: Optional[str] = None,
        token: Optional[str] = None,
        remote: Optional[str] = None,
    ):
        """Restore from a backup made by :meth:`backup` (by either package):
        local, or fetched from the ``remote`` artifact store when not present
        locally.  The index is rebuilt on this facade's device; searchers
        taken before refuse to run afterwards.  Without ``source_name``,
        reload the latest snapshot of ``data_path``."""
        if source_name is None:
            self._maybe_restore()
            return
        src = self.data_path / 'backups' / source_name
        if not src.exists() and remote is not None:
            from .artifacts import Merger, make_transport

            Merger(make_transport(remote)).restore_directory(source_name, src)
        if not src.exists():
            raise FileNotFoundError(f'backup {source_name} not found under {src}')
        model_dirs = list(src.glob('parameters-*'))
        if model_dirs:
            shutil.copytree(
                model_dirs[0], self.data_path / model_dirs[0].name, dirs_exist_ok=True
            )
            self._load_codecs_if_exist()
        if self._container is None:
            self._build_container()
        self._container.doc_store.load(src / 'docs.db')
        self._restore_from_snapshot_dir_or_rebuild(src / 'snapshot')

    def _restore_from_snapshot_dir_or_rebuild(self, snap: Path):
        if snap.exists():
            self._restore_from_snapshot(snap)
        else:
            self._rebuild_index_from_local()

    def clear(self):
        if self._container is not None:
            self._container.clear()

    def close(self):
        if self._container is not None:
            self._container.close()

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    @property
    def total_docs(self) -> int:
        return self._container.total_docs if self._container else 0

    @property
    def index_size(self) -> int:
        return self._container.index_size if self._container else 0

    @property
    def stat(self) -> Dict:
        return {
            'total_docs': self.total_docs,
            'index_size': self.index_size,
            'n_cells': self.n_cells,
            'n_dim': self.n_dim,
            'metric': self.metric.name,
            'is_trained': self.is_trained,
            'params_hash': self.params_hash,
            'data_path': str(self.data_path),
        }

    def __len__(self):
        return self.index_size
