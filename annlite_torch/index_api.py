"""AnnLite — the public facade; the port of `annlite_tpu/index_api.py`.

This slice of the port serves the flat index, which is what a default
``AnnLite`` runs (no PQ codec, one cell: ``index_type='auto'`` resolves to
flat).  The codecs and the other index types are not ported yet (ROADMAP
queue 1); asking for one raises ``NotImplementedError``.

Snapshots and ``params_hash`` match the JAX package's, so one ``data_path``
serves both packages: each opens the other's doc store, tables and index
snapshots.
"""
import hashlib
import json
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .container import CellContainer
from .convert import flat_index_from_jax_state
from .device import resolve_device
from .doc import Doc, docs_to_embeddings
from .enums import ExpandMode, Metric, parse_metric
from .helper import setup_logging
from .index.flat import FlatIndex


class AnnLite:
    def __init__(
        self,
        n_dim: int,
        metric: Union[str, Metric] = Metric.COSINE,
        n_cells: int = 1,
        n_subvectors: Optional[int] = None,
        n_clusters: int = 256,
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
        scan_mode: str = 'int8',
        index_type: str = 'auto',
        device: Optional[Union[str, torch.device]] = None,
    ):
        if n_subvectors or n_cells > 1 or n_components or index_type not in (
                'auto', 'flat'):
            raise NotImplementedError(
                'annlite_torch serves the flat index only so far: the codecs '
                '(n_subvectors, n_cells > 1, n_components) and the other index '
                'types are not ported yet (ROADMAP queue 1)')
        self.logger = setup_logging(verbose)
        self.n_dim = n_dim
        self.metric = parse_metric(metric)
        self.n_cells = n_cells
        self.n_subvectors = n_subvectors
        self.n_clusters = n_clusters
        self.n_components = n_components
        self.initial_size = initial_size
        self.expand_step_size = expand_step_size
        if expand_mode is None:
            expand_mode = ExpandMode.ADAPTIVE
        elif isinstance(expand_mode, str):
            expand_mode = ExpandMode.from_string(expand_mode)
        self.expand_mode = expand_mode
        self.read_only = read_only
        self.scan_mode = scan_mode
        self.index_type = index_type
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

        self._container = CellContainer(
            dim=self.n_dim,
            index=FlatIndex(self.n_dim, **self._index_kwargs()),
            metric=self.metric,
            columns=self._columns,
            data_path=self.data_path,
        )
        if self.index_size == 0 and (
            self._latest_snapshot() is not None or self.total_docs > 0
        ):
            self._maybe_restore()

    def _index_kwargs(self) -> dict:
        return dict(
            metric=self.metric, scan_mode=self.scan_mode, device=self.device,
            initial_size=self.initial_size,
            expand_step_size=self.expand_step_size,
            expand_mode=self.expand_mode,
        )

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def _sanity_check(self, x: np.ndarray):
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.n_dim:
            raise ValueError(
                f'inputs must be a 2D array of dimension {self.n_dim}, got '
                f'shape {x.shape}'
            )
        return x

    def _check_writable(self):
        if self.read_only:
            raise RuntimeError('the indexer is read-only, cannot modify it')

    @staticmethod
    def _cells(x: np.ndarray) -> np.ndarray:
        return np.zeros(x.shape[0], dtype=np.int64)

    def index(self, docs: List[Doc]):
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

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def search(
        self,
        docs: List[Doc],
        filter: Optional[Dict] = None,
        limit: int = 10,
        include_metadata: bool = True,
    ):
        """Attach ``matches`` (with scores) to each query doc."""
        x = docs_to_embeddings(docs)
        match_docs, _, _ = self._container.search_cells(
            x, filter=filter, limit=limit, include_metadata=include_metadata,
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
        query_np = self._sanity_check(query_np)
        match_docs, _, _ = self._container.search_cells(
            query_np, filter=filter, limit=limit,
            include_metadata=include_metadata,
        )
        return match_docs

    def search_numpy(
        self, query_np: np.ndarray, filter: Optional[Dict] = None, limit: int = 10
    ):
        """Returns (dists, doc_ids) ragged lists."""
        query_np = self._sanity_check(query_np)
        return self._container.search_numpy(query_np, filter=filter, limit=limit)

    def device_searcher(self, limit: int = 10, mask: Optional[np.ndarray] = None):
        """Device-resident searcher over the index: ``query [Q, D] float32 ->
        (dists [Q, limit], global_rows [Q, limit])`` as tensors on the
        device, with no host transfer of the corpus — the serving hot path.
        Returns GLOBAL ROWS (map them to doc ids with :meth:`rows_to_docids`).
        The flat index does not track deletes itself, so the container's
        alive bitmap is fused into the captured mask: deleted docs never
        surface.  Rebuild after writes."""
        alive = self._container._alive
        if mask is None:
            mask = alive
        else:
            u = np.asarray(mask[: len(alive)]).astype(bool)
            mask = u & alive[: len(u)]
        return self._container.index.device_searcher(limit=limit, mask=mask)

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

    def get_doc_by_id(self, doc_id: str) -> Optional[Doc]:
        return self._container.get_doc_by_id(doc_id)

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

    def dump_index(self) -> Path:
        """Write a snapshot keyed off the data state; rolls back the partial
        dir on failure."""
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
        # the flat index has no codecs: the model dir stays empty, as the
        # JAX package leaves it
        self.model_path.mkdir(parents=True, exist_ok=True)
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

    def _restore_from_snapshot(self, snap: Path):
        self.logger.info(f'restoring from snapshot {snap}')
        c = self._container
        c.cell_table.load(snap / 'cells.db')
        c.cell_table._invalidate()
        c.meta_table.load(snap / 'metas.db')
        with np.load(snap / 'index_state.npz', allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        c.index = flat_index_from_jax_state(state, **self._index_kwargs())
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

    def clear(self):
        self._container.clear()

    def close(self):
        self._container.close()

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    @property
    def total_docs(self) -> int:
        return self._container.total_docs

    @property
    def index_size(self) -> int:
        return self._container.index_size

    @property
    def stat(self) -> Dict:
        return {
            'total_docs': self.total_docs,
            'index_size': self.index_size,
            'n_cells': self.n_cells,
            'n_dim': self.n_dim,
            'metric': self.metric.name,
            'is_trained': True,
            'params_hash': self.params_hash,
            'data_path': str(self.data_path),
        }

    def __len__(self):
        return self.index_size
