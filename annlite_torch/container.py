"""CellContainer — orchestration of index + metadata + doc store.

Re-expression of reference `annlite/container.py` (insert `:262-308`, update
`:323-386`, delete `:388-414`, ivf_search/search_cells `:88-260`,
filter_cells `:146-199`, documents_generator, stats `:462-468`).

Deviations kept from `annlite_tpu/container.py`, whose copy this is (SURVEY.md §7):
- Device data is ONE packed global buffer; ``cell_id`` is a per-row column,
  not a per-cell array triple.  Global row == device-array row == CellTable
  ``_id - 1``.
- Filters compile to an exact per-row bitmask (numpy, cached columnar tags)
  fused into the scoring kernel — not SQL offset lists per cell.
- The dense scan scores ALL alive rows regardless of probed cells: on the
  accelerator the masked exhaustive scan is the fast path, and skipping cells would
  only lower recall without saving wall-clock.  (Cell probing returns as a
  real pruning mechanism in the block-gathered IVF kernel and the graph
  index.)
- Updates/deletes are delete-bitmap based: update marks the old row dead and
  appends a new row (the reference's address-aware delete+insert,
  `container.py:323-386`).
"""
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .doc import Doc
from .enums import Metric
from .filter import Filter
from .index.base import BaseIndex
from .ops import BIG
from .profile import span
from .storage.kv import DocStorage
from .storage.table import CellTable, MetaTable

_SCORE_MISSING = BIG / 2


class CellContainer:
    def __init__(
        self,
        dim: int,
        index: BaseIndex,
        metric: Metric = Metric.COSINE,
        columns: Optional[List[Tuple[str, type]]] = None,
        data_path: Union[str, Path] = './data',
        projector_codec=None,
        key: str = 'cells',
    ):
        self.dim = dim
        self.metric = metric
        self.index = index
        self.projector_codec = projector_codec
        self.data_path = Path(data_path)
        self.data_path.mkdir(parents=True, exist_ok=True)

        self.cell_table = CellTable(key, columns=columns)
        self.meta_table = MetaTable('metas')
        self.doc_store = DocStorage(self.data_path / 'docs')
        self._lock = threading.Lock()

        # incrementally-maintained columnar tag arrays (device bitmask path);
        # aligned with global rows, grown on insert
        self._col_names = [c for c, _ in (columns or [])]
        self._col_sql_types = dict(self.cell_table.existed_columns)
        self._empty_rows()

    def _empty_rows(self):
        self._alive = np.zeros(0, dtype=bool)
        self._cells = np.zeros(0, dtype=np.int32)
        self._columns_np: Dict[str, np.ndarray] = {
            c: self._empty_col(c) for c in self._col_names
        }

    def _empty_col(self, name: str, n: int = 0) -> np.ndarray:
        t = self._col_sql_types[name]
        if t == 'TEXT':
            return np.full(n, '', dtype=object)
        if t == 'FLOAT':
            return np.zeros(n, dtype=np.float64)
        return np.zeros(n, dtype=np.int64)

    def _grow_columns(self, n: int):
        cur = len(self._alive)
        if n <= cur:
            return
        self._alive = np.concatenate([self._alive, np.zeros(n - cur, dtype=bool)])
        self._cells = np.concatenate([self._cells, np.zeros(n - cur, dtype=np.int32)])
        for c in self._col_names:
            self._columns_np[c] = np.concatenate(
                [self._columns_np[c], self._empty_col(c, n - cur)]
            )

    def _write_tags(self, rows: np.ndarray, tag_rows: List[Dict]):
        for c in self._col_names:
            col = self._columns_np[c]
            default = '' if col.dtype == object else 0
            vals = [t.get(c) for t in tag_rows]
            col[rows] = [default if v is None else v for v in vals]

    def _project(self, x: np.ndarray) -> np.ndarray:
        if self.projector_codec is not None:
            return self.projector_codec.encode(x)
        return x

    # ----- writes -----

    def insert(
        self,
        data: np.ndarray,
        cells: np.ndarray,
        docs: List[Doc],
        only_index: bool = False,
    ) -> List[int]:
        """Append docs; returns their global rows
        (reference `container.py:262-308`)."""
        data = np.asarray(data, dtype=np.float32)
        cells = np.asarray(cells)
        # soft assignment ([n, a] cells): the container's own bookkeeping
        # (tables, _cells, addresses) uses the PRIMARY cell; the full
        # multi-cell assignment goes only to a wants_cells index, which
        # stores one code copy per cell and dedups at search
        cells_multi = cells if cells.ndim == 2 else None
        if cells_multi is not None:
            cells = np.ascontiguousarray(cells_multi[:, 0])
        else:
            cells = cells.reshape(-1)
        tag_rows = [d.tags for d in docs]
        doc_ids = [d.id for d in docs]
        with self._lock:
            with span('annlite.ingest.store'):
                rows = self.cell_table.insert(doc_ids, cells, tag_rows)
            with span('annlite.ingest.index'):
                if self.index.wants_cells:
                    self.index.add_with_ids(
                        self._project(data), np.asarray(rows),
                        cells=cells_multi if cells_multi is not None else cells,
                    )
                else:
                    self.index.add_with_ids(self._project(data), np.asarray(rows))
            with span('annlite.ingest.store'):
                self.meta_table.bulk_add_address(doc_ids, cells, rows)
            self._grow_columns(max(rows) + 1)
            r = np.asarray(rows)
            self._alive[r] = True
            self._cells[r] = cells
            self._write_tags(r, tag_rows)
        if not only_index:
            with span('annlite.ingest.store'):
                self.doc_store.insert(docs)
        return rows

    def update(
        self,
        data: np.ndarray,
        cells: np.ndarray,
        docs: List[Doc],
        insert_if_not_found: bool = True,
        raise_errors_on_not_found: bool = False,
    ):
        """Address-aware update: dead-mark the old row, append the new one
        (reference `container.py:323-386`)."""
        data = np.asarray(data, dtype=np.float32)
        cells = np.asarray(cells)
        cells_src = cells if cells.ndim == 2 else cells.reshape(-1)
        cells = cells_src[:, 0] if cells_src.ndim == 2 else cells_src
        # duplicate ids within one batch: last occurrence wins (equivalent to
        # sequential updates; two alive rows with one id would violate the
        # partial unique index)
        last_by_id = {d.id: i for i, d in enumerate(docs)}
        if len(last_by_id) != len(docs):
            keep = sorted(last_by_id.values())
            docs = [docs[i] for i in keep]
            data = data[np.asarray(keep)]
            cells = cells[np.asarray(keep)]
            cells_src = cells_src[np.asarray(keep)]
        # classify first (one lookup per doc), then dead-mark existing rows
        # in ONE batch and append everything in ONE insert — keeps sqlite
        # transaction count O(1) per update() call instead of O(n)
        to_replace, to_insert_idx = [], []
        for i, doc in enumerate(docs):
            old_row = self.cell_table.get_row_by_docid(doc.id)
            if old_row is None:
                if insert_if_not_found:
                    to_insert_idx.append(i)
                elif raise_errors_on_not_found:
                    raise ValueError(f'doc {doc.id} not found in the index')
                continue
            to_replace.append((i, old_row))
        # in-place fast path (reference `updatePoint` semantics,
        # hnswalg.h:958-1096): when the index can rewrite existing rows and
        # the doc stays in its cell, keep the row — no dead-row growth, no
        # compaction debt on write-heavy workloads.  A cell move still goes
        # through dead-mark + append (reference `container.py:323-386`).
        if to_replace and self.index.supports_inplace_update:
            movable = []
            inplace = []
            for i, old_row in to_replace:
                if int(cells[i]) == int(self._cells[old_row]):
                    inplace.append((i, old_row))
                else:
                    movable.append((i, old_row))
            to_replace = movable
            if inplace:
                sel = np.asarray([i for i, _ in inplace])
                rows = np.asarray([r for _, r in inplace])
                sel_docs = [docs[i] for i in sel]
                tag_rows = [d.tags for d in sel_docs]
                with self._lock:
                    self.cell_table.update_columns(
                        [d.id for d in sel_docs], tag_rows
                    )
                    self.index.update_with_ids(
                        self._project(data[sel]), rows
                    )
                    self.meta_table.bulk_add_address(
                        [d.id for d in sel_docs], cells[sel], rows
                    )
                    self._alive[rows] = True
                    self._write_tags(rows, tag_rows)
                self.doc_store.update(sel_docs)
        if to_replace:
            with self._lock:
                old_rows = [r for _, r in to_replace]
                self.cell_table.delete([docs[i].id for i, _ in to_replace])
                self._alive[np.asarray(old_rows)] = False
                if hasattr(self.index, 'delete_rows'):
                    self.index.delete_rows(old_rows)
            sel = np.asarray([i for i, _ in to_replace])
            self.insert(data[sel], cells_src[sel], [docs[i] for i, _ in to_replace])
        if to_insert_idx:
            sel = np.asarray(to_insert_idx)
            self.insert(data[sel], cells_src[sel], [docs[i] for i in to_insert_idx])

    def delete(self, doc_ids: List[str], raise_errors_on_not_found: bool = False):
        for doc_id in doc_ids:
            with self._lock:
                rows = self.cell_table.delete([doc_id])
                if not rows:
                    if raise_errors_on_not_found:
                        raise ValueError(f'doc {doc_id} not found in the index')
                    continue
                self._alive[np.asarray(rows)] = False
                if hasattr(self.index, 'delete_rows'):
                    self.index.delete_rows(rows)
                self.meta_table.delete_address(doc_id)
            self.doc_store.delete([doc_id])

    # ----- search -----

    def row_mask(self, mask: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """The alive bitmap ANDed with ``mask`` (a row predicate, cut to
        the rows there are), or None when every row passes and the index
        answers no mask as it answers an all-pass one."""
        alive = self._alive
        if mask is None:
            if alive.all() and not self.index.widens_for_mask:
                return None
            return alive.copy()
        m = np.asarray(mask[: len(alive)]).astype(bool, copy=False)
        return m & alive[: len(m)]

    @property
    def dead_fraction(self) -> float:
        """The index's share of dead rows where it keeps one, else the
        alive bitmap's."""
        dead = self.index.dead_fraction
        if dead is None:
            alive = self._alive
            dead = float((~alive).sum()) / len(alive) if len(alive) else 0.0
        return dead

    def _build_mask(self, filter: Optional[Dict]) -> Optional[np.ndarray]:
        if len(self._alive) == 0:
            return None
        if not filter:
            return self.row_mask()
        cols = dict(self._columns_np)
        cols['_cell'] = self._cells
        return self.row_mask(Filter(filter)(cols))

    def search_cells(
        self,
        query: np.ndarray,
        cells: Optional[np.ndarray] = None,
        filter: Optional[Dict] = None,
        limit: int = 10,
        include_metadata: bool = False,
    ) -> Tuple[List[List[Doc]], np.ndarray, List[List[str]]]:
        """Batched search; returns (match_docs, dists, doc_ids)
        (reference `container.py:201-260`)."""
        dists, doc_ids = self.search_numpy(
            query, filter=filter, limit=limit, cells=cells
        )
        results = []
        for q_ids, q_dists in zip(doc_ids, dists):
            matches = []
            for doc_id, dist in zip(q_ids, q_dists):
                if include_metadata:
                    with span('annlite.storage.docs'):
                        got = self.doc_store.get(doc_id)
                    m = got[0] if got else Doc(id=doc_id)
                else:
                    m = Doc(id=doc_id)
                m.score = float(dist)
                matches.append(m)
            results.append(matches)
        return results, dists, doc_ids

    def search_numpy(
        self,
        query: np.ndarray,
        filter: Optional[Dict] = None,
        limit: int = 10,
        cells: Optional[np.ndarray] = None,
    ) -> Tuple[List[np.ndarray], List[List[str]]]:
        """Returns ragged (dists per query, doc_ids per query); entries with
        fewer than ``limit`` candidates return short lists (reference
        behaviour at `container.py:130-144`).  ``cells``: probed IVF cells
        (used by cell-aware indexes, ignored otherwise)."""
        query = np.asarray(query, dtype=np.float32)
        with span('annlite.filter'):
            mask = self._build_mask(filter)
        q = self._project(query)
        with span('annlite.index'):
            if cells is not None and self.index.wants_cells:
                d, idx = self.index.search(q, limit=limit, mask=mask, cells=cells)
            else:
                d, idx = self.index.search(q, limit=limit, mask=mask)
        # one batched row->doc-id lookup for ALL queries' candidates (a
        # per-row SELECT loop here dominated facade serving latency)
        valid = d < _SCORE_MISSING
        rows = idx[valid]
        with span('annlite.storage.idmap'):
            flat_ids = self.cell_table.get_docids_by_rows(rows)
        all_dists, all_ids, at = [], [], 0
        for qi in range(d.shape[0]):
            n = int(valid[qi].sum())
            ids = flat_ids[at : at + n]
            at += n
            keep = [j for j, s in enumerate(ids) if s is not None]
            all_dists.append(d[qi][valid[qi]][keep])
            all_ids.append([ids[j] for j in keep])
        return all_dists, all_ids

    # ----- filter endpoint (no vector search) -----

    def filter_cells(
        self,
        filter: Optional[Dict] = None,
        limit: int = -1,
        offset: int = 0,
        order_by: Optional[str] = None,
        ascending: bool = True,
        include_metadata: bool = True,
    ) -> List[Doc]:
        """SQL-backed filtering with pagination/ordering
        (reference `container.py:146-199`)."""
        where, params = Filter(filter or {}).parse_where_clause()
        rows = self.cell_table.query(
            where_clause=where,
            where_params=params,
            limit=limit,
            offset=offset,
            order_by=order_by,
            ascending=ascending,
        )
        ids = [i for i in self.cell_table.get_docids_by_rows(rows) if i is not None]
        if not include_metadata:
            return [Doc(id=i) for i in ids]
        return self.doc_store.get(ids)

    # ----- accessors -----

    def get_doc_by_id(self, doc_id: str) -> Optional[Doc]:
        got = self.doc_store.get(doc_id)
        return got[0] if got else None

    def documents_generator(self, batch_size: int = 1024):
        yield from self.doc_store.batched_iterator(batch_size)

    @property
    def vec_index(self):
        """Reference-parity accessor (`annlite/container.py:22-468` exposes
        `vec_index`); same object as ``self.index``."""
        return self.index

    @property
    def total_docs(self) -> int:
        return self.doc_store.size

    @property
    def index_size(self) -> int:
        return self.cell_table.size

    def reset_rows(self):
        """Empty the index, the tables and the row cache; the doc store
        stays."""
        with self._lock:
            self.index.reset()
            self.cell_table.execute(f'DELETE FROM {self.cell_table.name}')
            self.cell_table.execute(
                f"DELETE FROM sqlite_sequence WHERE name='{self.cell_table.name}'"
            )
            self.meta_table.execute(f'DELETE FROM {self.meta_table.name}')
            self._empty_rows()

    def clear(self):
        self.reset_rows()
        self.doc_store.clear()

    # ----- snapshots (the JAX package's layout) -----

    def dump_snapshot(self, snap: Path):
        """Write the tables and the index's state arrays into ``snap``."""
        self.cell_table.dump(snap / 'cells.db')
        self.meta_table.dump(snap / 'metas.db')
        np.savez_compressed(snap / 'index_state.npz', **self.index.state_arrays())

    def load_snapshot(self, snap: Path,
                      index_from_state: Callable[[Dict[str, np.ndarray]], BaseIndex]):
        """Read a snapshot that either package wrote: the tables, then the
        index ``index_from_state`` builds from its state arrays, then the row
        cache (alive bitmap, cells, tag columns) from the cell table."""
        with np.load(snap / 'index_state.npz', allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        with self._lock:
            self.cell_table.load(snap / 'cells.db')
            self.meta_table.load(snap / 'metas.db')
            self.index = None  # drop the old index's device buffers first
            self.index = index_from_state(state)
            cols = self.cell_table.columns_arrays()
            self._alive = cols['_alive']
            self._cells = cols['_cell']
            self._columns_np = {c: cols[c] for c in self._col_names}

    def close(self):
        self.doc_store.close()
        self.cell_table.close()
        self.meta_table.close()
