"""Host-side SQLite metadata tables.

Re-expression of reference `annlite/storage/table.py` for the TPU build.
Key deviation (deliberate, TPU-first): the reference keeps one SQLite
CellTable *per IVF cell* plus a global MetaTable mapping
``doc_id → (cell_id, offset)`` (`storage/table.py:160-462`).  Here device
data lives in ONE packed global buffer (SURVEY.md §7), so the metadata is
ONE ``CellTable`` with a ``_cell`` column; the global row number *is* the
device-array row.  ``MetaTable`` keeps the reference's address-book API
(`get_address/bulk_add_address/get_latest_commit`,
`storage/table.py:379-462`) on top of the same database.

Columnar tag arrays for the device bitmask path are materialized from
SQLite on demand and cached until the table changes.
"""
import datetime
import sqlite3
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

TYPE_MAP = {
    int: 'INTEGER',
    float: 'FLOAT',
    str: 'TEXT',
    bool: 'INTEGER',
    np.int8: 'INTEGER',
    np.int16: 'INTEGER',
    np.int32: 'INTEGER',
    np.int64: 'INTEGER',
    np.uint8: 'INTEGER',
    np.uint32: 'INTEGER',
    np.uint64: 'INTEGER',
    np.float16: 'FLOAT',
    np.float32: 'FLOAT',
    np.float64: 'FLOAT',
}

_NP_BY_SQL = {'INTEGER': np.int64, 'FLOAT': np.float64, 'TEXT': object}


def _sql_type(py_type) -> str:
    if isinstance(py_type, str):
        name = py_type.lower()
        if name in ('int', 'integer', 'bool'):
            return 'INTEGER'
        if name in ('float', 'double'):
            return 'FLOAT'
        if name in ('str', 'text', 'string'):
            return 'TEXT'
        raise ValueError(f'unknown column type {py_type!r}')
    if py_type in TYPE_MAP:
        return TYPE_MAP[py_type]
    try:
        dt = np.dtype(py_type)
        if np.issubdtype(dt, np.integer) or np.issubdtype(dt, np.bool_):
            return 'INTEGER'
        if np.issubdtype(dt, np.floating):
            return 'FLOAT'
    except TypeError:
        pass
    raise ValueError(f'unknown column type {py_type!r}')


class Table:
    """SQLite connection + load/dump via the online backup API
    (reference `storage/table.py:84-157`)."""

    def __init__(self, name: str, data_path: Optional[Union[str, Path]] = None, in_memory: bool = True):
        self.name = name
        self._lock = threading.Lock()
        if in_memory or data_path is None:
            self._db_path = ':memory:'
        else:
            Path(data_path).mkdir(parents=True, exist_ok=True)
            self._db_path = str(Path(data_path) / f'{name}.db')
        self._conn = sqlite3.connect(self._db_path, check_same_thread=False)
        self._conn.execute('PRAGMA journal_mode=WAL') if self._db_path != ':memory:' else None

    def execute(self, sql: str, params=()):
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur

    def executemany(self, sql: str, rows):
        with self._lock:
            cur = self._conn.executemany(sql, rows)
            self._conn.commit()
            return cur

    def query_all(self, sql: str, params=()):
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def dump(self, target: Union[str, Path]):
        Path(target).parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            dst = sqlite3.connect(str(target))
            with dst:
                self._conn.backup(dst)
            dst.close()

    def load(self, source: Union[str, Path]):
        with self._lock:
            src = sqlite3.connect(str(source))
            with self._conn:
                src.backup(self._conn)
            src.close()

    def close(self):
        with self._lock:
            self._conn.close()


class CellTable(Table):
    """Global metadata/filter table.

    Schema: ``(_id INTEGER PK AUTOINCREMENT, _doc_id TEXT UNIQUE, _cell
    INTEGER, _alive INTEGER, _time_at TIMESTAMP, <user cols>)`` with indexes
    on ``_cell`` and each user column (reference per-cell schema at
    `storage/table.py:160-211`).  ``_id - 1`` is the 0-based global row,
    which is also the row in the packed device arrays.
    """

    def __init__(
        self,
        name: str = 'cells',
        columns: Optional[List[Tuple[str, type]]] = None,
        data_path: Optional[Union[str, Path]] = None,
        in_memory: bool = True,
    ):
        super().__init__(name, data_path, in_memory)
        self._columns: List[Tuple[str, str]] = []
        for col, t in columns or []:
            if col.startswith('_'):
                raise ValueError(f'column name {col!r} is reserved')
            self._columns.append((col, _sql_type(t)))
        cols_sql = ''.join(f', {c} {t}' for c, t in self._columns)
        self.execute(
            f'CREATE TABLE IF NOT EXISTS {self.name} '
            f'(_id INTEGER PRIMARY KEY AUTOINCREMENT, _doc_id TEXT, '
            f'_cell INTEGER NOT NULL DEFAULT 0, _alive INTEGER NOT NULL DEFAULT 1, '
            f'_time_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP{cols_sql})'
        )
        # uniqueness only among ALIVE rows: soft-deleted rows keep their id
        # so that update (= dead-mark + append) can reuse it
        self.execute(
            f'CREATE UNIQUE INDEX IF NOT EXISTS idx_{self.name}__doc_id '
            f'ON {self.name} (_doc_id) WHERE _alive = 1'
        )
        self.execute(
            f'CREATE INDEX IF NOT EXISTS idx_{self.name}__cell ON {self.name} (_cell)'
        )
        for c, _ in self._columns:
            self.execute(
                f'CREATE INDEX IF NOT EXISTS idx_{self.name}_{c} ON {self.name} ({c})'
            )
        self._columns_cache: Optional[Dict[str, np.ndarray]] = None
        # row→doc-id cache for the serving hot path; append-only under
        # insert, UNCHANGED by soft delete/undelete (they only flip _alive),
        # dropped by any raw execute()/load() (compact, restore, ...)
        self._docids_cache: Optional[np.ndarray] = None

    def execute(self, sql: str, params=()):
        try:
            return super().execute(sql, params)
        finally:
            # AFTER the SQL runs: dropping first would let a concurrent
            # docids_array() rebuild from the pre-mutation table and
            # resurrect a stale cache
            self._docids_cache = None

    def executemany(self, sql: str, rows):
        try:
            return super().executemany(sql, rows)
        finally:
            # same invalidation as execute(): a raw executemany mutation
            # must not leave a stale row→doc-id cache serving wrong ids
            self._docids_cache = None

    def load(self, source):
        self._docids_cache = None
        self._invalidate()
        return super().load(source)

    @property
    def columns(self) -> List[str]:
        return [c for c, _ in self._columns]

    @property
    def existed_columns(self) -> List[Tuple[str, str]]:
        return list(self._columns)

    def _invalidate(self):
        self._columns_cache = None

    # ----- writes -----

    def insert(self, doc_ids: List[str], cells, tag_rows: List[Dict]) -> List[int]:
        """Insert docs; returns their 0-based global rows.

        Raises sqlite3.IntegrityError on duplicate doc ids (same contract as
        reference `storage/table.py:213-257`).
        """
        cols = [c for c, _ in self._columns]
        col_sql = ''.join(f', {c}' for c in cols)
        holes = ', '.join('?' for _ in range(2 + len(cols)))
        now = datetime.datetime.now(datetime.timezone.utc).isoformat()
        rows = []
        for doc_id, cell, tags in zip(doc_ids, np.asarray(cells).tolist(), tag_rows):
            vals = [doc_id, int(cell)] + [_py(tags.get(c)) for c in cols]
            rows.append(vals)
        with self._lock:
            cur = self._conn.execute(f'SELECT COALESCE(MAX(_id), 0) FROM {self.name}')
            start = cur.fetchone()[0]
            try:
                self._conn.executemany(
                    f'INSERT INTO {self.name} (_doc_id, _cell{col_sql}, _time_at) '
                    f'VALUES ({holes}, ?)',
                    [r + [now] for r in rows],
                )
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise
            if self._docids_cache is not None:
                if len(self._docids_cache) == start:
                    new = np.empty(len(rows), dtype=object)
                    new[:] = doc_ids
                    self._docids_cache = np.concatenate(
                        [self._docids_cache, new]
                    )
                else:  # misaligned (shouldn't happen) — rebuild lazily
                    self._docids_cache = None
        self._invalidate()
        return list(range(start, start + len(rows)))

    def update_columns(self, doc_ids: List[str], tag_rows: List[Dict]):
        """In-place update of user columns (+ ``_time_at``) of ALIVE rows.
        The row→doc-id mapping is unchanged, so this deliberately does NOT
        drop the docid cache (uses the connection directly rather than the
        cache-invalidating executemany)."""
        cols = [c for c, _ in self._columns]
        now = datetime.datetime.now(datetime.timezone.utc).isoformat()
        sets = ''.join(f', {c} = ?' for c in cols)
        sql = (f'UPDATE {self.name} SET _time_at = ?{sets} '
               f'WHERE _doc_id = ? AND _alive = 1')
        with self._lock:
            self._conn.executemany(sql, [
                [now] + [_py(t.get(c)) for c in cols] + [d]
                for d, t in zip(doc_ids, tag_rows)
            ])
            self._conn.commit()
        self._invalidate()

    def delete(self, doc_ids: List[str]) -> List[int]:
        """Soft-delete by doc id; returns the affected global rows."""
        rows = []
        with self._lock:
            for doc_id in doc_ids:
                cur = self._conn.execute(
                    f'SELECT _id FROM {self.name} WHERE _doc_id = ? AND _alive = 1',
                    (doc_id,),
                )
                r = cur.fetchone()
                if r is not None:
                    rows.append(r[0] - 1)
                    self._conn.execute(
                        f'UPDATE {self.name} SET _alive = 0 WHERE _id = ?', (r[0],)
                    )
            self._conn.commit()
        self._invalidate()
        return rows

    def undelete(self, doc_ids: List[str]) -> List[int]:
        """Restore soft-deleted docs (inverse of ``delete``): flips
        ``_alive`` back on for each id's MOST RECENT dead row, unless a live
        row with that id already exists (the partial-unique index guards
        one-alive-per-id).  Returns the restored 0-based global rows."""
        rows = []
        with self._lock:
            for doc_id in doc_ids:
                live = self._conn.execute(
                    f'SELECT 1 FROM {self.name} '
                    f'WHERE _doc_id = ? AND _alive = 1', (doc_id,)
                ).fetchone()
                if live is not None:
                    continue
                r = self._conn.execute(
                    f'SELECT _id FROM {self.name} '
                    f'WHERE _doc_id = ? AND _alive = 0 '
                    f'ORDER BY _id DESC LIMIT 1', (doc_id,)
                ).fetchone()
                if r is None:
                    continue
                self._conn.execute(
                    f'UPDATE {self.name} SET _alive = 1 WHERE _id = ?',
                    (r[0],),
                )
                rows.append(r[0] - 1)
            self._conn.commit()
        self._invalidate()
        return rows

    # ----- reads -----

    def query(
        self,
        where_clause: str = '',
        where_params=(),
        cells: Optional[List[int]] = None,
        limit: int = -1,
        offset: int = 0,
        order_by: Optional[str] = None,
        ascending: bool = True,
    ) -> List[int]:
        """Return 0-based global rows of alive docs matching the filter
        (reference `storage/table.py:259-318`)."""
        sql = f'SELECT _id FROM {self.name} WHERE _alive = 1'
        params = list(where_params)
        if where_clause:
            sql += f' AND ({where_clause})'
        if cells is not None:
            sql += f' AND _cell IN ({", ".join("?" for _ in cells)})'
            params.extend(int(c) for c in cells)
        if order_by is not None:
            sql += f' ORDER BY {order_by} {"ASC" if ascending else "DESC"}'
        if limit >= 0:
            sql += f' LIMIT {int(limit)} OFFSET {int(offset)}'
        elif offset > 0:
            sql += f' LIMIT -1 OFFSET {int(offset)}'
        return [r[0] - 1 for r in self.query_all(sql, params)]

    def get_docid_by_row(self, row: int) -> Optional[str]:
        r = self.query_all(
            f'SELECT _doc_id FROM {self.name} WHERE _id = ?', (row + 1,)
        )
        return r[0][0] if r else None

    def docids_array(self) -> np.ndarray:
        """Materialized row→doc-id object array (serving hot path: indexing
        it is ~µs vs ~1.2 ms for the chunked SELECT at batch-64×top-10).
        Build cost one full scan, then kept valid incrementally: inserts
        append, soft delete/undelete don't change the mapping, raw
        ``execute``/``load`` drop it."""
        with self._lock:  # non-reentrant: use _conn directly in here
            arr = self._docids_cache
            if arr is None:
                n = self._conn.execute(
                    f'SELECT COALESCE(MAX(_id), 0) FROM {self.name}'
                ).fetchone()[0]
                arr = np.full(n, None, dtype=object)
                for _id, did in self._conn.execute(
                    f'SELECT _id, _doc_id FROM {self.name}'
                ):
                    arr[_id - 1] = did
                self._docids_cache = arr
            # return the LOCAL reference: a concurrent execute()'s finally
            # clears the attribute outside the lock, so re-reading
            # self._docids_cache here could return None to the caller
            return arr

    def get_docids_by_rows(self, rows: List[int]) -> List[Optional[str]]:
        """Row→doc-id for a batch — a cached-array lookup when the cache is
        materialized (see ``docids_array``), else ONE ``SELECT ... WHERE _id
        IN (...)`` per ≤900-key chunk (SQLite bound-variable ceiling). The
        serving hot path maps every candidate of every query through here
        (reference per-row loop: `annlite/container.py:213-260`)."""
        out: List[Optional[str]] = [None] * len(rows)
        if not rows:
            return out
        cache = self._docids_cache
        if cache is not None:
            n = len(cache)
            return [cache[r] if 0 <= r < n else None
                    for r in np.asarray(rows, dtype=np.int64)]
        pos: dict = {}
        for j, row in enumerate(rows):
            pos.setdefault(int(row) + 1, []).append(j)
        keys = list(pos)
        with self._lock:
            for lo in range(0, len(keys), 900):
                chunk = keys[lo : lo + 900]
                sql = (
                    f'SELECT _id, _doc_id FROM {self.name} '
                    f'WHERE _id IN ({", ".join("?" for _ in chunk)})'
                )
                for _id, doc_id in self._conn.execute(sql, chunk):
                    for j in pos[_id]:
                        out[j] = doc_id
        return out

    def get_row_by_docid(self, doc_id: str) -> Optional[int]:
        r = self.query_all(
            f'SELECT _id FROM {self.name} WHERE _doc_id = ? AND _alive = 1',
            (doc_id,),
        )
        return r[0][0] - 1 if r else None

    def exist(self, doc_id: str) -> bool:
        return self.get_row_by_docid(doc_id) is not None

    def count(self, where_clause: str = '', where_params=()) -> int:
        sql = f'SELECT COUNT(*) FROM {self.name} WHERE _alive = 1'
        if where_clause:
            sql += f' AND ({where_clause})'
        return self.query_all(sql, list(where_params))[0][0]

    @property
    def size(self) -> int:
        return self.count()

    @property
    def n_rows(self) -> int:
        """Total rows ever allocated (= device buffer length), incl. dead."""
        return self.query_all(f'SELECT COALESCE(MAX(_id), 0) FROM {self.name}')[0][0]

    def cell_counts(self) -> Dict[int, int]:
        return dict(
            self.query_all(
                f'SELECT _cell, COUNT(*) FROM {self.name} WHERE _alive = 1 GROUP BY _cell'
            )
        )

    # ----- columnar view for the device bitmask path -----

    def columns_arrays(self) -> Dict[str, np.ndarray]:
        """Materialize ``{col: np.ndarray[n_rows]}`` (+ ``_cell``/``_alive``)
        aligned with global rows; dead/never-written rows hold defaults."""
        if self._columns_cache is not None:
            return self._columns_cache
        n = self.n_rows
        cols = {c: np.zeros(n, dtype=_NP_BY_SQL[t]) for c, t in self._columns}
        for c, t in self._columns:
            if _NP_BY_SQL[t] is object:
                cols[c] = np.full(n, '', dtype=object)
        cols['_cell'] = np.zeros(n, dtype=np.int32)
        cols['_alive'] = np.zeros(n, dtype=bool)
        names = [c for c, _ in self._columns]
        sel = ', '.join(['_id', '_cell', '_alive'] + names)
        for rec in self.query_all(f'SELECT {sel} FROM {self.name}'):
            i = rec[0] - 1
            cols['_cell'][i] = rec[1]
            cols['_alive'][i] = bool(rec[2])
            for j, c in enumerate(names):
                v = rec[3 + j]
                if v is not None:
                    cols[c][i] = v
        self._columns_cache = cols
        return cols

    def get_latest_commit(self):
        r = self.query_all(
            f'SELECT _doc_id, _cell, _id, _time_at FROM {self.name} '
            f'ORDER BY _time_at DESC, _id DESC LIMIT 1'
        )
        return r[0] if r else None


def _py(v):
    """Coerce numpy scalars to python for sqlite."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, bool):
        return int(v)
    return v


class MetaTable(Table):
    """doc_id → (cell_id, row) address book + commit times (reference
    `storage/table.py:379-462`).  In this build the address is
    ``(cell_id, global_row)``."""

    def __init__(self, name: str = 'metas', data_path=None, in_memory: bool = True):
        super().__init__(name, data_path, in_memory)
        self.execute(
            f'CREATE TABLE IF NOT EXISTS {self.name} '
            f'(_doc_id TEXT PRIMARY KEY, cell_id INTEGER NOT NULL, '
            f'offset INTEGER NOT NULL, time_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP)'
        )
        self.execute(
            f'CREATE INDEX IF NOT EXISTS idx_{self.name}_time ON {self.name} (time_at)'
        )

    def get_address(self, doc_id: str) -> Optional[Tuple[int, int]]:
        r = self.query_all(
            f'SELECT cell_id, offset FROM {self.name} WHERE _doc_id = ?', (doc_id,)
        )
        return (r[0][0], r[0][1]) if r else None

    def add_address(self, doc_id: str, cell_id: int, offset: int, commit: bool = True):
        now = datetime.datetime.now(datetime.timezone.utc).isoformat()
        self.execute(
            f'INSERT OR REPLACE INTO {self.name} (_doc_id, cell_id, offset, time_at) '
            f'VALUES (?, ?, ?, ?)',
            (doc_id, int(cell_id), int(offset), now),
        )

    def bulk_add_address(self, doc_ids, cell_ids, offsets):
        now = datetime.datetime.now(datetime.timezone.utc).isoformat()
        self.executemany(
            f'INSERT OR REPLACE INTO {self.name} (_doc_id, cell_id, offset, time_at) '
            f'VALUES (?, ?, ?, ?)',
            [
                (d, int(c), int(o), now)
                for d, c, o in zip(doc_ids, np.asarray(cell_ids).tolist(), np.asarray(offsets).tolist())
            ],
        )

    def delete_address(self, doc_id: str):
        self.execute(f'DELETE FROM {self.name} WHERE _doc_id = ?', (doc_id,))

    def iter_addresses(self, time_since: Optional[str] = None):
        sql = f'SELECT _doc_id, cell_id, offset FROM {self.name}'
        params = ()
        if time_since is not None:
            sql += ' WHERE time_at >= ?'
            params = (time_since,)
        sql += ' ORDER BY _doc_id'
        for r in self.query_all(sql, params):
            yield r[0], r[1], r[2]

    def get_latest_commit(self):
        r = self.query_all(
            f'SELECT _doc_id, cell_id, offset, time_at FROM {self.name} '
            f'ORDER BY time_at DESC LIMIT 1'
        )
        return r[0] if r else None
