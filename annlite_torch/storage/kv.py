"""Durable document store (source of truth).

Replaces the reference's RocksDB `DocStorage` (`annlite/storage/kv.py:27-155`:
Rdict raw mode, sync WriteBatch, batched_iterator, destroy-on-clear) with a
SQLite-WAL key/value store — same contract: insert/update/delete/get/clear/
batched iteration/stat/last_transaction_id, synchronous batch commits.

SQLite is the right host-side native engine here (single C library, WAL
journaling, atomic batch transactions); the device never touches this path.
"""
import sqlite3
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Union

from ..doc import Doc


class DocStorage:
    def __init__(self, data_path: Union[str, Path], serialize_config: Optional[dict] = None, lock: bool = True):
        self._data_path = Path(data_path)
        self._data_path.mkdir(parents=True, exist_ok=True)
        self._db_file = self._data_path / 'docs.db'
        self._lock = threading.Lock()
        self._open()

    def _open(self):
        self._conn = sqlite3.connect(str(self._db_file), check_same_thread=False)
        self._conn.execute('PRAGMA journal_mode=WAL')
        self._conn.execute('PRAGMA synchronous=NORMAL')
        self._conn.execute(
            'CREATE TABLE IF NOT EXISTS kv (key TEXT PRIMARY KEY, value BLOB)'
        )
        self._conn.execute(
            'CREATE TABLE IF NOT EXISTS seq (id INTEGER PRIMARY KEY CHECK (id = 0), txid INTEGER)'
        )
        self._conn.execute('INSERT OR IGNORE INTO seq VALUES (0, 0)')
        self._conn.commit()

    def _bump(self, n: int):
        self._conn.execute('UPDATE seq SET txid = txid + ?', (n,))

    # ----- writes (batch = one transaction, mirrors sync WriteBatch) -----

    def insert(self, docs: List[Doc]):
        with self._lock, self._conn:
            self._conn.executemany(
                'INSERT OR REPLACE INTO kv (key, value) VALUES (?, ?)',
                [(d.id, d.to_bytes()) for d in docs],
            )
            self._bump(len(docs))

    def update(self, docs: List[Doc]):
        self.insert(docs)

    def delete(self, doc_ids: List[str]):
        with self._lock, self._conn:
            self._conn.executemany(
                'DELETE FROM kv WHERE key = ?', [(i,) for i in doc_ids]
            )
            self._bump(len(doc_ids))

    # ----- reads -----

    def get(self, doc_ids: Union[str, List[str]]) -> List[Doc]:
        if isinstance(doc_ids, str):
            doc_ids = [doc_ids]
        out = []
        with self._lock:
            for i in doc_ids:
                r = self._conn.execute(
                    'SELECT value FROM kv WHERE key = ?', (i,)
                ).fetchone()
                if r is not None:
                    out.append(Doc.from_bytes(r[0]))
        return out

    def __contains__(self, doc_id: str) -> bool:
        with self._lock:
            return (
                self._conn.execute(
                    'SELECT 1 FROM kv WHERE key = ?', (doc_id,)
                ).fetchone()
                is not None
            )

    def batched_iterator(self, batch_size: int = 1024) -> Iterator[List[Doc]]:
        """Stream all docs in key order (reference `kv.py:138-155`)."""
        last = ''
        while True:
            with self._lock:
                rows = self._conn.execute(
                    'SELECT key, value FROM kv WHERE key > ? ORDER BY key LIMIT ?',
                    (last, batch_size),
                ).fetchall()
            if not rows:
                return
            last = rows[-1][0]
            yield [Doc.from_bytes(v) for _, v in rows]

    # ----- maintenance -----

    def clear(self):
        """Drop everything (reference destroys + reinits, `kv.py:96-106`)."""
        with self._lock, self._conn:
            self._conn.execute('DELETE FROM kv')
            self._conn.execute('UPDATE seq SET txid = 0')

    def close(self):
        with self._lock:
            self._conn.close()

    def dump(self, target: Union[str, Path]):
        """Consistent copy via the SQLite online-backup API (includes any
        unflushed WAL content, unlike a file copy)."""
        Path(target).parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            dst = sqlite3.connect(str(target))
            with dst:
                self._conn.backup(dst)
            dst.close()

    def load(self, source: Union[str, Path]):
        """Replace current content from a dump, through the open connection."""
        with self._lock:
            src = sqlite3.connect(str(source))
            with self._conn:
                src.backup(self._conn)
            src.close()

    @property
    def size(self) -> int:
        with self._lock:
            return self._conn.execute('SELECT COUNT(*) FROM kv').fetchone()[0]

    @property
    def stat(self) -> dict:
        return {'entries': self.size, 'backend': 'sqlite-wal'}

    @property
    def last_transaction_id(self) -> int:
        """Monotone write counter (reference uses RocksDB's latest sequence
        number, `kv.py:134-136`)."""
        with self._lock:
            return self._conn.execute('SELECT txid FROM seq').fetchone()[0]
