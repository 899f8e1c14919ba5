"""DocumentArray storage backend — the `DocumentArray(storage='annlite')`
facet of the reference (`annlite/executor.py:109`, exercised by the
reference's `tests/docarray/` suite); the port's copy of
`annlite_tpu/docarray_compat.py`.

This module does not use the docarray package: it ships a
self-contained ``DocumentArray`` implementing the same storage contract the
reference's backend tests drive (reference `tests/docarray/test_add.py`,
`test_del.py`, `test_find.py`, `test_get.py`, `test_save_load.py`):

* ``DocumentArray(storage='annlite_torch', config={'n_dim': ..., ...})``
  (``storage='annlite'`` too; a ``device`` key in ``config`` reaches
  ``AnnLite`` with the rest)
* ``extend`` / ``append`` — duplicate-alive ids raise
  ``sqlite3.IntegrityError`` (same exception class as the reference)
* ``len(da)``, ``da[offset]``, ``da[doc_id]``, ``da[list_of_ids]``,
  ``da[slice]`` and field selection ``da[sel, 'embedding']`` (missing ids
  raise ``KeyError``)
* ``del da[ids_or_offsets]`` — missing ids raise ``ValueError``
* ``da.find(np_query, limit=10, num_candidates=...)`` — ANN matches
* ``with da:`` context-manager (writes are committed; ``__exit__`` syncs
  ``_offset2ids``)
* persistence through ``config['data_path']`` — reopening the same path
  restores the array (``_offset2ids`` rebuilt from the cell table in
  insertion order); ``da._annlite`` exposes the backing :class:`AnnLite`.
"""
import tempfile
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .doc import Doc
from .index_api import AnnLite


class _Offset2Ids:
    """Insertion-ordered alive doc ids (reference backend's offset↔id map)."""

    def __init__(self, ids: Optional[List[str]] = None):
        self.ids: List[str] = list(ids or [])

    def __len__(self):
        return len(self.ids)

    def index(self, doc_id: str) -> int:
        return self.ids.index(doc_id)


class DocumentArray:
    def __init__(self, storage: str = 'annlite_torch',
                 config: Optional[Dict[str, Any]] = None):
        if storage not in ('annlite_torch', 'annlite'):
            raise ValueError(f'unsupported storage backend {storage!r}')
        cfg = dict(config or {})
        if 'n_dim' not in cfg:
            raise ValueError("config['n_dim'] is required")
        cfg.setdefault('data_path', tempfile.mkdtemp(prefix='annlite_da_'))
        self._annlite = AnnLite(**cfg)
        self._offset2ids = _Offset2Ids(self._load_ids())

    # ----- persistence -----

    def _load_ids(self) -> List[str]:
        tbl = self._annlite._container.cell_table
        rows = tbl.query_all(
            f'SELECT _doc_id FROM {tbl.name} WHERE _alive = 1 ORDER BY _id'
        )
        return [r[0] for r in rows]

    # ----- writes -----

    def extend(self, docs) -> None:
        docs = [self._coerce(d) for d in docs]
        self._annlite.index(docs)
        self._offset2ids.ids.extend(d.id for d in docs)

    def append(self, doc) -> None:
        self.extend([doc])

    def _coerce(self, d) -> Doc:
        if isinstance(d, Doc):
            if d.embedding is not None:
                d.embedding = np.asarray(d.embedding, dtype=np.float32)
            return d
        # duck-typed foreign Document (id/embedding/tags attributes)
        emb = getattr(d, 'embedding', None)
        if emb is not None:
            emb = np.asarray(emb, dtype=np.float32)
        return Doc(id=str(getattr(d, 'id')), embedding=emb,
                   tags=dict(getattr(d, 'tags', {}) or {}))

    def __delitem__(self, key) -> None:
        keys = key if isinstance(key, (list, tuple)) else [key]
        ids = [self._offset2ids.ids[k] if isinstance(k, (int, np.integer))
               else str(k) for k in keys]
        # delete raises ValueError on a missing id (reference
        # tests/docarray/test_del.py::test_delete_not_found).  A partial
        # batch delete (earlier ids removed before the missing one raises)
        # must not desync the offset map — resync it from the table on
        # failure instead of leaving the pre-delete snapshot in place.
        try:
            self._annlite.delete(ids, raise_errors_on_not_found=True)
        except Exception:
            self._offset2ids = _Offset2Ids(self._load_ids())
            raise
        gone = set(ids)
        self._offset2ids.ids = [i for i in self._offset2ids.ids
                                if i not in gone]

    # ----- reads -----

    def __len__(self) -> int:
        return len(self._offset2ids)

    def _get_one(self, key) -> Doc:
        if isinstance(key, (int, np.integer)):
            key = self._offset2ids.ids[key]
        doc = self._annlite.get_doc_by_id(str(key))
        if doc is None:
            raise KeyError(key)
        return doc

    def __getitem__(self, key):
        if isinstance(key, tuple):           # (selector, field)
            sel, field = key
            docs = self[sel]
            if isinstance(docs, Doc):
                return getattr(docs, field)
            return [getattr(d, field) for d in docs]
        if isinstance(key, slice):
            return [self._get_one(i) for i in self._offset2ids.ids[key]]
        if isinstance(key, (list, tuple, np.ndarray)):
            return [self._get_one(k) for k in key]
        return self._get_one(key)

    def __iter__(self):
        for doc_id in list(self._offset2ids.ids):
            yield self._get_one(doc_id)

    # ----- search -----

    def find(self, query: np.ndarray, limit: int = 10,
             filter: Optional[Dict] = None,
             num_candidates: Optional[int] = None) -> List[Doc]:
        """ANN matches for one query vector (or a list for a [Q, D] batch).
        ``num_candidates`` maps to the backing index's rerank width when it
        exceeds ``limit`` (docarray forwards it to annlite's HNSW ef)."""
        q = np.asarray(query, dtype=np.float32)
        batched = q.ndim == 2
        q2 = q if batched else q[None, :]
        qdocs = [Doc(id=f'_q{i}', embedding=q2[i]) for i in range(len(q2))]
        # num_candidates widens the internal candidate pool (the reference
        # forwards it to HNSW ef): search with the wider limit, then
        # truncate the matches back to `limit`
        wide = max(limit, num_candidates or 0)
        self._annlite.search(qdocs, filter=filter, limit=wide)
        out = [d.matches[:limit] for d in qdocs]
        return out if batched else out[0]

    # ----- context manager (reference: `with annlite_doc:` commits) -----

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # writes apply eagerly; re-sync the offset map against the table so
        # external mutations through `._annlite` are reflected
        self._offset2ids = _Offset2Ids(self._load_ids())
        return False

    def close(self):
        self._annlite.close()
