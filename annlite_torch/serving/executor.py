"""AnnLiteIndexer — the serving executor.

Re-expression of the reference Jina executor (`annlite/executor.py:98-389`)
without Jina: same endpoint surface (/index /update /delete /search /filter
/fill_embedding /status /backup /restore /clear, `executor.py:115-374`),
same async-ingest design — a bounded write buffer drained by a background
thread in batches of ``INDEX_BATCH_SIZE`` with backpressure at 2x
(`executor.py:86-89,141-175`), update/delete refusing while the buffer is
non-empty (`executor.py:199-238`), per-shard workspace naming for
backup/restore (`executor.py:292-316`).

Transport lives in `serving/http.py`; this class is transport-agnostic so a
gRPC front-end can reuse it.  The port's copy of
`annlite_tpu/serving/executor.py`; ``device`` (in ``index_kwargs``) reaches
``AnnLite``, so a config's ``params`` choose the card or the CPU.
"""
import threading

import traceback
from pathlib import Path
from typing import Dict, List, Optional

from ..doc import Doc
from ..helper import setup_logging
from ..index_api import AnnLite

INDEX_BATCH_SIZE = 1024


class AnnLiteIndexer:
    def __init__(
        self,
        n_dim: int = 0,
        metric: str = 'cosine',
        limit: int = 10,
        match_args: Optional[Dict] = None,
        data_path: Optional[str] = None,
        workspace: Optional[str] = None,
        shard_id: int = 0,
        shards: int = 1,
        verbose: bool = False,
        **index_kwargs,
    ):
        if not n_dim:
            raise ValueError('Please specify the dimension of the vectors `n_dim`')
        if shards > 1 and data_path:
            raise ValueError(
                '`data_path` is not supported when shards > 1, please use `workspace` instead'
            )
        self.metric = metric
        self.match_args = match_args or {}
        self.limit = limit
        self.shard_id = shard_id
        self.shards = shards
        self.logger = setup_logging(verbose, name=f'executor.shard{shard_id}')

        workspace = workspace or './workspace'
        path = data_path or str(Path(workspace) / f'shard_{shard_id}')
        self._index = AnnLite(
            n_dim=n_dim, metric=metric, data_path=path, verbose=verbose, **index_kwargs
        )

        self._data_buffer: List[Doc] = []
        self._index_batch_size = INDEX_BATCH_SIZE
        self._max_length_queue = 2 * self._index_batch_size
        self._index_lock = threading.RLock()
        # drain/backpressure coordination: the loop notifies after every
        # committed batch, writers notify after every enqueue — flush() and
        # the backpressure wait are event-driven, not polled (deterministic
        # tests; the reference sleeps instead, `tests/.../sleep(2)`)
        self._cv = threading.Condition(self._index_lock)
        self._stop = False
        # poison docs are quarantined here instead of killing the ingest
        # loop (reference pattern: `annlite/executor.py:141-175` keeps the
        # loop alive across requests); bounded so a poison flood can't OOM
        self._dead_letter: List[Dict] = []
        self._dead_letter_cap = 1024
        self._n_quarantined = 0
        self._warmup_device()
        self._start_index_loop()

    def _warmup_device(self):
        """Build the CUDA kernels and run one op on the facade's card, on
        the MAIN thread, before the ingest thread starts: no request then
        waits for ``nvcc``, and the first launch from any thread only loads
        a built library (under ``_ext.library``'s lock).  Nothing to do on
        the CPU."""
        device = self._index.device
        if device.type != 'cuda':
            return
        import torch

        from ..ops import _ext

        _ext.build()
        (torch.ones(4, device=device) * 2).sum().item()
        torch.cuda.synchronize(device)

    # ------------------------------------------------------------------
    # async ingest
    # ------------------------------------------------------------------

    def _start_index_loop(self):
        def _index_loop():
            while True:
                with self._cv:
                    while not self._data_buffer and not self._stop:
                        self._cv.wait(timeout=0.5)
                    if self._stop and not self._data_buffer:
                        return
                    n = min(len(self._data_buffer), self._index_batch_size)
                    batch, self._data_buffer = (
                        self._data_buffer[:n],
                        self._data_buffer[n:],
                    )
                    try:
                        self._index.index(batch)
                        self.logger.debug(f'indexed {n} docs')
                    except Exception:
                        # one bad doc must not poison the batch or kill the
                        # loop: retry per-doc, quarantine the failures
                        self.logger.warning(
                            f'batch of {n} failed, retrying per-doc:\n'
                            f'{traceback.format_exc()}'
                        )
                        self._index_one_by_one(batch)
                    # batch committed under the lock: flush()/backpressure
                    # waiters can re-check now
                    self._cv.notify_all()

        self._index_thread = threading.Thread(target=_index_loop, daemon=True)
        self._index_thread.start()

    def _index_one_by_one(self, batch: List[Doc]):
        """Per-doc retry of a failed batch; failures land in the
        dead-letter list (surfaced via /status) instead of raising."""
        for doc in batch:
            try:
                self._index.index([doc])
            except Exception as e:
                self._n_quarantined += 1
                if len(self._dead_letter) < self._dead_letter_cap:
                    self._dead_letter.append(
                        {'id': getattr(doc, 'id', None), 'error': repr(e)}
                    )

    def _check_loop_alive(self):
        if not self._index_thread.is_alive() and not self._stop:
            raise RuntimeError(
                'the ingest loop is dead — the executor must be recreated'
            )

    def flush(self):
        """Block until the write buffer is fully drained AND the in-flight
        batch has committed (the loop indexes under the lock, so observing
        an empty buffer here implies the last batch committed)."""
        with self._cv:
            while self._data_buffer:
                self._check_loop_alive()
                self._cv.wait(timeout=0.5)

    # ------------------------------------------------------------------
    # endpoints
    # ------------------------------------------------------------------

    def index(self, docs: Optional[List[Doc]] = None, parameters: Dict = None, **kw):
        if not docs:
            return
        with self._cv:
            # backpressure (reference `executor.py:135-136`), bounded: if
            # the ingest loop died the wait would otherwise block forever
            while len(self._data_buffer) >= self._max_length_queue:
                self._check_loop_alive()
                self._cv.wait(timeout=0.5)
            self._data_buffer.extend(docs)
            self._cv.notify_all()

    def update(self, docs: Optional[List[Doc]] = None, parameters: Dict = None, **kw):
        if not docs:
            return
        parameters = parameters or {}
        with self._index_lock:
            if self._data_buffer:
                raise RuntimeError(
                    'Cannot update documents while pending documents in the '
                    'buffer are not indexed yet.'
                )
            self._index.update(
                docs,
                insert_if_not_found=bool(parameters.get('insert_if_not_found', False)),
                raise_errors_on_not_found=bool(
                    parameters.get('raise_errors_on_not_found', False)
                ),
            )

    def delete(self, parameters: Dict = None, **kw):
        parameters = parameters or {}
        ids = parameters.get('ids', [])
        if not ids:
            return
        with self._index_lock:
            if self._data_buffer:
                raise RuntimeError(
                    'Cannot delete documents while pending documents in the '
                    'buffer are not indexed yet.'
                )
            self._index.delete(
                ids,
                raise_errors_on_not_found=bool(
                    parameters.get('raise_errors_on_not_found', False)
                ),
            )

    def search(self, docs: Optional[List[Doc]] = None, parameters: Dict = None, **kw):
        if not docs:
            return []
        parameters = parameters or {}
        match_args = dict(self.match_args)
        match_args.update(parameters)
        flt = match_args.get('filter', None)
        limit = int(match_args.get('limit', self.limit))
        include_metadata = bool(match_args.get('include_metadata', True))
        # under the threaded HTTP server a search concurrent with
        # update()/ingest could otherwise dispatch against an index whose
        # device buffers are being rebuilt (donated) mid-mutation
        with self._index_lock:
            return self._index.search(
                docs, filter=flt, limit=limit,
                include_metadata=include_metadata,
            )

    def filter(self, parameters: Dict = None, **kw) -> List[Doc]:
        parameters = parameters or {}
        with self._index_lock:
            return self._index.filter(
                filter=parameters.get('filter', None),
                limit=int(parameters.get('limit', self.limit)),
                offset=int(parameters.get('offset', 0)),
                order_by=parameters.get('order_by', None),
                ascending=bool(parameters.get('ascending', True)),
                include_metadata=bool(parameters.get('include_metadata', True)),
            )

    def fill_embedding(self, docs: Optional[List[Doc]] = None, **kw):
        """Retrieve stored embeddings for the given doc ids
        (reference `executor.py:318-338`)."""
        if not docs:
            return []
        for doc in docs:
            got = self._index.get_doc_by_id(doc.id)
            if got is not None:
                doc.embedding = got.embedding
                doc.tags = got.tags
        return docs

    def status(self, **kw) -> Dict:
        stat = dict(self._index.stat)
        stat['shard_id'] = self.shard_id
        stat['buffer_size'] = len(self._data_buffer)
        stat['quarantined_docs'] = self._n_quarantined
        stat['dead_letter'] = list(self._dead_letter)
        return stat

    def backup(self, parameters: Dict = None, **kw):
        parameters = parameters or {}
        target = parameters.get('target_name') or parameters.get('name')
        remote = parameters.get('remote')
        self.flush()
        name = f'{target}_shard_{self.shard_id}' if target else None
        # the dump holds the lock, so no write or ingest batch lands in the
        # middle of it; the upload reads the finished archive and does not
        with self._index_lock:
            dest = self._index.backup(name)
        if remote is not None:
            from ..artifacts import Uploader, make_transport

            Uploader(make_transport(remote)).upload_directory(
                dest.name, dest, skip_if_exists=False
            )
        return str(dest)

    def restore(self, parameters: Dict = None, **kw):
        parameters = parameters or {}
        source = parameters.get('source_name') or parameters.get('name')
        name = f'{source}_shard_{self.shard_id}' if source else None
        # a restore loads the doc store and the cell table before it swaps
        # the index: a search in between would map the old index's rows
        # through the restored cells and return the wrong doc ids
        with self._index_lock:
            self._index.restore(name, remote=parameters.get('remote'))

    def clear(self, **kw):
        self.flush()
        with self._index_lock:
            self._data_buffer = []
            self._index.clear()

    def close(self):
        self.flush()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._index_thread.join(timeout=5)
        self._index.close()
