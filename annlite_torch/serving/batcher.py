"""Continuous micro-batching for the serving search path; the port's copy of
`annlite_tpu/serving/batcher.py`.

On the card a batch-64 search costs about what a batch-1 search does (flat
int8 over 2^20 x 768: 0.67-0.88 ms at batch 64, 0.59-1.12 ms at batch 1, on
an NVIDIA H100 80GB HBM3 at 700 W, `PERF.md` §5: one block pass reads the
whole corpus either way), so concurrent requests should share ONE device
dispatch instead of serializing N of them.  The reference has no
equivalent — Jina forwards each request's batch as-is
(`annlite/executor.py:241-262`); its CPU HNSW gains little from batching.

Requests are grouped by their search ``parameters`` (limit/filter/...):
only requests with identical parameters can share a device call, because
the predicate mask is per-call.  The window closes after ``max_wait_ms``
or when ``max_batch`` queries are pending, whichever comes first — at zero
concurrency a request pays at most the window in added latency.
"""
import asyncio
import json
from typing import Callable, Dict, List, Optional

from ..doc import Doc


class QueryBatcher:
    """Coalesce concurrent ``search(docs, parameters)`` calls.

    ``search_fn(docs, parameters) -> docs_with_matches`` is the blocking
    executor search; it runs in the default thread-pool executor so the
    event loop stays responsive.
    """

    def __init__(
        self,
        search_fn: Callable[[List[Doc], Optional[Dict]], List[Doc]],
        max_batch: int = 256,
        max_wait_ms: float = 3.0,
    ):
        self._search = search_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker_task: Optional[asyncio.Task] = None
        # observability (surfaced via /status)
        self.n_requests = 0
        self.n_dispatches = 0

    def _ensure_worker(self):
        if self._worker_task is None or self._worker_task.done():
            self._worker_task = asyncio.get_event_loop().create_task(
                self._worker()
            )

    async def submit(self, docs: List[Doc], parameters: Optional[Dict]) -> List[Doc]:
        self._ensure_worker()
        fut = asyncio.get_event_loop().create_future()
        key = json.dumps(parameters or {}, sort_keys=True, default=str)
        await self._queue.put((key, docs, parameters, fut))
        self.n_requests += 1
        return await fut

    async def _worker(self):
        loop = asyncio.get_event_loop()
        while True:
            item = await self._queue.get()
            batch = [item]
            # the entire per-batch body is guarded: an exception anywhere
            # (grouping, slicing a short result, ...) must fail the batch's
            # futures and keep the worker alive — otherwise every already-
            # dequeued request hangs until client timeout and the worker only
            # restarts on the NEXT submit
            try:
                await self._process_batch(loop, batch)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                for _k, _d, _p, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    async def _process_batch(self, loop, batch: List):
        item = batch[0]
        n = len(item[1])
        deadline = loop.time() + self.max_wait
        while n < self.max_batch:
            timeout = deadline - loop.time()
            if timeout <= 0:
                break
            try:
                nxt = await asyncio.wait_for(self._queue.get(), timeout)
            except asyncio.TimeoutError:
                break
            batch.append(nxt)
            n += len(nxt[1])

        # group by parameters key: one device dispatch per group
        groups: Dict[str, List] = {}
        for key, docs, params, fut in batch:
            groups.setdefault(key, []).append((docs, params, fut))
        for key, members in groups.items():
            merged: List[Doc] = []
            offsets = [0]
            for docs, _p, _f in members:
                merged.extend(docs)
                offsets.append(len(merged))
            params = members[0][1]
            try:
                out = await loop.run_in_executor(
                    None, lambda m=merged, p=params: self._search(m, p)
                )
                self.n_dispatches += 1
                for i, (_d, _p, fut) in enumerate(members):
                    if not fut.done():
                        fut.set_result(out[offsets[i]: offsets[i + 1]])
            except Exception as e:  # propagate to every waiter
                for _d, _p, fut in members:
                    if not fut.done():
                        fut.set_exception(e)

    async def close(self):
        """Cancel the worker (register on the app's cleanup hook)."""
        if self._worker_task is not None and not self._worker_task.done():
            self._worker_task.cancel()
            try:
                await self._worker_task
            except asyncio.CancelledError:
                pass
        self._worker_task = None

    @property
    def stats(self) -> Dict:
        return {
            'batched_requests': self.n_requests,
            'device_dispatches': self.n_dispatches,
        }
