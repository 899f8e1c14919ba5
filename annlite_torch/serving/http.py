"""HTTP transport for AnnLiteIndexer (aiohttp); the port's copy of
`annlite_tpu/serving/http.py`.  ``annlite_torch.serving`` imports it only
when one of its names is asked for, so the executor runs without aiohttp.

Replaces the Jina Flow gateway/gRPC layer (reference `annlite/executor.py`
is mounted in a Flow; SURVEY.md §2.3 item 5).  JSON protocol:

    POST /index   {"docs": [{"id", "embedding": [...], "tags": {...}}]}
    POST /update  {"docs": [...], "parameters": {...}}
    POST /delete  {"parameters": {"ids": [...]}}
    POST /search  {"docs": [...], "parameters": {"filter", "limit"}}
    POST /filter  {"parameters": {"filter", "limit", "offset", "order_by"}}
    POST /fill_embedding {"docs": [{"id": ...}]}
    GET  /status
    POST /backup  {"parameters": {"target_name"}}
    POST /restore {"parameters": {"source_name"}}
    POST /clear
"""
import asyncio
import threading
from typing import Dict, List, Optional

import numpy as np
from aiohttp import web

from .. import profile
from ..doc import Doc
from .executor import AnnLiteIndexer


def doc_from_json(d: Dict) -> Doc:
    emb = d.get('embedding')
    return Doc(
        id=d['id'],
        embedding=np.asarray(emb, dtype=np.float32) if emb is not None else None,
        tags=d.get('tags', {}),
    )


def doc_to_json(d: Doc, include_embedding: bool = False) -> Dict:
    out = {'id': d.id, 'tags': d.tags}
    if d.score is not None:
        out['score'] = d.score
    if include_embedding and d.embedding is not None:
        out['embedding'] = np.asarray(d.embedding).tolist()
    if d.matches:
        out['matches'] = [doc_to_json(m) for m in d.matches]
    return out


def make_app(
    executor: AnnLiteIndexer, batch_window_ms: float = 3.0,
    max_batch: int = 256,
) -> web.Application:
    app = web.Application(client_max_size=1024 * 1024 * 256)
    batcher = None
    if batch_window_ms > 0:
        from .batcher import QueryBatcher

        batcher = QueryBatcher(
            executor.search, max_batch=max_batch, max_wait_ms=batch_window_ms
        )

        async def _close_batcher(app_):
            await batcher.close()

        app.on_cleanup.append(_close_batcher)

    def json_docs(payload) -> List[Doc]:
        return [doc_from_json(d) for d in payload.get('docs', [])]

    async def _run(fn, *args, **kw):
        # executor calls are blocking (device compute / sqlite) — keep the
        # event loop responsive
        return await asyncio.get_event_loop().run_in_executor(
            None, lambda: fn(*args, **kw)
        )

    async def h_index(request):
        p = await request.json()
        await _run(executor.index, json_docs(p), p.get('parameters'))
        return web.json_response({'status': 'ok'})

    async def h_update(request):
        p = await request.json()
        try:
            await _run(executor.update, json_docs(p), p.get('parameters'))
        except RuntimeError as e:
            return web.json_response({'error': str(e)}, status=409)
        except ValueError as e:
            return web.json_response({'error': str(e)}, status=404)
        return web.json_response({'status': 'ok'})

    async def h_delete(request):
        p = await request.json()
        try:
            await _run(executor.delete, p.get('parameters', {}))
        except RuntimeError as e:
            return web.json_response({'error': str(e)}, status=409)
        except ValueError as e:
            return web.json_response({'error': str(e)}, status=404)
        return web.json_response({'status': 'ok'})

    async def h_search(request):
        p = await request.json()
        if batcher is not None:
            # continuous micro-batching: concurrent requests with equal
            # parameters share one device dispatch (serving/batcher.py)
            docs = await batcher.submit(json_docs(p), p.get('parameters'))
        else:
            docs = await _run(executor.search, json_docs(p), p.get('parameters'))
        return web.json_response({'results': [doc_to_json(d) for d in docs]})

    async def h_filter(request):
        p = await request.json()
        docs = await _run(executor.filter, p.get('parameters', {}))
        return web.json_response(
            {'docs': [doc_to_json(d, include_embedding=True) for d in docs]}
        )

    async def h_fill(request):
        p = await request.json()
        docs = await _run(executor.fill_embedding, json_docs(p))
        return web.json_response(
            {'docs': [doc_to_json(d, include_embedding=True) for d in docs]}
        )

    async def h_status(request):
        st = await _run(executor.status)
        if batcher is not None:
            st['batcher'] = batcher.stats
        # the process's span totals and counters (`profile.py`)
        st['tracing'] = profile.snapshot()
        return web.json_response(st)

    async def h_backup(request):
        p = await request.json() if request.can_read_body else {}
        path = await _run(executor.backup, p.get('parameters', {}))
        return web.json_response({'status': 'ok', 'path': path})

    async def h_restore(request):
        p = await request.json() if request.can_read_body else {}
        await _run(executor.restore, p.get('parameters', {}))
        return web.json_response({'status': 'ok'})

    async def h_clear(request):
        await _run(executor.clear)
        return web.json_response({'status': 'ok'})

    app.router.add_post('/index', h_index)
    app.router.add_post('/update', h_update)
    app.router.add_post('/delete', h_delete)
    app.router.add_post('/search', h_search)
    app.router.add_post('/filter', h_filter)
    app.router.add_post('/fill_embedding', h_fill)
    app.router.add_get('/status', h_status)
    app.router.add_post('/backup', h_backup)
    app.router.add_post('/restore', h_restore)
    app.router.add_post('/clear', h_clear)
    return app


class Server:
    """Run the executor behind an HTTP port (background thread)."""

    def __init__(self, executor: AnnLiteIndexer, host: str = '127.0.0.1', port: int = 8080):
        self.executor = executor
        self.host = host
        self.port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    def start(self):
        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            app = make_app(self.executor)
            runner = web.AppRunner(app)
            self._loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, self.host, self.port)
            self._loop.run_until_complete(site.start())
            # the BOUND port, so port=0 (ephemeral) works
            self.port = runner.addresses[0][1]
            self._started.set()
            self._loop.run_forever()
            self._loop.run_until_complete(runner.cleanup())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)
        return self

    def stop(self):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.executor.close()


def serve(host: str = '0.0.0.0', port: int = 8080, **executor_kwargs):
    """Blocking entry point: ``python -m annlite_torch.serving --n-dim 128``."""
    executor = AnnLiteIndexer(**executor_kwargs)
    app = make_app(executor)
    web.run_app(app, host=host, port=port)
