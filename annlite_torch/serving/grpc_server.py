"""gRPC transport for AnnLiteIndexer.

The reference is served over Jina Flow's gRPC (SURVEY.md §2.3 item 5);
here we expose the same executor endpoints as unary gRPC methods under
``/annlite.AnnLite/<Endpoint>`` with msgpack-serialized payloads (the
service is registered via ``GenericRpcHandler``, with no protoc codegen —
wire-compatible with any client that speaks msgpack over unary gRPC).

Payload schema (both directions): a msgpack map mirroring the HTTP JSON
protocol of `serving/http.py` (docs carry ``embedding`` as a raw float32
buffer + shape for zero-copy).

The port's copy of `annlite_tpu/serving/grpc_server.py`.  The wire is
encoded by the port's own msgpack subset (`annlite_torch/doc.py` ``packb``
/ ``unpackb``: the bytes of ``msgpack.packb(payload, use_bin_type=True)``,
decoded as ``msgpack.unpackb(raw=False)`` does), so the msgpack package is
not needed.
"""
from concurrent import futures
from typing import Dict, List, Optional

import grpc
import numpy as np

from ..doc import Doc, packb, unpackb
from .executor import AnnLiteIndexer

SERVICE = 'annlite.AnnLite'
ENDPOINTS = (
    'Index', 'Update', 'Delete', 'Search', 'Filter', 'FillEmbedding',
    'Status', 'Backup', 'Restore', 'Clear',
)


def _doc_to_wire(d: Doc, include_embedding: bool = False) -> Dict:
    out = {'id': d.id, 'tags': d.tags}
    if d.score is not None:
        out['score'] = float(d.score)
    if include_embedding and d.embedding is not None:
        emb = np.ascontiguousarray(d.embedding, dtype=np.float32)
        out['emb'] = emb.tobytes()
        out['emb_shape'] = list(emb.shape)
    if d.matches:
        out['matches'] = [_doc_to_wire(m) for m in d.matches]
    return out


def _doc_from_wire(d: Dict) -> Doc:
    emb = None
    if 'emb' in d:
        emb = np.frombuffer(d['emb'], dtype=np.float32).reshape(d['emb_shape'])
    elif 'embedding' in d and d['embedding'] is not None:
        emb = np.asarray(d['embedding'], dtype=np.float32)
    return Doc(id=d['id'], embedding=emb, tags=d.get('tags', {}))


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, executor: AnnLiteIndexer):
        self.executor = executor

    def service(self, handler_call_details):
        parts = handler_call_details.method.strip('/').split('/')
        if len(parts) != 2 or parts[0] != SERVICE or parts[1] not in ENDPOINTS:
            return None
        endpoint = parts[1]

        def unary(request: bytes, context) -> bytes:
            try:
                payload = unpackb(request) if request else {}
                if not isinstance(payload, dict):
                    raise ValueError('payload must be a map')
            except Exception as e:  # malformed wire bytes
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, f'bad payload: {e}')
            try:
                return packb(self._dispatch(endpoint, payload))
            except RuntimeError as e:  # buffer-not-drained etc.
                context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
            except ValueError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))

        return grpc.unary_unary_rpc_method_handler(
            unary,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )

    def _dispatch(self, endpoint: str, payload: Dict) -> Dict:
        ex = self.executor
        docs = [_doc_from_wire(d) for d in payload.get('docs', [])]
        params = payload.get('parameters', {}) or {}
        if endpoint == 'Index':
            ex.index(docs, params)
            return {'status': 'ok'}
        if endpoint == 'Update':
            ex.update(docs, params)
            return {'status': 'ok'}
        if endpoint == 'Delete':
            ex.delete(params)
            return {'status': 'ok'}
        if endpoint == 'Search':
            out = ex.search(docs, params)
            return {'results': [_doc_to_wire(d) for d in out]}
        if endpoint == 'Filter':
            out = ex.filter(params)
            return {'docs': [_doc_to_wire(d, include_embedding=True) for d in out]}
        if endpoint == 'FillEmbedding':
            out = ex.fill_embedding(docs)
            return {'docs': [_doc_to_wire(d, include_embedding=True) for d in out]}
        if endpoint == 'Status':
            return ex.status()
        if endpoint == 'Backup':
            return {'status': 'ok', 'path': ex.backup(params)}
        if endpoint == 'Restore':
            ex.restore(params)
            return {'status': 'ok'}
        if endpoint == 'Clear':
            ex.clear()
            return {'status': 'ok'}
        raise AssertionError(endpoint)


class GrpcServer:
    def __init__(self, executor: AnnLiteIndexer, host: str = '127.0.0.1',
                 port: int = 50051, max_workers: int = 8):
        self.executor = executor
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[('grpc.max_receive_message_length', 256 * 1024 * 1024),
                     ('grpc.max_send_message_length', 256 * 1024 * 1024)],
        )
        self._server.add_generic_rpc_handlers((_Handler(executor),))
        # the BOUND port, so port=0 (ephemeral) works
        bound = self._server.add_insecure_port(f'{host}:{port}')
        self.address = f'{host}:{bound}'

    def start(self):
        self._server.start()
        return self

    def stop(self, grace: Optional[float] = 2.0):
        self._server.stop(grace)
        self.executor.close()

    def wait(self):
        self._server.wait_for_termination()


class GrpcClient:
    """Minimal msgpack-over-gRPC client for the service above."""

    def __init__(self, address: str, timeout: float = 60.0):
        self.channel = grpc.insecure_channel(
            address,
            options=[('grpc.max_receive_message_length', 256 * 1024 * 1024),
                     ('grpc.max_send_message_length', 256 * 1024 * 1024)],
        )
        self.timeout = timeout

    def call(self, endpoint: str, payload: Optional[Dict] = None) -> Dict:
        fn = self.channel.unary_unary(
            f'/{SERVICE}/{endpoint}',
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        return unpackb(fn(packb(payload or {}), timeout=self.timeout))

    # convenience wrappers
    def index(self, docs: List[Doc]):
        return self.call('Index', {'docs': [_doc_to_wire(d, True) for d in docs]})

    def search(self, docs: List[Doc], parameters: Optional[Dict] = None):
        return self.call(
            'Search',
            {'docs': [_doc_to_wire(d, True) for d in docs],
             'parameters': parameters or {}},
        )

    def delete(self, ids: List[str]):
        return self.call('Delete', {'parameters': {'ids': ids}})

    def status(self) -> Dict:
        return self.call('Status')

    def close(self):
        self.channel.close()
