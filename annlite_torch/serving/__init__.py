"""The serving layer: the executor, the shard gateway and the HTTP and gRPC
front ends; the port of `annlite_tpu/serving/`.

``AnnLiteIndexer`` and ``Gateway`` need nothing beyond the port itself; the
HTTP front end (``Server``, ``make_app``, ``serve``) needs aiohttp and the
gRPC one (``GrpcServer``, ``GrpcClient``) grpcio, so they are imported only
when asked for.
"""
from .executor import AnnLiteIndexer
from .gateway import Gateway

_LAZY = {'Server': 'http', 'make_app': 'http', 'serve': 'http',
         'GrpcServer': 'grpc_server', 'GrpcClient': 'grpc_server'}

__all__ = [
    'AnnLiteIndexer', 'Gateway', 'GrpcClient', 'GrpcServer', 'Server',
    'make_app', 'serve',
]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f'.{_LAZY[name]}', __name__), name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
