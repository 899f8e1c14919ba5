from .base import BaseCodec
from .pq import DistanceTable, PQCodec
from .vq import VQCodec

__all__ = ['BaseCodec', 'PQCodec', 'VQCodec', 'DistanceTable']
