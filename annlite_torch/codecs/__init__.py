from .base import BaseCodec
from .opq import OPQCodec
from .pq import DistanceTable, PQCodec
from .projector import ProjectorCodec
from .vq import VQCodec

__all__ = ['BaseCodec', 'PQCodec', 'OPQCodec', 'VQCodec', 'ProjectorCodec', 'DistanceTable']
