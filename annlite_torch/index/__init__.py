from .base import BaseIndex
from .buffer import DeviceBuffer
from .flat import FlatIndex

__all__ = ['BaseIndex', 'DeviceBuffer', 'FlatIndex']
