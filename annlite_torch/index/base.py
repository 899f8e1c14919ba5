"""Index base (reference `annlite/core/index/base.py:10-57`): capacity
bookkeeping + CRUD interface over global rows."""
import abc
from typing import Optional

import numpy as np

from ..enums import ExpandMode, Metric, parse_metric


class BaseIndex(abc.ABC):
    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.COSINE,
        dtype=np.float32,
        initial_size: Optional[int] = None,
        expand_step_size: int = 10240,
        expand_mode: ExpandMode = ExpandMode.ADAPTIVE,
    ):
        self.dim = dim
        self.metric = parse_metric(metric)
        self.dtype = np.dtype(dtype)
        self.initial_size = initial_size or expand_step_size
        self.expand_step_size = expand_step_size
        if isinstance(expand_mode, str):
            expand_mode = ExpandMode.from_string(expand_mode)
        self.expand_mode = expand_mode

    @property
    @abc.abstractmethod
    def size(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def capacity(self) -> int:
        ...

    @abc.abstractmethod
    def add_with_ids(self, x: np.ndarray, ids: np.ndarray):
        """Write vectors at the given global rows."""

    @abc.abstractmethod
    def search(self, query: np.ndarray, limit: int = 10, mask=None):
        """Return ``(dists[Q, k], rows[Q, k])``; ``mask`` is a boolean/int8
        row predicate fused into scoring."""

    def update_with_ids(self, x: np.ndarray, ids: np.ndarray):
        self.add_with_ids(x, ids)

    @abc.abstractmethod
    def reset(self):
        ...
