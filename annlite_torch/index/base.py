"""Index base (reference `annlite/core/index/base.py:10-57`): capacity
bookkeeping + CRUD interface over global rows."""
import abc
from typing import Optional

import numpy as np

from ..enums import ExpandMode, Metric, parse_metric


def padded_mask(mask: Optional[np.ndarray], size: int, n_pad: int) -> np.ndarray:
    """The int8 row mask the kernels read: ``n_pad`` rows, ``mask``'s
    first ``size`` rows (all ones when ``mask`` is None), 0 after them."""
    m = np.zeros(n_pad, dtype=np.int8)
    if mask is None:
        m[:size] = 1
    else:
        m[:size] = np.asarray(mask[:size], dtype=np.int8)
    return m


class BaseIndex(abc.ABC):
    # the container passes each row's IVF cells to add_with_ids and search
    wants_cells = False
    # update_with_ids rewrites rows in place: an update that keeps its cell
    # keeps its row instead of a dead-mark and an append
    supports_inplace_update = False
    # search widens its candidate pool whenever it is given a mask, so an
    # all-pass mask and no mask answer differently
    widens_for_mask = False
    # the share of rows the index keeps dead itself (None: it keeps none)
    dead_fraction: Optional[float] = None

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
