"""DeviceBuffer — growable host array with an incrementally-synced device
mirror; the port of `annlite_tpu/index/buffer.py`.

CRUD writes go to a numpy host buffer (append/scatter) and mark their chunks
dirty; :meth:`DeviceBuffer.device_view` then copies only the dirty chunks
into a preallocated device tensor with an in-place ``copy_``.  This replaces
the JAX package's donated ``dynamic_update_slice`` flush, which existed
because JAX arrays are immutable; a PyTorch tensor is updated in place.

``grow_axis=1`` grows the last axis, for the transposed ``[M, N]`` PQ codes.
``device_dtype`` keeps the device copy in another type than the host's: the
rerank rows live on the device as bfloat16, which numpy lacks, so the host
keeps float32 values rounded to bfloat16 on write (round to nearest even,
as ``ml_dtypes`` rounds in the JAX package) and the two copies hold the same
numbers.
"""
from typing import Optional, Tuple

import numpy as np
import torch

from ..enums import ExpandMode


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DeviceBuffer:
    """Host-resident growable array of rows ``[N, *fixed_shape]`` + device
    mirror on ``device``.  Rows are written host-side immediately; device
    sync happens lazily per dirty chunk on :meth:`device_view`.
    """

    def __init__(
        self,
        fixed_shape: Tuple[int, ...],
        dtype,
        device: torch.device,
        chunk: int = 65536,
        initial_capacity: int = 0,
        expand_mode: 'ExpandMode' = None,
        expand_step: int = 10240,
        grow_axis: int = 0,
        device_dtype: Optional[torch.dtype] = None,
    ):
        if grow_axis not in (0, 1):
            raise ValueError(f'grow_axis must be 0 or 1, got {grow_axis}')
        self.fixed_shape = tuple(fixed_shape)  # shape of non-growing axes
        self.dtype = np.dtype(dtype)
        self.grow_axis = grow_axis
        self.device = torch.device(device)
        self._host_tdtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self.device_dtype = device_dtype or self._host_tdtype
        self.chunk = chunk
        self.expand_mode = (
            expand_mode if expand_mode is not None else ExpandMode.ADAPTIVE
        )
        self.expand_step = int(expand_step)
        # STEP/DOUBLE honor an explicit initial capacity exactly (reference
        # base.py:23 `initial_size or expand_step_size`); ADAPTIVE keeps
        # chunk-quantized shapes
        if self.expand_mode is ExpandMode.ADAPTIVE:
            self.capacity = max(initial_capacity, chunk)
        else:
            self.capacity = max(initial_capacity or self.expand_step, 1)
        self.size = 0
        self._host = np.zeros(self._shape(self.capacity), dtype=self.dtype)
        self._device: Optional[torch.Tensor] = None
        self._device_cap = 0
        self._dirty = set()

    def _shape(self, n: int) -> Tuple[int, ...]:
        if self.grow_axis == 0:
            return (n,) + self.fixed_shape
        return self.fixed_shape + (n,)

    def _rows(self, lo: int, hi: int):
        """Index of rows ``[lo, hi)`` along the growing axis."""
        return slice(lo, hi) if self.grow_axis == 0 else (Ellipsis, slice(lo, hi))

    # ----- host writes -----

    def ensure_capacity(self, n: int):
        if n <= self.capacity:
            return
        if self.expand_mode is ExpandMode.STEP:
            # reference flat_index.py:52-58: capacity grows by fixed
            # expand_step_size blocks (predictable memory, more reallocs)
            new_cap = self.capacity + _round_up(
                n - self.capacity, self.expand_step)
        elif self.expand_mode is ExpandMode.DOUBLE:
            new_cap = max(self.capacity, 1)
            while new_cap < n:
                new_cap *= 2
        else:  # ADAPTIVE (default): double, chunk-quantized — amortized
            # O(1) copies
            new_cap = _round_up(max(n, self.capacity * 2), self.chunk)
        new = np.zeros(self._shape(new_cap), dtype=self.dtype)
        new[self._rows(0, self.capacity)] = self._host
        self._host = new
        self.capacity = new_cap

    def append(self, values: np.ndarray) -> np.ndarray:
        """Append rows; returns their positions."""
        n = values.shape[0] if self.grow_axis == 0 else values.shape[-1]
        rows = np.arange(self.size, self.size + n)
        self.write(rows, values)
        return rows

    def write(self, rows: np.ndarray, values: np.ndarray):
        """Scatter rows (host) and mark their chunks dirty."""
        rows = np.asarray(rows)
        if rows.size == 0:
            return
        hi = int(rows.max()) + 1
        self.ensure_capacity(hi)
        if self.device_dtype != self._host_tdtype:
            # round on the host exactly as the device copy will hold it
            values = torch.from_numpy(np.ascontiguousarray(values, self.dtype)).to(
                self.device_dtype).to(self._host_tdtype).numpy()
        if self.grow_axis == 0:
            self._host[rows] = values
        else:
            self._host[..., rows] = values
        self.size = max(self.size, hi)
        for c in np.unique(rows // self.chunk):
            self._dirty.add(int(c))

    def host_view(self) -> np.ndarray:
        return self._host[self._rows(0, self.size)]

    # ----- device sync -----

    @property
    def device_capacity(self) -> int:
        return self._device_cap

    def device_view(self) -> torch.Tensor:
        """Return the device mirror (padded to a chunk multiple), first
        copying any dirty chunks into it in place."""
        need_cap = _round_up(max(self.size, self.chunk), self.chunk)
        if self._device is None or self._device_cap < need_cap:
            # full (re)allocation on growth — amortized by doubling host
            # capacity; drop the old mirror first so both never coexist
            self._device = None
            self._device = torch.zeros(self._shape(need_cap),
                                       dtype=self.device_dtype, device=self.device)
            self._device_cap = need_cap
            self._dirty = set(range(need_cap // self.chunk))
        for c in sorted(self._dirty):
            start = c * self.chunk
            if start >= self._device_cap:
                continue
            end = min(start + self.chunk, self.capacity)
            vals = np.ascontiguousarray(self._host[self._rows(start, end)])
            self._device[self._rows(start, end)].copy_(torch.from_numpy(vals))
        self._dirty.clear()
        return self._device

    def reset(self):
        self.size = 0
        self._host[:] = 0
        self._device = None
        self._device_cap = 0
        self._dirty.clear()
