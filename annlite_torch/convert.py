"""Open the JAX package's index state in the port.

``annlite_tpu`` snapshots a flat index as plain numpy arrays
(``FlatIndex.state_arrays()``: ``kind``, ``vectors``, ``norms``), and so does
the port.  :func:`flat_index_from_jax_state` turns such a state into the
port's :class:`~annlite_torch.index.flat.FlatIndex`; ``AnnLite`` restores
every snapshot through it, whichever package wrote it.
"""
from typing import Mapping, Optional, Union

import numpy as np
import torch

from .index.flat import FlatIndex


def flat_index_from_jax_state(
    state: Mapping[str, np.ndarray],
    *,
    metric,
    scan_mode: str = 'int8',
    device: Optional[Union[str, torch.device]] = None,
    **index_kwargs,
) -> FlatIndex:
    """Build a :class:`FlatIndex` from a flat index's ``state_arrays()``.
    ``index_kwargs`` (growth policy) go to the constructor."""
    kind = str(np.asarray(state['kind']))
    if kind != 'flat':
        raise NotImplementedError(
            f'index state of kind {kind!r} is not ported yet (ROADMAP queue 1)')
    vectors = np.asarray(state['vectors'], dtype=np.float32)
    norms = np.asarray(state['norms'], dtype=np.float32)
    if vectors.ndim != 2 or norms.shape != (vectors.shape[0],):
        raise ValueError(
            f'malformed flat state: vectors {vectors.shape}, norms {norms.shape}')
    index = FlatIndex(vectors.shape[1], metric=metric, scan_mode=scan_mode,
                      device=device, **index_kwargs)
    index.load_state_arrays({'kind': kind, 'vectors': vectors, 'norms': norms})
    return index
