"""Open the JAX package's codecs and index state in the port.

``annlite_tpu`` keeps a codec as ``_state()`` dicts (JSON-able ``params``
and numpy ``arrays``, what its ``pq.npz``/``vq.npz`` hold) and snapshots an
index as plain numpy arrays (``state_arrays()``: ``kind`` plus the kind's
arrays), and so does the port.  The functions here turn such states into the
port's objects; ``AnnLite`` restores every snapshot through them, whichever
package wrote it.
"""
from typing import Mapping, Optional, Union

import numpy as np
import torch

from .codecs import PQCodec, VQCodec
from .index.flat import FlatIndex
from .index.ivf_pq import IVFPQIndex
from .index.pq_scan import PQScanIndex

Device = Optional[Union[str, torch.device]]


def _kind(state: Mapping[str, np.ndarray], want: str) -> str:
    kind = str(np.asarray(state['kind']))
    if kind != want:
        raise ValueError(f'expected an index state of kind {want!r}, got {kind!r}')
    return kind


def flat_index_from_jax_state(
    state: Mapping[str, np.ndarray],
    *,
    metric,
    scan_mode: str = 'int8',
    device: Device = None,
    **index_kwargs,
) -> FlatIndex:
    """Build a :class:`FlatIndex` from a flat index's ``state_arrays()``.
    ``index_kwargs`` (growth policy) go to the constructor."""
    kind = str(np.asarray(state['kind']))
    if kind != 'flat':
        raise NotImplementedError(
            f'index state of kind {kind!r} is not a flat index (ROADMAP queue 1 '
            'lists the index kinds still to port)')
    vectors = np.asarray(state['vectors'], dtype=np.float32)
    norms = np.asarray(state['norms'], dtype=np.float32)
    if vectors.ndim != 2 or norms.shape != (vectors.shape[0],):
        raise ValueError(
            f'malformed flat state: vectors {vectors.shape}, norms {norms.shape}')
    index = FlatIndex(vectors.shape[1], metric=metric, scan_mode=scan_mode,
                      device=device, **index_kwargs)
    index.load_state_arrays({'kind': kind, 'vectors': vectors, 'norms': norms})
    return index


def _codec_from_jax_state(cls, params, arrays, device):
    params = dict(params)
    name = params.pop('cls', cls.__name__)
    if name != cls.__name__:
        raise ValueError(f'codec state of class {name!r} is not a {cls.__name__}')
    codec = cls.__new__(cls)
    codec._restore(params, {k: np.asarray(v) for k, v in arrays.items()}, device)
    return codec


def pq_codec_from_jax_state(params: Mapping, arrays: Mapping[str, np.ndarray],
                            device: Device = None) -> PQCodec:
    """A :class:`PQCodec` from a JAX ``PQCodec._state()`` (``params``,
    ``arrays`` as numpy)."""
    return _codec_from_jax_state(PQCodec, params, arrays, device)


def vq_codec_from_jax_state(params: Mapping, arrays: Mapping[str, np.ndarray],
                            device: Device = None) -> VQCodec:
    """A :class:`VQCodec` from a JAX ``VQCodec._state()``."""
    return _codec_from_jax_state(VQCodec, params, arrays, device)


def pq_scan_index_from_jax_state(state: Mapping[str, np.ndarray], pq_codec: PQCodec,
                                 **index_kwargs) -> PQScanIndex:
    """A :class:`PQScanIndex` over ``pq_codec`` from a PQ-scan index's
    ``state_arrays()``; ``index_kwargs`` (``rerank``, ``exact_topk``,
    ``device``, growth policy) go to the constructor.  A state with rerank
    vectors needs ``rerank > 0`` to keep them."""
    _kind(state, 'pq_scan')
    index = PQScanIndex(pq_codec.dim, pq_codec, **index_kwargs)
    index.load_state_arrays(state)
    return index


def ivf_pq_index_from_jax_state(state: Mapping[str, np.ndarray], pq_codec: PQCodec,
                                **index_kwargs) -> IVFPQIndex:
    """An :class:`IVFPQIndex` over ``pq_codec`` from an IVF-PQ index's
    ``state_arrays()``; ``index_kwargs`` (``rerank``, ``block_size``,
    ``device``) go to the constructor."""
    _kind(state, 'ivf_pq')
    index = IVFPQIndex(pq_codec.dim, pq_codec, **index_kwargs)
    index.load_state_arrays(state)
    return index
