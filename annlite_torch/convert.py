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

from .codecs import OPQCodec, PQCodec, ProjectorCodec, VQCodec
from .index.flat import FlatIndex
from .index.graph import GraphIndex
from .index.ivf_pq import IVFPQIndex
from .index.pq_scan import PQScanIndex
from .parallel import ShardedFlatIndex, ShardedGraphIndex, ShardedIVFPQIndex, ShardedPQIndex

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


def opq_codec_from_jax_state(params: Mapping, arrays: Mapping[str, np.ndarray],
                             device: Device = None) -> OPQCodec:
    """An :class:`OPQCodec` from a JAX ``OPQCodec._state()`` (the PQ state
    plus ``opq_iters``, ``opq_init`` and the ``rotation`` array)."""
    return _codec_from_jax_state(OPQCodec, params, arrays, device)


def projector_codec_from_jax_state(params: Mapping, arrays: Mapping[str, np.ndarray],
                                   device: Device = None) -> ProjectorCodec:
    """A :class:`ProjectorCodec` from a JAX ``ProjectorCodec._state()``
    (moments, mean, components, explained variance)."""
    return _codec_from_jax_state(ProjectorCodec, params, arrays, device)


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


def graph_index_from_jax_state(state: Mapping[str, np.ndarray],
                               pq_codec: Optional[PQCodec] = None,
                               **index_kwargs) -> GraphIndex:
    """A :class:`GraphIndex` from a graph index's ``state_arrays()``
    (vectors, adjacency, alive); ``index_kwargs`` (``metric``,
    ``max_degree``, ``ef_search``, ``rerank``, ``traverse``, ``build_mode``,
    ``device``, ...) go to the constructor.  A W-wide adjacency of a device
    build is kept as it is by ``build_mode='device'`` and consolidated to
    each row's ``max_degree`` nearest neighbours by the host build."""
    _kind(state, 'graph')
    dim = np.asarray(state['vectors']).shape[1]
    index = GraphIndex(dim, pq_codec=pq_codec, **index_kwargs)
    index.load_state_arrays(state)
    return index


def sharded_pq_index_from_jax_state(state: Mapping[str, np.ndarray], pq_codec: PQCodec,
                                    **index_kwargs) -> ShardedPQIndex:
    """A :class:`ShardedPQIndex` over ``pq_codec`` from a sharded PQ index's
    ``state_arrays()`` (codes, alive; no shard count in it);
    ``index_kwargs`` (``mesh``, ``n_devices``, ``device``) go to the
    constructor."""
    _kind(state, 'sharded_pq')
    index = ShardedPQIndex(pq_codec.dim, pq_codec, **index_kwargs)
    index.load_state_arrays(state)
    return index


def sharded_flat_index_from_jax_state(state: Mapping[str, np.ndarray],
                                      **index_kwargs) -> ShardedFlatIndex:
    """A :class:`ShardedFlatIndex` from a sharded flat index's
    ``state_arrays()`` (vectors, alive); ``index_kwargs`` (``metric``,
    ``mesh``, ``n_devices``, ``device``) go to the constructor."""
    _kind(state, 'sharded_flat')
    index = ShardedFlatIndex(np.asarray(state['vectors']).shape[1], **index_kwargs)
    index.load_state_arrays(state)
    return index


def sharded_ivf_pq_index_from_jax_state(state: Mapping[str, np.ndarray], pq_codec: PQCodec,
                                        **index_kwargs) -> ShardedIVFPQIndex:
    """A :class:`ShardedIVFPQIndex` over ``pq_codec`` from a sharded IVF-PQ
    index's ``state_arrays()`` (the blocked store, and the slot-major rerank
    vectors, which need ``rerank > 0``)."""
    _kind(state, 'sharded_ivf_pq')
    index = ShardedIVFPQIndex(pq_codec.dim, pq_codec, **index_kwargs)
    index.load_state_arrays(state)
    return index


def sharded_graph_index_from_jax_state(state: Mapping[str, np.ndarray],
                                       pq_codec: Optional[PQCodec] = None,
                                       **index_kwargs) -> ShardedGraphIndex:
    """A :class:`ShardedGraphIndex` from a sharded graph index's
    ``state_arrays()`` (per-shard adjacency and sizes, global vectors,
    alive).  Its mesh must have the snapshot's shard count: the index raises
    otherwise."""
    _kind(state, 'sharded_graph')
    dim = np.asarray(state['vectors']).shape[1]
    index = ShardedGraphIndex(dim, pq_codec=pq_codec, **index_kwargs)
    index.load_state_arrays(state)
    return index
