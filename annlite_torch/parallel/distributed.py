"""Multi-host distribution on ``torch.distributed`` — the port of
`annlite_tpu/parallel/distributed.py`.

One process per host, each driving its own shards (a :class:`~.mesh.Mesh`);
the processes form one process group.  The layout is a 2-D
``('host', 'shard')`` mesh, host-major: the outer axis is the process group,
the inner axis each process's shards.  A search merges hierarchically: the
per-shard winners are merged inside the process (the JAX package's ICI
stage), then only each process's ``[Q, k]`` winners are all-gathered over the
group (its DCN stage), so the traffic between hosts is O(hosts·Q·k) whatever
the corpus size.

Launch recipe (one process per host):

    # host 0                                 # host 1
    python serve.py --coord host0:1234 \
        --nproc 2 --pid 0                    ... --pid 1

    # in serve.py:
    from annlite_torch.parallel.distributed import init_distributed, make_hybrid_mesh
    init_distributed('host0:1234', num_processes=2, process_id=pid)
    mesh = make_hybrid_mesh()   # [n_hosts, shards per host]

NCCL (the card's backend) refuses two ranks on one card.  The CPU rehearsal
runs two processes on one machine with gloo and 4 virtual shards each
(``backend='gloo'``, ``device='cpu'``; `tests/test_torch_distributed.py`).
"""
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..codecs.kmeans import _centroid_update
from ..device import resolve_device
from ..index.base import padded_mask
from ..ops.topk import topk
from .mesh import (Mesh, _lloyd_stats, _padded_codes, _per_shard, _place,
                   make_mesh, sharded_adc_topk)

HOST_AXIS = 'host'
ICI_AXIS = 'shard'


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: Optional[str] = None,
):
    """Join the process group: ``torch.distributed.init_process_group`` over a
    ``tcp://`` rendezvous at ``coordinator_address`` (``'host:port'``; rank 0
    listens there).  ``backend=None`` follows the device: ``'nccl'`` for the
    card, and without CUDA it raises, as every entry point of the port does;
    pass ``'gloo'`` for the CPU.  Idempotent: a second call is a no-op."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        resolve_device(None)  # the card's backend: raises without CUDA
        backend = 'nccl'
    addr = coordinator_address
    if not addr.startswith('tcp://'):
        addr = f'tcp://{addr}'
    dist.init_process_group(backend, init_method=addr, world_size=num_processes,
                            rank=process_id)


def _world() -> tuple:
    """(world size, rank); (1, 0) outside a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class HybridMesh(NamedTuple):
    """A ``(host, shard)`` mesh seen from one process: ``shape`` is
    ``(n_hosts, shards_per_host)``, ``host`` this process's rank and
    ``local`` the :class:`~.mesh.Mesh` of its own shards."""

    shape: tuple
    host: int
    local: Mesh

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def make_hybrid_mesh(mesh_shape: Optional[Sequence[int]] = None,
                     device: Optional[Union[str, torch.device]] = None) -> HybridMesh:
    """The 2-D ``('host', 'shard')`` mesh: the outer axis is the process group
    (one process per host), the inner axis this process's shards on
    ``device`` (``make_mesh``'s default count unless ``mesh_shape`` says).
    ``mesh_shape[0]`` must be the group's size."""
    world, rank = _world()
    if mesh_shape is None:
        mesh_shape = (world, make_mesh(None, device).size)
    hosts, per_host = (int(v) for v in mesh_shape)
    if hosts != world:
        raise ValueError(f'a mesh of {hosts} hosts in a process group of {world}')
    return HybridMesh((hosts, per_host), rank, make_mesh(per_host, device))


def put_sharded(mesh: HybridMesh, x: np.ndarray, axis: Optional[int]) -> List[torch.Tensor]:
    """Place a numpy array that every process holds whole: ``axis=None``
    replicates it on this process's shards; an integer axis splits it into
    ``hosts * shards`` equal pieces, host-major, of which this process
    places its own.  The same call works in one process or across several."""
    x = np.asarray(x)
    if axis is None:
        return _per_shard(mesh.local, x)
    if x.shape[axis] % mesh.size:
        raise ValueError(f'axis {axis} of {x.shape} does not split into {mesh.size} shards')
    per_host = mesh.shape[1]
    parts = np.split(x, mesh.size, axis=axis)[mesh.host * per_host:(mesh.host + 1) * per_host]
    return [_place(a, dev) for a, dev in zip(parts, mesh.local.devices)]


def shard_codes_2d(mesh: HybridMesh, codes_t: np.ndarray) -> List[torch.Tensor]:
    """Transposed PQ codes ``[M, N]`` with N split host-major over ``host x
    shard`` (N padded with zero codes to a multiple of the shard count)."""
    return put_sharded(mesh, _padded_codes(codes_t, mesh.size), 1)


def shard_mask_2d(mesh: HybridMesh, mask: np.ndarray, n_pad: int) -> List[torch.Tensor]:
    """An int8 row mask padded with 0 to ``n_pad`` rows, split host-major."""
    return put_sharded(mesh, padded_mask(mask, len(mask), n_pad), 0)


def replicate_2d(mesh: HybridMesh, x: np.ndarray) -> List[torch.Tensor]:
    return put_sharded(mesh, x, None)


def _all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """``t`` from every process, concatenated on axis 1 in rank order."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=1)


def sharded_adc_topk_2d(mesh: HybridMesh, dtable, codes_t, mask, k: int):
    """Masked ADC search over a host x shard mesh with a hierarchical merge:
    per shard K5 (`ops/adc.py` ``adc_scores``) and a top-k, the merge over
    this process's shards, an ``all_gather`` of the ``[Q, k]`` winners over
    the process group, and the global top-k, the same on every process.
    Global row ``(host * shards_per_host + shard) * local_n + i``; ties go to
    the lower row.  Returns ``(dists [Q, k], global_idx [Q, k])`` on this
    process's first shard device."""
    kk = min(k, codes_t[0].shape[1])
    d_h, i_h = sharded_adc_topk(mesh.local, dtable, codes_t, mask, kk,
                                first_shard=mesh.host * mesh.shape[1])
    d_all, i_all = _all_gather_cat(d_h), _all_gather_cat(i_h)
    vals, pos = topk(d_all, kk)
    return vals, torch.gather(i_all, 1, pos)


def sharded_lloyd_step_2d(mesh: HybridMesh, x_sharded, centroids):
    """Data-parallel Lloyd step over a host x shard mesh: the sums, counts
    and inertia of this process's shards, then ``all_reduce(SUM)`` over the
    process group.  Returns ``(new_centroids, inertia)`` on this process's
    first shard device, the same on every process."""
    import torch.distributed as dist

    sums, counts, inertia = _lloyd_stats(mesh.local, x_sharded, centroids)
    if dist.is_available() and dist.is_initialized():
        for t in (sums, counts, inertia):
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
    c0 = _per_shard(mesh.local, centroids)[0]
    return _centroid_update(counts, sums, c0.to(mesh.local.devices[0])), inertia
