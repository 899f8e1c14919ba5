"""The graph filter's masked exact scan: exact float32 distances of the rows
a predicate passes, and each query's ``k`` best.

A filtered graph search under a selective predicate (below
``filter_fallback_selectivity``) answers from this scan instead of the
traversal (`index/graph.py` ``_masked_exact_scan``, per shard in
``ShardedGraphIndex``).  Its plain version, :func:`_masked_scan_ref`, is
the port of the JAX function (`annlite_tpu/index/graph.py`
``_masked_exact_scan``): a float32 product over every row, failing rows
scored ``BIG``, a stable sort.  On the card one launch of ``masked_scan``
(`csrc/masked_scan.cu`) reads only the passing rows and keeps each query's
``k`` best per tile of rows, and a second merges the tiles' sorted lists;
no ``[Q, N]`` score is written and nothing is sorted but a run of 32 keys.
The wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises, and beyond the plan's ceiling
(:data:`MAX_K`) it runs the plain version's product and sort on the card by
that explicit shape test.
"""
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..math import dot_f32
from ..profile import count
from . import BIG, _ext
from .topk import topk

# the largest k the kernel's per-tile lists hold (8 slots a lane of a warp)
MAX_K = 256
QUERY_TILE = 64           # queries a CTA
ROW_CHUNK = 64            # passing rows scored at once; a tile is a multiple of it
TARGET_TILES = 256        # tiles of rows a query tile is cut into, at most about
MAX_KEYS = 16384          # keys a query's tiles hand to the merge (k each), at most
SMEM_LIMIT = 232448       # 227 KB: what a CTA of an H100 may use
# csrc/masked_scan.cu's shared memory beside the lists: the queries' bounds
# (8 bytes each), two buffers of a 32-dimension slice of the 64 queries and
# of 64 rows (rows of 36 floats), a chunk's dot products (64 x 68 floats),
# |q|^2 and |v|^2, the passing rows of a 4,096-row compaction step and a
# chunk, and the warps' counts
_FIXED_SMEM = (8 * 64 + 4 * (2 * 64 * 36 + 2 * 64 * 36 + 64 * 68 + 64 + 64)
               + 4 * (4096 + 64 + 8))


class MaskedScanPlan(NamedTuple):
    """Launch geometry of ``masked_scan``: ``tiles`` CTAs a query tile,
    each over ``tile`` rows of the mask, its lists of ``list_slots`` keys a
    query (k of them used); the merge, ``merge_warps`` warps a query.
    Shared memory in bytes a CTA."""
    tile: int
    tiles: int
    list_slots: int
    merge_warps: int
    scan_smem: int
    merge_smem: int


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=256)
def masked_scan_plan(n: int, nq: int, k: int) -> Optional[MaskedScanPlan]:
    """The plan of a masked scan of ``nq`` queries over a mask of ``n``
    rows for the ``k`` best, or None where the kernel does not take the
    shape: ``k`` outside 1 .. min(n, :data:`MAX_K`), ``n`` beyond 32-bit
    rows, or more query tiles than a grid's second dimension holds.  Rows
    are cut into about :data:`TARGET_TILES` tiles (multiples of
    :data:`ROW_CHUNK`), fewer where the tiles' ``(tiles + 1) * k`` keys
    would exceed :data:`MAX_KEYS`; the merge takes a warp for every tile up
    to 32.  Depends on shapes alone."""
    if not 1 <= k <= min(n, MAX_K) or n >= 2**31 or not 1 <= nq <= 65535 * QUERY_TILE:
        return None
    tile = max(ROW_CHUNK, _round_up(-(-n // TARGET_TILES), ROW_CHUNK))
    most = MAX_KEYS // k - 1
    if -(-n // tile) > most:
        tile = _round_up(-(-n // most), ROW_CHUNK)
    tiles = -(-n // tile)
    list_slots = max(32, _next_pow2(k))
    warps = min(32, _next_pow2(tiles))
    return MaskedScanPlan(tile, tiles, list_slots, warps,
                          8 * QUERY_TILE * list_slots + _FIXED_SMEM, 8 * warps * list_slots)


def masked_scan_info(list_slots: int, row_bytes: int = 4, vec: bool = True) -> dict:
    """Registers and spilled bytes a thread, and CTAs resident on an SM, of
    the scan instance with lists of ``list_slots`` keys over rows of
    ``row_bytes``-byte elements read in 16-byte loads (``vec``) or one
    element a load; the merge's registers.  Builds the kernels; needs a
    card."""
    out = (ctypes.c_int * 4)()
    _ext.check(_ext.library('masked_scan').annlite_masked_scan_info(
        list_slots, row_bytes, int(vec), out), 'masked_scan_info')
    return {'registers': out[0], 'spill_bytes': out[1], 'ctas_per_sm': out[2],
            'merge_registers': out[3]}


def _distances(q: torch.Tensor, v: torch.Tensor, euclid: bool) -> torch.Tensor:
    """``[Q, D] x [S, D] -> [Q, S]``: squared L2 through the product
    identity, or ``1 - dot``; float32 products without TF32."""
    dots = dot_f32(q, v)
    if euclid:
        return torch.sum(q * q, dim=1)[:, None] + torch.sum(v * v, dim=1)[None, :] - 2.0 * dots
    return 1.0 - dots


def _masked_scan_ref(vecs, q, mask, euclid: bool, limit: int):
    """Plain twin of ``masked_scan``: the exact scan over every row, failing
    rows scored BIG, a stable top-``limit`` (ties to the lower row)."""
    d = _distances(q, vecs[: mask.shape[0]].float(), euclid)
    d, ids = topk(torch.where(mask[None, :], d, BIG), limit)
    return d, ids.to(torch.int32)


def masked_scan_kernel(vecs, q, mask, euclid: bool, k: int):
    """Launch ``masked_scan`` and its merge (`csrc/masked_scan.cu`) ->
    ``(d [Q, k] float32, ids [Q, k] int32)`` as :func:`_masked_scan_ref`.
    ``vecs [N', D]`` float32 or bf16 (N' >= N: a capacity-padded buffer),
    ``q [Q, D]`` float32, ``mask [N]`` bool, all contiguous on one card; 1 <=
    k <= min(N, :data:`MAX_K`).  Raises beyond the plan
    (:func:`masked_scan_plan`)."""
    for t in (vecs, q, mask):
        if not t.is_cuda or not t.is_contiguous() or t.device != q.device:
            raise ValueError('masked_scan: expected contiguous CUDA tensors on one card')
    n = mask.shape[0] if mask.dim() == 1 else 0
    nq = q.shape[0]
    if (vecs.dtype not in (torch.float32, torch.bfloat16) or q.dtype != torch.float32
            or mask.dtype != torch.bool or mask.dim() != 1 or vecs.dim() != 2 or q.dim() != 2
            or vecs.shape[1] != q.shape[1] or vecs.shape[0] < n or q.shape[1] == 0):
        raise ValueError('masked_scan: unsupported inputs')
    plan = masked_scan_plan(n, nq, k)
    if plan is None:
        raise ValueError(f'masked_scan: k = {k} outside 1 .. min(N = {n}, {MAX_K}), '
                         f'or N = {n}, Q = {nq} beyond the plan')
    dev = q.device
    cand = nq * plan.tiles * k
    # scratch: the tiles' keys, the queries' bounds, then each tile's first k
    # failing rows and their count (int32)
    work = torch.empty(cand + nq + (plan.tiles * (k + 1) + 1) // 2, dtype=torch.int64,
                       device=dev)
    d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    bound = work.data_ptr() + 8 * cand
    fail_rows = bound + 8 * nq
    lib = _ext.library('masked_scan')
    with torch.cuda.device(dev):
        _ext.check(lib.annlite_masked_scan(
            vecs.data_ptr(), q.data_ptr(), mask.data_ptr(), work.data_ptr(), bound, fail_rows,
            fail_rows + 4 * plan.tiles * k, d.data_ptr(), ids.data_ptr(), n, q.shape[1], nq, k,
            vecs.element_size(), int(bool(euclid)), plan.tile, plan.tiles, plan.list_slots,
            plan.merge_warps, _ext.stream_ptr(q)), 'masked_scan')
    count('launch.masked_scan')
    count('launch.masked_scan_merge')
    return d, ids


def masked_scan(vecs, q, mask, euclid: bool, limit: int):
    """The ``min(limit, N)`` nearest rows of ``vecs`` under ``mask [N]``
    (bool; ``vecs`` may be longer) for each query, by (distance, row), a
    failing row scoring BIG: ``(d [Q, k] float32, ids [Q, k] int32)``.  On
    the CPU :func:`_masked_scan_ref`; on the card one ``masked_scan`` launch
    and its merge for every k up to :data:`MAX_K`, above it the plain
    version's product and sort on the card."""
    k = min(limit, mask.shape[0])
    if q.device.type == 'cpu' or masked_scan_plan(mask.shape[0], q.shape[0], k) is None:
        return _masked_scan_ref(vecs, q, mask, euclid, k)
    return masked_scan_kernel(vecs.contiguous(), q.float().contiguous(), mask.contiguous(),
                              euclid, k)
