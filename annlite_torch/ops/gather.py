"""Gather-rerank: exact float32 shortlist distances — the port of
`annlite_tpu/ops/gather.py`.

The kernel (``csrc/gather.cu``, ``gather_rerank``) gives each (query,
candidate) pair one warp, which reads the candidate's float32 row straight
from device memory (every load issued before the first FMA) and reduces its
distance to the query; the gathered rows never reach device memory.
:func:`gather_plan` picks the warps per CTA so that the grid fills the
card.  Beside the kernel sits its plain PyTorch version,
``_gather_rerank_ref``, the JAX reference's contract
(`annlite_tpu/ops/gather.py:140-149`): L2 is ``sum((q - c)^2)``, inner
product and cosine ``1 - q.c``, out-of-range ids clamped.  The wrapper takes
the plain version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.
"""
import ctypes
from typing import NamedTuple

import torch

from ..enums import Metric
from ..profile import count
from . import _ext

# the dimensions the wrapper takes (csrc/gather.cu kMaxDim); the kernel holds
# no row in shared memory, above D = 1024 it loops over the row
MAX_GATHER_DIM = 12288
# warps (one (query, candidate) pair each) per CTA, at most; fewer while the
# grid would hold fewer CTAs than an H100 has SMs
MAX_WARPS = 8
TARGET_CTAS = 132


class GatherPlan(NamedTuple):
    """Launch of ``gather_rerank``: ``grid`` CTAs of ``warps`` warps; warp
    ``w`` of CTA ``b`` takes pair ``b * warps + w`` = query ``pair // R``,
    candidate ``pair % R``."""
    warps: int
    grid: int


def gather_plan(nq: int, r: int) -> GatherPlan:
    """The launch for ``nq`` queries of ``r`` candidates: :data:`MAX_WARPS`
    warps per CTA, halved while the grid would hold fewer than
    :data:`TARGET_CTAS` CTAs (Q = 1, R = 40 takes 40 CTAs of one warp)."""
    pairs = nq * r
    warps = MAX_WARPS
    while warps > 1 and -(-pairs // warps) < TARGET_CTAS:
        warps //= 2
    return GatherPlan(warps, -(-pairs // warps))


def gather_plan_pairs(plan: GatherPlan, nq: int, r: int):
    """The (query, candidate) pair of each warp, in ``blockIdx``, then warp
    order, as the kernel computes it; ``None`` for a warp past the end."""
    return [divmod(p, r) if p < nq * r else None
            for p in range(plan.grid * plan.warps)]


def _vec4(q, x_f32) -> bool:
    """float4 loads: D % 4 == 0 and both bases 16-byte aligned."""
    return q.shape[1] % 4 == 0 and q.data_ptr() % 16 == 0 and x_f32.data_ptr() % 16 == 0


def gather_info(d: int, vec4: bool = True) -> dict:
    """Registers and spilled bytes per thread of the instance that takes
    ``d`` dimensions (float4 or scalar loads).  Builds the kernels; needs a
    card."""
    out = (ctypes.c_int * 2)()
    _ext.check(_ext.library('gather').annlite_gather_info(d, int(vec4), out), 'gather_info')
    return {'registers': out[0], 'spill_bytes': out[1]}


def _gather_rerank_ref(q, x_f32, cand, metric_val: int):
    """Plain version: a row gather, then the distances in float32."""
    cvec = x_f32[torch.clamp(cand.long(), 0, x_f32.shape[0] - 1)]  # [Q, R, D]
    if metric_val == int(Metric.EUCLIDEAN):
        return torch.sum((q[:, None, :] - cvec) ** 2, dim=-1)
    return 1.0 - torch.einsum('qd,qrd->qr', q, cvec)


def supports_gather_rerank(n: int, d: int) -> bool:
    """The kernel takes any row count and up to :data:`MAX_GATHER_DIM`
    dimensions."""
    return n >= 1 and 1 <= d <= MAX_GATHER_DIM


def gather_rerank(q, x_f32, cand, metric_val: int):
    """Launch ``gather_rerank`` (K3) -> float32 ``[Q, R]``."""
    for t in (q, x_f32, cand):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError('gather_rerank: expected contiguous CUDA tensors')
    nq, d = q.shape
    n = x_f32.shape[0]
    r = cand.shape[1]
    if (q.dtype != torch.float32 or x_f32.dtype != torch.float32
            or cand.dtype != torch.int32 or x_f32.shape[1] != d
            or cand.shape[0] != nq or not supports_gather_rerank(n, d)):
        raise ValueError('gather_rerank: unsupported inputs')
    out = torch.empty((nq, r), dtype=torch.float32, device=q.device)
    lib = _ext.library('gather')
    with torch.cuda.device(q.device):
        _ext.check(lib.annlite_gather_rerank(
            q.data_ptr(), x_f32.data_ptr(), cand.data_ptr(), out.data_ptr(),
            nq, n, d, r, int(metric_val == int(Metric.EUCLIDEAN)), int(_vec4(q, x_f32)),
            gather_plan(nq, r).warps, _ext.stream_ptr(q)), 'gather_rerank')
    count('launch.gather_rerank')
    return out


def gather_rerank_dists(q, x_f32, cand, metric_val: int) -> torch.Tensor:
    """Exact float32 distances [Q, R] between ``q [Q, D]`` and the rows of
    ``x_f32 [N, D]`` selected by ``cand [Q, R]`` (out-of-range ids clamped —
    callers mask invalid slots themselves)."""
    if x_f32.device.type == 'cpu':
        return _gather_rerank_ref(q, x_f32, cand, metric_val)
    return gather_rerank(q.contiguous(), x_f32, cand.to(torch.int32).contiguous(),
                         metric_val)
