"""Gather-rerank: exact float32 shortlist distances — the port of
`annlite_tpu/ops/gather.py`.

The kernel (``csrc/gather.cu``, ``gather_rerank``) reads each candidate's
float32 row straight from device memory and reduces its distance to the
query; the gathered rows never reach device memory.  Beside it sits its plain
PyTorch version, ``_gather_rerank_ref``, the JAX reference's contract
(`annlite_tpu/ops/gather.py:140-149`): L2 is ``sum((q - c)^2)``, inner
product and cosine ``1 - q.c``, out-of-range ids clamped.  The wrapper takes
the plain version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.
"""
import torch

from ..enums import Metric
from . import _ext

# the kernel holds the query row in 48 KB of shared memory
MAX_GATHER_DIM = 12288


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
    vec4 = d % 4 == 0 and x_f32.data_ptr() % 16 == 0
    lib = _ext.library('gather')
    with torch.cuda.device(q.device):
        _ext.check(lib.annlite_gather_rerank(
            q.data_ptr(), x_f32.data_ptr(), cand.data_ptr(), out.data_ptr(),
            nq, n, d, r, int(metric_val == int(Metric.EUCLIDEAN)), int(vec4),
            _ext.stream_ptr(q)), 'gather_rerank')
    gather_rerank.launches += 1
    return out


gather_rerank.launches = 0


def gather_rerank_dists(q, x_f32, cand, metric_val: int) -> torch.Tensor:
    """Exact float32 distances [Q, R] between ``q [Q, D]`` and the rows of
    ``x_f32 [N, D]`` selected by ``cand [Q, R]`` (out-of-range ids clamped —
    callers mask invalid slots themselves)."""
    if x_f32.device.type == 'cpu':
        return _gather_rerank_ref(q, x_f32, cand, metric_val)
    return gather_rerank(q.contiguous(), x_f32, cand.to(torch.int32).contiguous(),
                         metric_val)
