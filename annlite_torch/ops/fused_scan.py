"""Fused quantized scan + in-kernel candidate selection — the port of
`annlite_tpu/ops/fused_scan.py`.

The int8 first-pass scan (`ops/scan.py`) would materialize a ``[Q, N]``
float32 score matrix that the top-k reduction reads straight back.  The fused
scan keeps only each block's *bucketed top-2*: for every (query, lane)
bucket of the ``block_rows/128`` strided rows of a block of ``block_rows``
corpus rows, the best two scores and their global rows.  'lane8' selection
then keeps a sorted top-8 per (query, lane class) over all blocks, which
leaves 1024 candidates per query.

Kernels (``csrc/fused_scan.cu``): ``block_top2`` (the block pass, K2 of the
JAX package) and ``lane8_merge`` (the running top-8, the rest of K1).  Beside
each sits its plain PyTorch version (``_fused_scan_ref``,
``_fused_scan8_ref``), which holds the JAX references' contract
(`annlite_tpu/ops/fused_scan.py:269-322`): the same scores bit for bit and
the same rows.  The wrappers take the plain version for CPU tensors only;
for CUDA tensors they launch the kernels or raise.
"""
from typing import Optional, Tuple

import torch

from ..enums import Metric
from ..math import dot_f32
from . import _ext

# the kernel stages a 16-query tile of int8 codes in 48 KB of shared memory
MAX_FUSED_DIM = 3072


def int8_dot(q8: torch.Tensor, x8: torch.Tensor) -> torch.Tensor:
    """Exact ``q8 @ x8.T`` of int8 codes, as int32 ``[Q, N]``.

    PyTorch has no int8 x int8 -> int32 product for these shapes on every
    device (on the CPU ``matmul`` of int8 returns int8 and wraps).  A float32
    product of int8 values is exact while every partial sum stays below
    2^24, i.e. over at most 1040 dimensions (1040 * 127^2 < 2^24), so the
    product is taken in float32 (without TF32, :func:`dot_f32`) over chunks
    of 1024 dimensions and the chunks are summed in int32."""
    acc = None
    for lo in range(0, q8.shape[1], 1024):
        part = dot_f32(q8[:, lo:lo + 1024], x8[:, lo:lo + 1024]).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


# --------------------------------------------------------------------------
# Plain versions (CPU path, and the card's reference in chip_smoke.py)
# --------------------------------------------------------------------------


def _fused_scan_ref(q8, qsc, x8, rs, bias, block_rows: int, coef: float):
    """Block pass: ``(s, r)`` float32/int32 ``[Q, N/block_rows*256]``; per
    block ``[mn1 (128 lanes) | mn2 (128 lanes)]``."""
    nq = q8.shape[0]
    n = x8.shape[0]
    nb = n // block_rows
    groups = block_rows // 128
    acc = int8_dot(q8, x8).float()
    sel = bias[None, :] + coef * ((acc * qsc[:, None]) * rs[None, :])
    s4 = sel.reshape(nq, nb, groups, 128)
    giota = torch.arange(groups, dtype=torch.int32, device=q8.device)[None, None, :, None]
    big_g = torch.tensor(groups, dtype=torch.int32, device=q8.device)
    mn1 = s4.amin(dim=2)
    g1 = torch.where(s4 <= mn1[:, :, None, :], giota, big_g).amin(dim=2)
    s4m = torch.where(giota == g1[:, :, None, :], float('inf'), s4)
    mn2 = s4m.amin(dim=2)
    g2 = torch.where(s4m <= mn2[:, :, None, :], giota, big_g).amin(dim=2)
    base = (torch.arange(nb, dtype=torch.int32, device=q8.device) * block_rows)[None, :, None]
    lane = torch.arange(128, dtype=torch.int32, device=q8.device)[None, None, :]
    r1 = base + g1 * 128 + lane
    r2 = base + torch.clamp_max(g2, groups - 1) * 128 + lane
    s = torch.cat([mn1, mn2], dim=-1).reshape(nq, nb * 256)
    r = torch.cat([r1, r2], dim=-1).reshape(nq, nb * 256)
    return s, r


def _fused_scan8_ref(q8, qsc, x8, rs, bias, block_rows: int, coef: float):
    """Deep select: the block pass, then :func:`_lane8_merge_ref`."""
    return _lane8_merge_ref(*_fused_scan_ref(q8, qsc, x8, rs, bias, block_rows, coef))


def _lane8_merge_ref(s, r):
    """The per-lane-class top-8 of a block pass's candidates (a stable sort:
    an earlier candidate wins a tie) -> ``[Q, 1024]`` with column
    ``128 * k + lane`` the k-th best."""
    nq, c = s.shape
    s3 = s.reshape(nq, c // 128, 128)
    r3 = r.reshape(nq, c // 128, 128)
    order = torch.argsort(s3, dim=1, stable=True)[:, :8]
    return (torch.gather(s3, 1, order).reshape(nq, 1024),
            torch.gather(r3, 1, order).reshape(nq, 1024))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_cuda(*ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f'expected CUDA tensors, got one on {t.device}')
        if not t.is_contiguous():
            raise ValueError('expected contiguous tensors')


def block_top2(q8, qsc, x8, rs, bias, block_rows: int, coef: float):
    """Launch ``block_top2`` (K2 / K1's block pass) -> ``(s, r)`` as
    :func:`_fused_scan_ref`."""
    _check_cuda(q8, qsc, x8, rs, bias)
    nq, d = q8.shape
    n = x8.shape[0]
    if (q8.dtype != torch.int8 or x8.dtype != torch.int8 or x8.shape[1] != d
            or d % 16 or d > MAX_FUSED_DIM or n % block_rows or block_rows % 128
            or n >= 2**31 or qsc.dtype != torch.float32
            or rs.dtype != torch.float32 or bias.dtype != torch.float32
            or qsc.shape != (nq,) or rs.shape != (n,) or bias.shape != (n,)):
        raise ValueError('block_top2: unsupported inputs')
    nb = n // block_rows
    s = torch.empty((nq, nb * 256), dtype=torch.float32, device=x8.device)
    r = torch.empty((nq, nb * 256), dtype=torch.int32, device=x8.device)
    lib = _ext.library('fused_scan')
    with torch.cuda.device(x8.device):
        _ext.check(lib.annlite_block_top2(
            q8.data_ptr(), qsc.data_ptr(), x8.data_ptr(), rs.data_ptr(),
            bias.data_ptr(), s.data_ptr(), r.data_ptr(), nq, n, d, block_rows,
            coef, _ext.stream_ptr(x8)), 'block_top2')
    block_top2.launches += 1
    return s, r


block_top2.launches = 0


def lane8_merge(s, r):
    """Launch ``lane8_merge`` (K1's running top-8) over a block pass's
    ``[Q, nb*256]`` candidates -> ``[Q, 1024]``."""
    _check_cuda(s, r)
    nq, c = s.shape
    if (s.dtype != torch.float32 or r.dtype != torch.int32 or r.shape != s.shape
            or c % 256):
        raise ValueError('lane8_merge: unsupported inputs')
    s8 = torch.empty((nq, 1024), dtype=torch.float32, device=s.device)
    r8 = torch.empty((nq, 1024), dtype=torch.int32, device=s.device)
    lib = _ext.library('fused_scan')
    with torch.cuda.device(s.device):
        _ext.check(lib.annlite_lane8_merge(
            s.data_ptr(), r.data_ptr(), s8.data_ptr(), r8.data_ptr(), nq,
            c // 256, _ext.stream_ptr(s)), 'lane8_merge')
    lane8_merge.launches += 1
    return s8, r8


lane8_merge.launches = 0


def _fused_scan(q8, qsc, x8, rs, bias, block_rows, coef, select):
    if x8.device.type == 'cpu':
        ref = _fused_scan8_ref if select == 'lane8' else _fused_scan_ref
        return ref(q8, qsc, x8, rs, bias, block_rows, coef)
    s, r = block_top2(q8, qsc, x8, rs, bias, block_rows, coef)
    if select == 'lane8':
        return lane8_merge(s, r)
    return s, r


# --------------------------------------------------------------------------
# Public wrapper
# --------------------------------------------------------------------------


def supports_fused_scan(n: int, d: int, q: int, block_rows: int = 8192) -> bool:
    """The fused kernel requires lane-aligned geometry; callers use the
    unfused scan otherwise.  The JAX rule, plus the kernel's dimension limit
    (:data:`MAX_FUSED_DIM`)."""
    return (
        n % block_rows == 0
        and d % 128 == 0
        and d <= MAX_FUSED_DIM
        and q <= 128
        and n // block_rows >= 1
    )


def fused_scan_candidates(
    q: torch.Tensor,
    x_scan: torch.Tensor,
    row_scale: Optional[torch.Tensor],
    bias: torch.Tensor,
    metric_val: int,
    *,
    block_rows: int = 8192,
    select: str = 'block2',
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the int8 corpus ``x_scan [N, D]`` (with ``row_scale``) against
    float32 queries ``q [Q, D]``; returns ``(scores[Q, C], rows[Q, C])``,
    scores finalized to the values the unfused scan produces (BIG-or-more for
    masked rows).

    ``select``: 'block2' emits the bucketed top-2 per block
    (C = N/block_rows*256); 'lane8' keeps a running top-8 per lane class
    (C = 1024, requires N >= 4*block_rows).

    ``bias`` is float32 [N]: ``BIG*(1-mask)`` for IP/cosine, ``norms_sq +
    BIG*(1-mask)`` for L2.  The |q|^2 term of L2 is added here, outside the
    kernel.  The JAX function pads Q to a multiple of 8; the port does not
    need to.  Its int4 and bf16 corpora are not ported yet (ROADMAP)."""
    from .scan import quantize_rows_int8_device

    if x_scan.dtype != torch.int8:
        raise NotImplementedError(
            f'fused scan of a {x_scan.dtype} corpus is not ported yet (ROADMAP '
            'queue 1: the int4 and bf16 variants of the fused scan)')
    n = x_scan.shape[0]
    if n % block_rows != 0:
        raise ValueError(
            f'fused scan requires N % {block_rows} == 0 (got N={n}); the '
            'library pads corpus buffers to chunk multiples (see '
            'index/buffer.py) — callers with odd N must use the unfused scan'
        )
    if select not in ('block2', 'lane8'):
        raise ValueError(f'unknown select: {select!r}')
    if select == 'lane8' and n < 4 * block_rows:
        raise ValueError('lane8 selection requires N >= 4*block_rows')
    q8, qsc = quantize_rows_int8_device(q)
    rs = row_scale
    if rs is None:
        rs = torch.ones((n,), dtype=torch.float32, device=x_scan.device)
    coef = -2.0 if metric_val == int(Metric.EUCLIDEAN) else -1.0
    s, r = _fused_scan(q8, qsc, x_scan, rs, bias, block_rows, coef, select)
    if metric_val == int(Metric.EUCLIDEAN):
        s = s + torch.sum(q * q, dim=1)[:, None]
    else:
        s = s + 1.0
    return s, r
