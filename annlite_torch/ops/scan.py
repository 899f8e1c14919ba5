"""Quantized exact-rerank flat scan — the port of `annlite_tpu/ops/scan.py`.

Pipeline: a quantized first-pass scan over all rows -> top-R shortlist ->
exact float32 distances of the shortlist's rows -> top-k.  Returned
distances are exact float32 (the rerank recomputes them), so quantization
can only cost recall when a true top-k item falls outside the top-R
shortlist.

The scan copy is int8 (the default), nibble-packed int4 (half the bytes of
int8) or bfloat16 (no quantization scales).  int8 and int4 rows carry a
per-row symmetric scale (max|row|/127, max|row|/7) applied after the
integer product; a row scale never reorders within a row and the rerank
fixes cross-row ordering.

On a CUDA corpus whose geometry allows it, ``scan_topk`` runs the fused
kernels (`ops/fused_scan.py`) and the gather-rerank kernel (`ops/gather.py`);
everywhere else it runs the unfused scan, as the JAX package does off the
TPU.
"""
from typing import Optional, Tuple

import numpy as np
import torch

from ..enums import Metric
from . import BIG
from .fused_scan import scan_dots
from .topk import topk


def quantize_rows_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization (host side, at ingest time).

    Returns ``(codes int8 [N, D], scale f32 [N])`` with
    ``x ~= codes * scale[:, None]``; bit for bit the JAX package's."""
    x = np.asarray(x, dtype=np.float32)
    scale = np.maximum(np.max(np.abs(x), axis=-1), 1e-30) / 127.0
    codes = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
    return codes, scale.astype(np.float32)


def quantize_rows_int8_device(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side per-row int8 quantization (same contract as
    :func:`quantize_rows_int8`), bit for bit the JAX package's
    ``quantize_rows_int8_jax``: XLA compiles its division by the constant
    127 into a product with the float32 reciprocal, so the port does the
    same.  ``torch.round`` rounds half to even like ``jnp.round``."""
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=-1), 1e-30) * (1.0 / 127.0)
    codes = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def quantize_rows_int4(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int4 quantization, two values packed per byte (host
    side, at ingest time); bit for bit the JAX package's.

    Returns ``(packed int8 [N, D/2], scale f32 [N])``: byte ``j`` holds dim
    ``j`` in its low nibble and dim ``j + D/2`` in its high nibble, so
    unpacking yields two contiguous half-width planes.  Codes are in
    [-7, 7] with ``x ~= codes * scale[:, None]``."""
    x = np.asarray(x, dtype=np.float32)
    d = x.shape[-1]
    if d % 2:
        raise ValueError('int4 packing requires even dim')
    scale = np.maximum(np.max(np.abs(x), axis=-1), 1e-30) / 7.0
    c = np.clip(np.rint(x / scale[..., None]), -7, 7).astype(np.int32)
    lo, hi = c[..., : d // 2], c[..., d // 2:]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8)
    return packed.view(np.int8), scale.astype(np.float32)


def quantize_rows_int4_device(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side :func:`quantize_rows_int4`, bit for bit the JAX package's
    ``quantize_rows_int4_jax``: as for 127, XLA compiles its division by 7
    into a product with the float32 reciprocal, which differs from the host
    version's division in the last bit of about half the scales."""
    d = x.shape[-1]
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=-1), 1e-30) * (1.0 / 7.0)
    c = torch.clamp(torch.round(x / scale[..., None]), -7, 7).to(torch.int32)
    lo, hi = c[..., : d // 2], c[..., d // 2:]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)
    return packed.view(torch.int8), scale


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed int8 ``[..., D/2]`` -> ``(lo, hi)`` int8, the sign-extended
    low and high nibbles (dims ``[0, D/2)`` and ``[D/2, D)``)."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return lo.to(torch.int8), hi.to(torch.int8)


def _approx_scores(q, x_scan, row_scale, norms_sq, metric_val: int,
                   packed_int4: bool = False):
    """First-pass scores [Q, N] from the quantized corpus (int8 or packed
    int4 with ``row_scale``, or bfloat16).  Rank-faithful up to quantization
    noise; NOT returned to callers."""
    if x_scan.dtype == torch.bfloat16:
        dots = scan_dots(q.to(torch.bfloat16), x_scan)
    else:
        q8, q_scale = quantize_rows_int8_device(q)
        dots = scan_dots(q8, x_scan, packed_int4) * (
            q_scale[:, None] * row_scale[None, :])
    if metric_val == int(Metric.EUCLIDEAN):
        return torch.sum(q * q, dim=1)[:, None] + norms_sq[None, :] - 2.0 * dots
    return 1.0 - dots


def _exact_rerank(q, x_f32, cand, cand_masked, metric_val: int, k: int):
    """Exact float32 distances for the shortlist; returns (dists[Q,k],
    ids[Q,k]).  ``cand_masked`` marks shortlist slots that were masked or
    padding: they score BIG so they can never displace an alive candidate."""
    from .gather import gather_rerank_dists

    d = gather_rerank_dists(q, x_f32, cand, metric_val)
    # masked_fill takes BIG as a scalar: no copy from the host
    d = d.masked_fill(cand_masked, BIG)
    vals, pos = topk(d, k)
    return vals, torch.gather(cand, 1, pos)


def _scan_rerank_topk(q, x_scan, row_scale, norms_sq, mask, k: int,
                      rerank: int, metric_val: int, x_f32=None,
                      packed_int4: bool = False):
    scores = _approx_scores(q, x_scan, row_scale, norms_sq, metric_val,
                            packed_int4)
    scores = scores.masked_fill(mask[None, :] <= 0, BIG)
    if x_f32 is None:
        d, rows = topk(scores, k)
        return d, rows.to(torch.int32)
    cand_s, cand = topk(scores, rerank)
    return _exact_rerank(q, x_f32, cand.to(torch.int32), cand_s >= BIG,
                         metric_val, k)


def _fused_scan_rerank_topk(q, x_scan, row_scale, norms_sq, mask, k: int,
                            rerank: int, metric_val: int, x_f32=None,
                            packed_int4: bool = False):
    """Fused variant: candidate selection happens inside the scan kernel, so
    the [Q, N] score matrix never reaches device memory.  At N >= 4*8192 the
    kernels also finish the first-pass top-k themselves ('lane8' -> 1024
    candidates), leaving a sort of [Q, 1024]."""
    from .fused_scan import fused_scan_candidates

    bias = torch.where(mask > 0, 0.0, BIG).to(torch.float32)
    if metric_val == int(Metric.EUCLIDEAN):
        bias = bias + norms_sq
    n = x_scan.shape[0]
    deep = n >= 4 * 8192 and max(k, rerank) <= 1024
    cs, cr = fused_scan_candidates(q, x_scan, row_scale, bias, metric_val,
                                   packed_int4=packed_int4,
                                   select='lane8' if deep else 'block2')
    if x_f32 is None:
        d, pos = topk(cs, k)
        return d, torch.gather(cr, 1, pos)
    cand_s, pos = topk(cs, rerank)
    cand = torch.gather(cr, 1, pos)
    return _exact_rerank(q, x_f32, cand, cand_s >= BIG, metric_val, k)


def scan_topk(
    q: torch.Tensor,
    x_scan: torch.Tensor,
    row_scale: Optional[torch.Tensor],
    norms_sq: Optional[torch.Tensor],
    mask: torch.Tensor,
    k: int,
    metric: Metric,
    x_f32: Optional[torch.Tensor] = None,
    rerank: Optional[int] = None,
    fused: Optional[bool] = None,
    packed_int4: bool = False,
):
    """Quantized scan + exact rerank.  ``x_scan`` is int8 (with
    ``row_scale``), bfloat16, or nibble-packed int4 (``packed_int4=True``,
    see :func:`quantize_rows_int4`); ``x_f32`` enables the exact rerank pass
    (skip it to get the raw quantized ranking).  ``norms_sq`` (exact float32
    ``|x|^2``) is required for EUCLIDEAN.  All tensors lie on one device.

    ``fused=None`` selects the fused kernels for a CUDA corpus when the
    geometry allows (`ops/fused_scan.py`).  Returns int32 rows."""
    from .fused_scan import supports_fused_scan

    if x_scan.dtype not in (torch.int8, torch.bfloat16) or (
            packed_int4 and x_scan.dtype != torch.int8):
        raise ValueError(f'unsupported scan corpus: {x_scan.dtype}'
                         f'{" (packed int4)" if packed_int4 else ""}')
    n = x_scan.shape[0]
    d_logical = x_scan.shape[1] * (2 if packed_int4 else 1)
    if rerank is None:
        # int4 ranks more noisily: the JAX package's deeper shortlist
        rerank = max(4 * k, 128 if packed_int4 else 32)
    rerank = min(rerank, n)
    if row_scale is None:
        row_scale = torch.ones((n,), dtype=torch.float32, device=x_scan.device)
    if norms_sq is None:
        norms_sq = torch.zeros((n,), dtype=torch.float32, device=x_scan.device)
    if fused is None:
        # n//32 = candidate-set size the block pass emits (top-2 per
        # 128-lane bucket, blocks of 8192): the shortlist must fit inside it
        fused = (
            x_scan.is_cuda
            and supports_fused_scan(n, d_logical, q.shape[0],
                                    packed_int4=packed_int4)
            and max(k, rerank) <= n // 32
        )
    impl = _fused_scan_rerank_topk if fused else _scan_rerank_topk
    return impl(q, x_scan, row_scale, norms_sq, mask, k, rerank, int(metric),
                x_f32, packed_int4)
