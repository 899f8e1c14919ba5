"""ADC scoring with an int8 table — the port of `annlite_tpu/ops/adc_i8.py`.

An experimental variant of `ops/adc.py` on no index path: its entry point is
:func:`adc_scores_i8`.  :func:`quantize_dtable` turns a float32 table into
int8 without reordering any query's scores: each (q, m) row is centred on
``mid = (min_k + max_k) / 2`` (the removed constants sum to a per-query
``offset``), and each query gets one symmetric scale ``max|centred| / 127``.
A score is then ``float(sum_m t8[q, m, code]) * scale[q] + offset[q]``; the
only error is the rounding of each table entry (at most scale / 2).

Kernel (``csrc/adc_i8.cu``, K9): one query's int8 table in shared memory, an
int32 sum (exact, in any order), and the epilogue ``acc * scale + offset``
with one rounding after each operation; BIG where the mask is 0.  Its plain
version ``_adc_scores_i8_ref`` computes the same, bit for bit.

Difference from the JAX package: off the TPU ``adc_scores_i8`` there skips
the quantization and returns the exact float32 scores of ``adc_scores_ref``.
Here the plain version computes what the TPU kernel computes (quantized
table, integer sum, scale and offset), so the CPU and the card give the same
scores, within the table's rounding of the exact ones.

XLA compiles the divisions by the constant 127 into a product with the
float32 reciprocal; the port does the same, so the int8 table and the scales
equal the JAX function's.  The offsets are summed over m in order 0..M-1;
XLA sums blocks of 32 subspaces, so above M = 32 an offset may differ from
the JAX function's in its last bit.
"""
from typing import Optional, Tuple

import torch

from . import BIG, _ext
from .adc import _code_bytes, _mask_row, _widen

# one subspace of one query's int8 table must fit in the 227 KB of shared
# memory a CUDA block may use (the kernel tiles the table over subspaces)
MAX_I8_CLUSTERS = 232448


def quantize_dtable(dtable: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 ``[Q, M, K]`` -> (int8 table ``[Q, M, K]``, per-query scale
    ``[Q, 1]``, offset ``[Q, 1]``, the mids summed over m in order)."""
    dtable = dtable.float()
    mid = (torch.amin(dtable, dim=2, keepdim=True)
           + torch.amax(dtable, dim=2, keepdim=True)) * 0.5  # [Q, M, 1]
    centred = dtable - mid
    scale = torch.clamp_min(torch.amax(torch.abs(centred), dim=(1, 2)), 1e-30) * (1.0 / 127.0)
    t8 = torch.clamp(torch.round(centred / scale[:, None, None]), -127, 127).to(torch.int8)
    offset = torch.zeros(dtable.shape[0], dtype=torch.float32, device=dtable.device)
    for j in range(dtable.shape[1]):
        offset = offset + mid[:, j, 0]
    return t8, scale[:, None], offset[:, None]


def _adc_scores_i8_ref(t8, codes_t, mask, scale, offset):
    """Plain version of K9: ``t8 [Q, M, K]`` int8, ``codes_t [M, N]``,
    ``mask [N]`` int8, ``scale``/``offset`` float32 ``[Q]`` -> float32
    ``[Q, N]``."""
    codes = _widen(codes_t)
    q, m, _ = t8.shape
    acc = torch.zeros((q, codes.shape[1]), dtype=torch.int32, device=t8.device)
    for j in range(m):
        acc = acc + t8[:, j, :].to(torch.int32)[:, codes[j]]
    scores = acc.float() * scale[:, None] + offset[:, None]
    return torch.where(mask[None, :] > 0, scores, BIG)


def adc_i8_kernel(t8, codes_t, mask, scale, offset):
    """Launch ``adc_i8_scores`` (K9) -> float32 ``[Q, N]`` as
    :func:`_adc_scores_i8_ref`."""
    for t in (t8, codes_t, mask, scale, offset):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError('adc_scores_i8: expected contiguous CUDA tensors')
    q, m, k = t8.shape
    n = codes_t.shape[1] if codes_t.dim() == 2 else 0
    if (t8.dtype != torch.int8 or codes_t.dim() != 2 or codes_t.shape[0] != m
            or mask.dtype != torch.int8 or mask.shape != (n,) or n >= 2**31
            or scale.dtype != torch.float32 or offset.dtype != torch.float32
            or scale.shape != (q,) or offset.shape != (q,) or q > 65535):
        raise ValueError('adc_scores_i8: unsupported inputs')
    if k > MAX_I8_CLUSTERS:
        raise ValueError(f'adc_scores_i8: K = {k} codewords exceed the kernel limit '
                         f'K <= {MAX_I8_CLUSTERS}')
    out = torch.empty((q, n), dtype=torch.float32, device=t8.device)
    if q == 0 or n == 0:
        return out
    lib = _ext.library('adc_i8')
    with torch.cuda.device(t8.device):
        _ext.check(lib.annlite_adc_i8_scores(
            t8.data_ptr(), codes_t.data_ptr(), mask.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), out.data_ptr(), q, m, k, n, _code_bytes(codes_t),
            _ext.stream_ptr(t8)), 'adc_scores_i8')
    adc_i8_kernel.launches += 1
    return out


adc_i8_kernel.launches = 0


def adc_scores_i8(
    dtable: torch.Tensor,
    codes_t: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked ADC scores ``[Q, N]`` through an int8 table; the contract of
    `ops/adc.py` ``adc_scores`` (float32 ``dtable [Q, M, K]`` and transposed
    codes ``[M, N]`` in, float32 scores out, BIG where ``mask`` is 0).  The
    JAX function pads Q and N to its blocks; the kernel needs no padding."""
    t8, scale, offset = quantize_dtable(dtable)
    mask_row = _mask_row(mask, codes_t.shape[1], codes_t.device)
    if codes_t.device.type == 'cpu':
        return _adc_scores_i8_ref(t8, codes_t, mask_row, scale[:, 0], offset[:, 0])
    return adc_i8_kernel(t8.contiguous(), codes_t.contiguous(), mask_row,
                         scale[:, 0].contiguous(), offset[:, 0].contiguous())
