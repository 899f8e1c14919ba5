"""ADC (asymmetric distance computation) scoring — the port of
`annlite_tpu/ops/adc.py`.

A query keeps an exact table ``dtable[q, m, c]`` of distances from its m-th
sub-vector to every codeword c, and a stored row with PQ codes
``codes_t[:, n]`` (transposed ``[M, N]``, so the N axis is contiguous) scores
``sum_m dtable[q, m, codes_t[m, n]]``.  The filter/delete predicate is a
per-row int8 mask fused into the scan (BIG where it is 0).

Kernels (``csrc/adc.cu``): ``adc_scores`` (K5, the full ``[Q, N]`` scores)
and ``adc_block_top2`` (K4's block pass: per block of ``block_n`` rows the
bucketed top-2 of `ops/fused_scan.py`), which ``lane8_merge`` finishes into a
running top-8 per lane class.  Beside each sits its plain PyTorch version
(``_adc_scores_ref``, ``_adc_block_top2_ref``), which sums over m in order
0..M-1 in float32 as the kernels do: scores and rows are bit-equal.  The TPU
kernels' one-hot products with a bf16 table are not carried over; the port
computes what the JAX references (``adc_scores_ref``) compute, in float32.
The wrappers take the plain version for CPU tensors only; for CUDA tensors
they launch the kernels or raise.
"""
from typing import Optional

import torch

from . import BIG, _ext
from .fused_scan import _bucket_top2, _lane8_merge_ref, lane8_merge
from .topk import topk

# one subspace of one query's float32 table must fit in the 227 KB of shared
# memory a CUDA block may use (the kernel tiles the table over subspaces)
MAX_ADC_CLUSTERS = 232448 // 4
# rows per block of the deep select at K <= 256 (its bucketed top-2 is taken
# per block, so this sets the candidates, as in the JAX package)
BLOCK_N = 4096


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _scale_blocks(k: int) -> int:
    """The deep select's block of rows for ``k`` codewords: ``BLOCK_N``,
    shrunk for K > 256 (u16 codes) as the JAX package shrinks it."""
    if k <= 256:
        return BLOCK_N
    return max(512, BLOCK_N // -(-k // 256))


def _code_bytes(codes: torch.Tensor) -> int:
    if codes.dtype == torch.uint8:
        return 1
    if codes.dtype == torch.uint16:
        return 2
    raise ValueError(f'ADC kernels take uint8 or uint16 codes, got {codes.dtype}')


def supports_adc(k: int) -> bool:
    """Whether the kernels take ``k`` codewords per subspace."""
    return 1 <= k <= MAX_ADC_CLUSTERS


# --------------------------------------------------------------------------
# Plain versions (CPU path, and the card's reference in chip_smoke.py)
# --------------------------------------------------------------------------


def adc_scores_ref(dtable: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """``dtable [Q, M, K] x codes_t [M, N] -> [Q, N]`` float32, summed over m
    in order 0..M-1 (the kernels' order).  Codes are widened to int64 first:
    PyTorch's uint16 is a storage type without arithmetic or indexing."""
    codes = codes_t.to(torch.int32).long()
    q, m, _ = dtable.shape
    acc = torch.zeros((q, codes.shape[1]), dtype=torch.float32, device=dtable.device)
    for j in range(m):
        acc = acc + dtable[:, j, :].float()[:, codes[j]]
    return acc


def _masked(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return scores
    return torch.where(mask[None, :] > 0, scores,
                       torch.tensor(BIG, dtype=torch.float32, device=scores.device))


def _adc_scores_ref(dtable, codes_t, mask):
    """Plain version of ``adc_scores``: BIG where ``mask`` is 0."""
    return _masked(adc_scores_ref(dtable, codes_t), mask)


def _adc_block_top2_ref(dtable, codes_t, mask, block_n: int):
    """Plain version of ``adc_block_top2``: ``(s, r)`` float32/int32
    ``[Q, N/block_n*256]`` (see `ops/fused_scan.py` ``_bucket_top2``)."""
    return _bucket_top2(_adc_scores_ref(dtable, codes_t, mask), block_n)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check(what, dtable, codes_t, mask):
    for t in (dtable, codes_t, mask):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f'{what}: expected contiguous CUDA tensors')
    q, m, k = dtable.shape
    if (dtable.dtype != torch.float32 or codes_t.dim() != 2 or codes_t.shape[0] != m
            or mask.dtype != torch.int8 or mask.shape != (codes_t.shape[1],)
            or codes_t.shape[1] >= 2**31):
        raise ValueError(f'{what}: unsupported inputs')
    if not supports_adc(k):
        raise ValueError(f'{what}: K = {k} codewords exceed the kernel limit '
                         f'K <= {MAX_ADC_CLUSTERS}')
    return q, m, k, codes_t.shape[1], _code_bytes(codes_t)


def adc_scores_kernel(dtable, codes_t, mask):
    """Launch ``adc_scores`` (K5) -> float32 ``[Q, N]``, BIG where ``mask``
    is 0."""
    q, m, k, n, cb = _check('adc_scores', dtable, codes_t, mask)
    out = torch.empty((q, n), dtype=torch.float32, device=dtable.device)
    lib = _ext.library('adc')
    with torch.cuda.device(dtable.device):
        _ext.check(lib.annlite_adc_scores(
            dtable.data_ptr(), codes_t.data_ptr(), mask.data_ptr(), out.data_ptr(),
            q, m, k, n, n, cb, _ext.stream_ptr(dtable)), 'adc_scores')
    adc_scores_kernel.launches += 1
    return out


adc_scores_kernel.launches = 0


def adc_block_top2(dtable, codes_t, mask, block_n: int):
    """Launch ``adc_block_top2`` (K4's block pass) -> ``(s, r)`` as
    :func:`_adc_block_top2_ref`."""
    q, m, k, n, cb = _check('adc_block_top2', dtable, codes_t, mask)
    if block_n % 128 or n % block_n or n < block_n:
        raise ValueError('adc_block_top2: N must be a multiple of block_n, '
                         'itself a multiple of 128')
    nb = n // block_n
    s = torch.empty((q, nb * 256), dtype=torch.float32, device=dtable.device)
    r = torch.empty((q, nb * 256), dtype=torch.int32, device=dtable.device)
    lib = _ext.library('adc')
    with torch.cuda.device(dtable.device):
        _ext.check(lib.annlite_adc_block_top2(
            dtable.data_ptr(), codes_t.data_ptr(), mask.data_ptr(), s.data_ptr(),
            r.data_ptr(), q, m, k, n, n, block_n, cb, _ext.stream_ptr(dtable)),
            'adc_block_top2')
    adc_block_top2.launches += 1
    return s, r


adc_block_top2.launches = 0


def _mask_row(mask: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    if mask is None:
        return torch.ones((n,), dtype=torch.int8, device=device)
    return mask.to(device=device, dtype=torch.int8).contiguous()


def _adc_select8(dtable, codes_t, mask, block_n: int):
    """K4: block pass + running top-8 per lane class -> ``[Q, 1024]``."""
    if codes_t.device.type == 'cpu':
        return _lane8_merge_ref(*_adc_block_top2_ref(dtable, codes_t, mask, block_n))
    return lane8_merge(*adc_block_top2(dtable.float().contiguous(),
                                       codes_t.contiguous(), mask, block_n))


# --------------------------------------------------------------------------
# Public functions
# --------------------------------------------------------------------------


def adc_scores(
    dtable: torch.Tensor,
    codes_t: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked ADC scores ``[Q, N]`` from ``dtable [Q, M, K]`` and transposed
    codes ``[M, N]`` (mask-failing rows score BIG).  The JAX function pads Q
    and N to its blocks; the kernel needs no padding."""
    if codes_t.device.type == 'cpu':
        return _adc_scores_ref(dtable, codes_t, mask)
    n = codes_t.shape[1]
    return adc_scores_kernel(dtable.float().contiguous(), codes_t.contiguous(),
                             _mask_row(mask, n, codes_t.device))


def adc_topk(
    dtable: torch.Tensor,
    codes_t: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    *,
    exact: bool = False,
    deep: Optional[bool] = None,
):
    """Score + top-k: ``(dists [Q, k], rows [Q, k] int32)`` ascending.

    The JAX package's dispatch: the deep select (K4, ``[Q, 1024]``
    candidates) when ``not exact and k <= 1024 and N % block_n == 0 and
    N >= 4 * block_n`` (``block_n`` from :func:`_scale_blocks`), otherwise
    the full scores (K5) and an exact top-k.  ``deep=None`` takes the deep select for a CUDA corpus, as the JAX package
    takes it on the TPU (``use_pallas``); ``deep=True`` runs its plain
    version on the CPU.  The final top-k keeps ``lax.top_k``'s tie rule
    (lower index first: a stable sort)."""
    n = codes_t.shape[1]
    block_n = _scale_blocks(dtable.shape[2])
    if deep is None:
        deep = codes_t.is_cuda
    if deep and not exact and k <= 1024 and n % block_n == 0 and n >= 4 * block_n:
        s, r = _adc_select8(dtable, codes_t, _mask_row(mask, n, codes_t.device),
                            block_n)
        d, pos = topk(s, min(k, 1024))
        return d, torch.gather(r, 1, pos)
    d, pos = topk(adc_scores(dtable, codes_t, mask), k)
    return d, pos.to(torch.int32)
