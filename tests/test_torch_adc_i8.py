"""annlite_torch.ops.adc_i8 against annlite_tpu.ops.adc_i8.

The int8 table and scales must equal the JAX ``quantize_dtable``'s bit for
bit (XLA turns the divisions by 127 into products with the float32
reciprocal); the offsets within an ulp.  The scores are held against a
numpy emulation of the TPU kernel's integer arithmetic (the pattern of
tests/test_adc.py): the JAX package's own CPU path returns the exact float
scores instead, so against it the port is held within the table's rounding
(1% of the largest score, as the JAX package's test)."""
import numpy as np
import pytest
import torch

from annlite_torch.ops import adc as tadc
from annlite_torch.ops import adc_i8 as ti8
from annlite_tpu.ops import adc as jadc
from annlite_tpu.ops import adc_i8 as ji8

BIG = np.float32(3.4e38)


def _inputs(q, m, k, n, code_dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    dt = (np.abs(rng.normal(size=(q, m, k))) * 3).astype(np.float32)
    codes_t = rng.integers(0, k, (m, n)).astype(code_dtype)
    return dt, codes_t


@pytest.mark.parametrize('q,m,k', [(200, 16, 32), (5, 64, 256), (3, 8, 1024)])
def test_quantize_dtable_equals_jax(q, m, k):
    dt, _ = _inputs(q, m, k, 1)
    want = [np.asarray(a) for a in ji8.quantize_dtable(dt)]
    got = [a.numpy() for a in ti8.quantize_dtable(torch.from_numpy(dt))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the offsets: summed in order here, in blocks of 32 by XLA (rtol 1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    if m <= 32:
        np.testing.assert_array_equal(got[2], want[2])


def _emulate(dt, codes_t, mask):
    """The TPU kernel's arithmetic in numpy: int table, integer sum, then
    ``acc * scale + offset`` in float32 with a rounding after each step.
    (M <= 32 here, where both packages' offsets are equal.)"""
    t8, scale, offset = (np.asarray(a) for a in ji8.quantize_dtable(dt))
    acc = np.zeros((dt.shape[0], codes_t.shape[1]), np.int64)
    for j in range(dt.shape[1]):
        acc += t8[:, j, codes_t[j].astype(np.int64)]
    s = acc.astype(np.float32) * scale + offset
    return s if mask is None else np.where(mask[None, :] > 0, s, BIG)


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('code_dtype,k', [(np.uint8, 32), (np.uint16, 300)])
def test_scores_equal_integer_emulation(code_dtype, k, masked):
    q, m, n = 4, 16, 700
    dt, codes_t = _inputs(q, m, k, n, code_dtype)
    mask = (np.random.default_rng(1).random(n) < 0.6).astype(np.int8) if masked else None
    got = ti8.adc_scores_i8(torch.from_numpy(dt), torch.from_numpy(codes_t),
                            None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, _emulate(dt, codes_t, mask))
    # within the table's rounding of the exact scores, which the JAX
    # package's CPU path returns
    exact = np.asarray(ji8.adc_scores_i8(dt, codes_t, mask, use_pallas=False))
    keep = np.ones(n, bool) if mask is None else mask > 0
    np.testing.assert_array_equal(got[:, ~keep], exact[:, ~keep])
    assert np.abs(got[:, keep] - exact[:, keep]).max() / np.abs(exact[:, keep]).max() < 0.01
    np.testing.assert_allclose(exact, np.asarray(jadc.adc_scores(dt, codes_t, mask,
                                                                 use_pallas=False)))


def test_plain_version_takes_quantized_inputs():
    dt, codes_t = _inputs(3, 8, 16, 200)
    t8, scale, offset = ti8.quantize_dtable(torch.from_numpy(dt))
    mask = torch.ones(200, dtype=torch.int8)
    got = ti8._adc_scores_i8_ref(t8, torch.from_numpy(codes_t), mask, scale[:, 0], offset[:, 0])
    np.testing.assert_array_equal(got.numpy(), _emulate(dt, codes_t, None))


def test_kernel_wrappers_take_only_cuda_tensors():
    """On the CPU the public functions run the plain versions; the kernel
    wrappers themselves refuse CPU tensors instead of falling back."""
    dt, codes_t = _inputs(2, 8, 16, 64)
    t8, scale, offset = ti8.quantize_dtable(torch.from_numpy(dt))
    with pytest.raises(ValueError, match='CUDA'):
        ti8.adc_i8_kernel(t8, torch.from_numpy(codes_t), torch.ones(64, dtype=torch.int8),
                          scale[:, 0], offset[:, 0])
    ids = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA'):
        tadc.lut_pq_kernel(ids, torch.from_numpy(codes_t.T.copy()), torch.from_numpy(dt))
