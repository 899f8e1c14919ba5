"""annlite_torch's FlatIndex and DeviceBuffer against annlite_tpu's on
identical numpy inputs (the port on device='cpu', JAX on the CPU)."""
import numpy as np
import pytest
import torch

from annlite_torch.convert import flat_index_from_jax_state
from annlite_torch.enums import ExpandMode as TExpandMode
from annlite_torch.index.buffer import DeviceBuffer as TBuffer
from annlite_torch.index.flat import FlatIndex as TFlat
from annlite_tpu.enums import ExpandMode, Metric
from annlite_tpu.index.buffer import DeviceBuffer as JBuffer
from annlite_tpu.index.flat import FlatIndex as JFlat
from torch_parity import assert_topk_close

D = 64


def _data(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    q = x[:6] + 0.05 * rng.standard_normal((6, D)).astype(np.float32)
    return x, q


def _pair(metric, scan_mode, x):
    t = TFlat(D, metric=metric.name.lower(), scan_mode=scan_mode, device='cpu')
    j = JFlat(D, metric=metric, scan_mode=scan_mode)
    ids = np.arange(len(x))
    t.add_with_ids(x, ids)
    j.add_with_ids(x, ids)
    return t, j


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('scan_mode', ['int8', 'int4', 'bf16', 'exact'])
@pytest.mark.parametrize('metric', list(Metric))
def test_flat_search_equal_jax(metric, scan_mode, masked):
    x, q = _data()
    t, j = _pair(metric, scan_mode, x)
    mask = None
    if masked:
        mask = np.random.default_rng(1).random(len(x)) < 0.3
        mask[:6] = True
    td, ti = t.search(q, limit=10, mask=mask)
    jd, ji = j.search(q, limit=10, mask=mask)
    assert_topk_close(td, ti, jd, ji)
    if masked:
        assert mask[ti].all()
    # the device searcher is the same search
    sd, si = t.device_searcher(limit=10, mask=mask)(torch.from_numpy(q))
    np.testing.assert_array_equal(sd.numpy(), td)
    np.testing.assert_array_equal(si.numpy(), ti)


def test_flat_update_and_reset_equal_jax():
    x, q = _data()
    t, j = _pair(Metric.EUCLIDEAN, 'int8', x)
    rows = np.arange(100, 200)
    new = np.random.default_rng(2).standard_normal((100, D)).astype(np.float32)
    t.update_with_ids(new, rows)
    j.update_with_ids(new, rows)
    assert t.size == j.size == len(x)
    td, ti = t.search(new[:5], limit=5)
    jd, ji = j.search(new[:5], limit=5)
    assert_topk_close(td, ti, jd, ji)
    assert list(ti[:, 0]) == list(rows[:5])
    t.reset()
    assert t.size == 0
    t.add_with_ids(x[:10], np.arange(10))
    assert t.search(x[:3], limit=1)[1][:, 0].tolist() == [0, 1, 2]


def test_limit_larger_than_size():
    x, _ = _data(n=7)
    t, j = _pair(Metric.COSINE, 'int8', x)
    td, ti = t.search(x[:2], limit=10)
    jd, ji = j.search(x[:2], limit=10)
    assert td.shape == (2, 7)
    assert_topk_close(td, ti, jd, ji)


def test_flat_index_from_jax_state():
    x, q = _data()
    _, j = _pair(Metric.COSINE, 'int8', x)
    t = flat_index_from_jax_state(j.state_arrays(), metric='cosine', device='cpu')
    assert t.size == j.size
    np.testing.assert_array_equal(t.state_arrays()['vectors'], j.state_arrays()['vectors'])
    td, ti = t.search(q, limit=10)
    jd, ji = j.search(q, limit=10)
    assert_topk_close(td, ti, jd, ji)


def test_flat_index_from_jax_state_rejects_other_kinds():
    state = {'kind': np.array('pq_scan'), 'vectors': np.zeros((1, D), np.float32),
             'norms': np.zeros(1, np.float32)}
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        flat_index_from_jax_state(state, metric='cosine', device='cpu')
    state['kind'] = np.array('flat')
    state['norms'] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match='malformed'):
        flat_index_from_jax_state(state, metric='cosine', device='cpu')


def test_state_round_trip():
    x, q = _data()
    t, _ = _pair(Metric.INNER_PRODUCT, 'int8', x)
    u = TFlat(D, metric='inner_product', device='cpu')
    u.load_state_arrays(t.state_arrays())
    for a, b in zip(t.search(q, limit=5), u.search(q, limit=5)):
        np.testing.assert_array_equal(a, b)


def test_unported_scan_modes_raise():
    """Every scan mode of the JAX package is ported: an unknown mode and an
    odd dimension for int4 raise ValueError, as they do there."""
    with pytest.raises(ValueError, match='unknown scan_mode'):
        TFlat(D, scan_mode='fp8', device='cpu')
    with pytest.raises(ValueError, match='even dim'):
        TFlat(D + 1, scan_mode='int4', device='cpu')
    for mode in ('int4', 'bf16'):
        assert TFlat(D, scan_mode=mode, device='cpu').scan_mode == mode


def test_default_device_is_cuda():
    """No device means the card: without CUDA the constructor raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        assert TFlat(D).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        TFlat(D)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        TFlat(D, device='cuda')


@pytest.mark.parametrize('mode', ['STEP', 'DOUBLE', 'ADAPTIVE'])
def test_device_buffer_growth_equal_jax(mode):
    kw = dict(chunk=256, initial_capacity=100, expand_step=300)
    t = TBuffer((3,), np.float32, 'cpu', expand_mode=TExpandMode[mode], **kw)
    j = JBuffer((3,), np.float32, expand_mode=ExpandMode[mode], **kw)
    rng = np.random.default_rng(3)
    for step in range(6):
        vals = rng.standard_normal((150 + 70 * step, 3)).astype(np.float32)
        assert np.array_equal(t.append(vals), j.append(vals))
        if step % 2:
            rows = rng.choice(t.size, 20, replace=False)
            upd = rng.standard_normal((20, 3)).astype(np.float32)
            t.write(rows, upd)
            j.write(rows, upd)
        assert (t.size, t.capacity) == (j.size, j.capacity)
        tv, jv = t.device_view(), j.device_view()
        assert tv.shape == jv.shape
        assert tv.shape[0] % 256 == 0
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    t.reset()
    assert t.size == 0 and t.device_capacity == 0


def test_device_buffer_flushes_dirty_chunks_in_place():
    """A scatter write after a sync reaches the same device tensor, and the
    padding past the last row stays zero."""
    t = TBuffer((2,), np.int8, 'cpu', chunk=128)
    vals = np.arange(2 * 300, dtype=np.int8).reshape(300, 2)
    t.append(vals)
    v = t.device_view()
    assert v.shape == (384, 2)
    np.testing.assert_array_equal(v[:300].numpy(), vals)
    assert (v[300:] == 0).all()
    t.write(np.array([5, 260]), np.full((2, 2), 7, dtype=np.int8))
    assert t.device_view() is v
    assert (v[[5, 260]] == 7).all() and (v[300:] == 0).all()
