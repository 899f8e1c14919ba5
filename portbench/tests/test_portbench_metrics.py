"""The metric arithmetic: end-to-end readers over a synthetic window, the
device trace's reduction over a synthetic event list, and K1's frozen
bound."""
import pytest

from portbench import devtrace, spans
from portbench.harness import HERE, Context, load_module


def e2e(name):
    return load_module(HERE / 'endtoend' / f'{name}.py')


def test_qps_is_every_query_over_the_whole_window():
    w = {'queries': 64 * 300, 'seconds': 10.0}
    assert e2e('qps').read(w) == pytest.approx(1920.0)


def test_peak_and_setup_readers():
    assert e2e('peak_device_gib').read({'peak_bytes': 3 * 2**30}) == 3.0
    assert e2e('peak_device_gib').read({'peak_bytes': 0}) is None
    assert e2e('setup_s').read({'setup_s': 42.5}) == 42.5


def ev(cat, name, ts, dur):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def test_idle_share_launches_and_gaps_from_events():
    events = [
        ev('user_annotation', 'portbench.request', 0, 100),
        ev('user_annotation', 'portbench.index', 10, 50),
        ev('user_annotation', 'portbench.storage', 70, 20),
        ev('user_annotation', 'portbench.request', 100, 100),
        ev('kernel', 'block_top2_kernel<0>', 20, 10),
        ev('kernel', 'lane8_merge_kernel', 25, 15),   # overlaps: busy 20..40
        ev('gpu_memcpy', 'Memcpy DtoH', 50, 5),
        ev('kernel', 'block_top2_kernel<0>', 120, 30),
        ev('kernel', 'outside', 400, 10),               # after the window
        ev('cpu_op', 'aten::mm', 0, 300),
        {'ph': 'f', 'cat': 'ac2g', 'name': 'flow', 'ts': 1},
    ]
    s = devtrace.summarize(events, 2)
    assert s['window_s'] == pytest.approx(200e-6)
    assert s['busy_s'] == pytest.approx((20 + 5 + 30) * 1e-6)
    assert s['launches'] == 4
    assert s['kernel_n']['block_top2_kernel<0>'] == 2
    gaps = dict(s['idle_gaps'])
    # 0..10 request (facade), 10..20 index, 40..50 index, 55..60 index,
    # 60..70 facade, 70..90 storage, 90..120 facade, 150..200 facade
    assert gaps['index'] == pytest.approx(25e-6)
    assert gaps['storage'] == pytest.approx(20e-6)
    assert gaps['facade'] == pytest.approx(100e-6)
    ctx = Context(None, {}, {}, {}, [], [], s)
    assert load_module(HERE / 'metrics' / 'device_idle_pct.qps.py').read(ctx) == \
        pytest.approx(100 * (1 - 55 / 200))
    assert load_module(HERE / 'metrics' / 'launches_per_req.qps.py').read(ctx) == 2.0
    assert devtrace.summarize([ev('kernel', 'k', 0, 1)], 1) is None


def test_k1_frozen_bound_equals_chip_smoke():
    k1 = load_module(HERE / 'rooflines' / 'k1.py')
    # chip_smoke.py's bound() for block_top2 at 2^20 x 768, Q 64: 0.2479 ms (bytes)
    assert round(k1.bound_s(1 << 20, 768, 64) * 1e3, 4) == 0.2479
    nbytes, ops = k1.bytes_ops(1 << 20, 768, 64)
    assert nbytes / k1.HBM_BYTES_PER_S > ops / k1.INT8_OPS_PER_S


def test_k1_roofline_reader():
    k1 = load_module(HERE / 'rooflines' / 'k1.py')
    bound = k1.bound_s(262144, 768, 64)
    tr = {'busy_s': 1.0, 'window_s': 2.0, 'launches': 3, 'requests': 1,
          'kernel_s': {'block_top2_kernel<0, 32, 2>': 2 * bound, 'lane8_merge_kernel': 2 * bound,
                       'gather_rerank_kernel': 5.0},
          'kernel_n': {'block_top2_kernel<0, 32, 2>': 2, 'lane8_merge_kernel': 2}}
    cfg = {'n_docs': 262144, 'annlite': {'n_dim': 768}}

    class B:
        roofline = staticmethod(lambda name: k1)
    ctx = Context(B, {}, cfg, {'batch': 64}, [], [], tr)
    read = load_module(HERE / 'metrics' / 'k1_roofline.qps.py').read
    assert read(ctx) == pytest.approx(50.0)
    tr['kernel_n'] = {}
    assert read(ctx) is None


def test_layer_self_times():
    rows = [{'facade': 10.0, 'index': 6.0, 'storage': 1.0, 'filter': 1.0}] * 19 + \
        [{'facade': 30.0, 'index': 20.0, 'storage': 5.0, 'filter': 1.0}]
    lat = [10.0] * 19 + [30.0]
    ctx = Context(None, {}, {}, {}, rows, lat, None)
    assert ctx.layer_ms('facade') == pytest.approx(1e3 * (19 * 2 + 4) / 20)
    assert ctx.layer_ms('index') == pytest.approx(1e3 * (19 * 6 + 20) / 20)
    assert spans.self_times({'facade': 5.0, 'index': 2.0})['facade'] == 3.0
