"""The frozen generators and the traffic generator: the same seed gives the
same inputs, every seed the same shapes and the same mix."""
import numpy as np
import pytest

from portbench import datasets
from portbench.traffic import Traffic

SEED = 2**31 + 12345  # the driver's seeds exceed 32 signed bits


@pytest.mark.parametrize('name,kw,d', [('synth_sift_like', {}, 128),
                                       ('synth_glove_like', {'d': 768}, 768)])
def test_generators_deterministic_with_stated_shapes(name, kw, d):
    gen = datasets.GENERATORS[name]
    xb, xq = gen(1000, 50, seed=SEED, **kw)
    xb2, xq2 = gen(1000, 50, seed=SEED, **kw)
    assert xb.shape == (1000, d) and xq.shape == (50, d)
    assert xb.dtype == xq.dtype == np.float32
    assert np.array_equal(xb, xb2) and np.array_equal(xq, xq2)
    xb3, _ = gen(1000, 50, seed=SEED + 1, **kw)
    assert not np.array_equal(xb, xb3)


def test_sift_like_is_integer_valued_and_bounded():
    xb, xq = datasets.synth_sift_like(2000, 20, seed=SEED)
    for x in (xb, xq):
        assert np.array_equal(x, np.floor(x)) and x.min() >= 0 and x.max() <= 255
    # squared distances stay below 2^24: exact in float32
    assert float((xb.astype(np.float64) ** 2).sum(1).max()) * 2 < 2**24


def test_traffic_same_mix_every_seed():
    mix = {'call': 'search', 'batch': 1, 'limit': 10, 'pool': 50, 'include_metadata': True,
           'filter': {'column': 'price', 'op': '$lt', 'values': [5, 15, 20, 30, 50, 80]}}
    seqs = []
    for seed in (1, SEED):
        t = Traffic(mix, seed)
        vals = [t.request(i)[1] for i in range(60)]
        for b in range(10):  # each value once in every run of six requests
            assert sorted(vals[6 * b:6 * b + 6]) == [5, 15, 20, 30, 50, 80]
        seqs.append(vals)
        assert [int(t.request(i)[0][0]) for i in range(60)] == [i % 50 for i in range(60)]
    assert seqs[0] != seqs[1]
    t = Traffic(mix, 1)
    assert [t.request(i)[1] for i in range(60)] == seqs[0]


def test_batches_cycle_through_the_pool():
    t = Traffic({'call': 'search_numpy', 'batch': 64, 'limit': 10, 'pool': 100,
                 'filter': None}, 3)
    rows = np.concatenate([t.request(i)[0] for i in range(3)])
    assert np.array_equal(rows, np.arange(192) % 100)
    assert t.request(0)[1] is None and t.filter_dict(None) is None
