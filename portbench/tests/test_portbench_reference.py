"""The plain reference against a float64 numpy brute force, with masks and
ties, at a small size."""
import numpy as np
import pytest
import torch

from portbench.reference import exact_topk, pair_dist64, round_to


def brute(xq, xb, metric, k, mask=None):
    q, x = xq.astype(np.float64), xb.astype(np.float64)
    if metric == 'cosine':
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        d = 1.0 - q @ x.T
    else:
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d = np.where(mask[None, :], d, np.inf)
    order = np.argsort(d, axis=1, kind='stable')[:, :k]
    return order, np.take_along_axis(d, order, 1)


@pytest.mark.parametrize('metric', ['cosine', 'euclidean'])
def test_exact_topk_matches_float64_brute_force(metric):
    rng = np.random.default_rng(0)
    if metric == 'euclidean':  # integer rows with duplicates: exact ties
        xb = rng.integers(0, 6, (600, 16)).astype(np.float32)
        xq = rng.integers(0, 6, (40, 16)).astype(np.float32)
    else:
        xb = rng.standard_normal((600, 24)).astype(np.float32)
        xq = rng.standard_normal((40, 24)).astype(np.float32)
    mask = rng.random(600) < 0.3
    masks = {0: None, 1: torch.from_numpy(mask), 2: torch.from_numpy(np.arange(600) < 5)}
    got = exact_topk(torch.from_numpy(xq), torch.from_numpy(xb), metric, 10, masks, block=16)
    for key, m in ((0, None), (1, mask), (2, np.arange(600) < 5)):
        ids, d = (t.numpy() for t in got[key])
        want_ids, want_d = brute(xq, xb, metric, 10, m)
        np.testing.assert_allclose(np.where(ids >= 0, d, np.inf), want_d, rtol=0, atol=1e-12)
        valid = ids >= 0
        if m is not None:
            assert m[ids[valid]].all()
        # ids agree wherever the distance is not tied with a neighbour's
        assert ((ids == want_ids) | ~valid | np.isclose(d, want_d, atol=1e-12)).all()
        if key == 2:
            assert (valid.sum(1) == 5).all()


def test_pair_dist64_and_scale():
    q = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
    x = torch.tensor([[0.0, 0.0], [0.0, 2.0]])
    d, s = pair_dist64(q, x, 'euclidean')
    assert d.tolist() == [25.0, 5.0] and s.tolist() == [25.0, 5.0]
    d, s = pair_dist64(q[1:], x[1:], 'cosine')
    assert d.tolist() == [1.0] and s.tolist() == [2.0]


def test_round_to_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12), 255.0])
    assert round_to(x, 'tf32').tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0, 255.0]
    assert round_to(x, None) is x
