"""``lane8_merge``'s split plan and its CPU twin: the kernel walks each lane
class's blocks as several contiguous ranges side by side and merges the
ranges' stacks in order (`csrc/fused_scan.cu`).  The twin follows that
algorithm and must equal the stable sort of ``_lane8_merge_ref`` on
tie-heavy candidates, for every split count."""
import numpy as np
import pytest
import torch

from annlite_torch.ops import fused_scan as tfs


@pytest.mark.parametrize('q_lo', range(1, 131, 26))
def test_plan_covers_every_block_once_in_order(q_lo):
    """For every nb in 1..300 and Q in 1..130: the ranges are non-empty,
    contiguous, in ascending order and cover every block once; there are at
    most MERGE_MAX_RANGES of them and the grid stays within 4*Q CTAs of
    ranges warps."""
    for nq in range(q_lo, min(q_lo + 26, 131)):
        for nb in range(1, 301):
            ranges = tfs.lane8_merge_plan(nq, nb)
            assert 1 <= ranges <= min(nb, tfs.MERGE_MAX_RANGES)
            parts = tfs.lane8_merge_ranges(nb, ranges)
            assert len(parts) == ranges and all(len(p) >= 1 for p in parts)
            assert [b for p in parts for b in p] == list(range(nb))


def test_plan_at_the_search_shapes():
    """16 ranges at Q = 64 and Q = 1 (nb 128 and 256); fewer where the
    queries alone give enough warps, never more than the blocks."""
    for nb in (128, 256):
        assert tfs.lane8_merge_plan(64, nb) == 16
        assert tfs.lane8_merge_plan(1, nb) == 16
    assert tfs.lane8_merge_plan(128, 128) == 9
    assert tfs.lane8_merge_plan(64, 3) == 3
    assert tfs.lane8_merge_plan(1, 1) == 1


def _candidates(kind, nq, nb, seed=0):
    """Scores with many ties and distinct rows: small integers, all equal,
    duplicated blocks, or +inf blocks (with 8 finite candidates per lane
    class left)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, (nq, nb * 256)).astype(np.float32)
    if kind == 'equal':
        s[:] = 1.0
    elif kind == 'duplicated':
        s[:, 256:512] = s[:, 0:256]
        s[:, -256:] = s[:, 512:768]
    elif kind == 'inf':
        s[:, 256:768] = np.inf
        s[:, -256:] = np.inf
    r = rng.permutation(nq * nb * 256).reshape(nq, nb * 256).astype(np.int32)
    return torch.from_numpy(s), torch.from_numpy(r)


@pytest.mark.parametrize('kind', ['small', 'equal', 'duplicated', 'inf'])
@pytest.mark.parametrize('ranges', range(1, tfs.MERGE_MAX_RANGES + 1))
def test_split_merge_equals_stable_top8(kind, ranges):
    s, r = _candidates(kind, 3, 37, seed=ranges)
    got = tfs._lane8_merge_split(s, r, ranges)
    want = tfs._lane8_merge_ref(s, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _sequential(s, r):
    """The one-thread-per-lane-class walk, in plain Python: (+inf, 0)
    fillers, strict '<' with a shift."""
    nq, c = s.shape
    out_s = np.full((nq, 8, 128), np.inf, np.float32)
    out_r = np.zeros((nq, 8, 128), np.int32)
    for q in range(nq):
        for lane in range(128):
            st = [(np.inf, 0)] * 8
            for i in range(c // 128):
                cand = (s[q, i * 128 + lane].item(), r[q, i * 128 + lane].item())
                for k in range(8):
                    if cand[0] < st[k][0]:
                        st = st[:k] + [cand] + st[k:7]
                        break
            out_s[q, :, lane] = [v for v, _ in st]
            out_r[q, :, lane] = [v for _, v in st]
    return out_s.reshape(nq, 1024), out_r.reshape(nq, 1024)


@pytest.mark.parametrize('nb', [1, 2, 3, 5])
def test_split_merge_with_few_candidates_keeps_fillers(nb):
    """Fewer than 8 finite candidates per lane class (nb < 4, or +inf
    blocks): the stacks keep (+inf, 0) fillers, every split count alike."""
    s, r = _candidates('small', 2, nb, seed=nb)
    if nb == 5:
        s[:, 256:] = float('inf')
    want = _sequential(s, r)
    for ranges in range(1, nb + 1):
        got = tfs._lane8_merge_split(s, r, ranges)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
