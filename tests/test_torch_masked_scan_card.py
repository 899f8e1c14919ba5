"""The masked exact scan's kernel (`csrc/masked_scan.cu`, ``masked_scan``
and its merge) on the card: bit for bit against its plain twin
``_masked_scan_ref`` (the product over every row and a stable sort) at
0 passing rows, one, 5%, 20% and 100%, k from 1 to the plan's ceiling and
one above it (the product and sort, by the plan's shape test), 1 and 64
queries, a row count that is no multiple of the tile, a padded buffer
longer than the mask, duplicate rows, both metrics, float32 and bf16 rows;
and a ``GraphIndex`` at 10% answering with the kernel as with the twin.
Every test is marked ``cuda`` and skips without a card; on the card:

    python -m pytest -m cuda tests/test_torch_masked_scan_card.py

Rows and queries are small integers, so every distance is exact in float32
(and the rows in bf16) in any summation order."""
import numpy as np
import pytest
import torch

from annlite_torch import profile
from annlite_torch.index.graph import GraphIndex, _masked_exact_scan
from annlite_torch.ops import masked_scan as ms

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason='needs a CUDA card: the kernel has no CPU mode')]

N = 5_003          # not a multiple of the tile, nor of a 16-byte mask load
PAD = 37           # rows of the buffer beyond the mask
SELECTIVITIES = [0.0, 'one', 0.05, 0.2, 1.0]


def _data(n, d, nq, seed=0, extra=PAD):
    """Integer rows and queries; every 7th row repeats the one before it."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (n + extra, d)).astype(np.float32)
    x[1::7] = x[0::7][: len(x[1::7])]
    q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    return x, q


def _mask(n, selectivity, seed=1):
    if selectivity == 'one':
        m = np.zeros(n, bool)
        m[n - 2] = True
        return m
    return np.random.default_rng(seed).random(n) < selectivity


def _launches():
    c = profile.snapshot()['counters']
    return c.get('launch.masked_scan', 0), c.get('launch.masked_scan_merge', 0)


def _check(x, q, mask, euclid, k, bf16=False, kernel=True):
    v, qt, m = (torch.from_numpy(a).cuda() for a in (x, q, mask))
    if bf16:
        v = v.to(torch.bfloat16)
    before = _launches()
    d, ids = _masked_exact_scan(v, qt, m, euclid, k)
    torch.cuda.synchronize()
    after = _launches()
    assert after == ((before[0] + 1, before[1] + 1) if kernel else before)
    td, ti = ms._masked_scan_ref(v.cpu(), qt.cpu(), m.cpu(), euclid, k)
    assert d.dtype == torch.float32 and ids.dtype == torch.int32
    assert torch.equal(ids.cpu(), ti) and torch.equal(d.cpu(), td)
    return d, ids


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('euclid', [True, False])
@pytest.mark.parametrize('nq', [1, 64])
@pytest.mark.parametrize('k', [1, 10, 100, ms.MAX_K])
@pytest.mark.parametrize('selectivity', SELECTIVITIES)
def test_kernel_equals_twin(selectivity, k, nq, euclid, bf16):
    x, q = _data(N, 96, nq)
    _check(x, q, _mask(N, selectivity), euclid, k, bf16)


@pytest.mark.parametrize('euclid', [True, False])
@pytest.mark.parametrize('selectivity', [0.05, 1.0])
def test_above_the_ceiling_keeps_the_product_and_sort(selectivity, euclid):
    """k = MAX_K + 1: the plan refuses, no kernel launches, the product and
    sort on the card answer."""
    x, q = _data(N, 32, 5)
    assert ms.masked_scan_plan(N, 5, ms.MAX_K + 1) is None
    _check(x, q, _mask(N, selectivity), euclid, ms.MAX_K + 1, kernel=False)


@pytest.mark.parametrize('d,bf16', [(33, False), (33, True), (100, True), (4, False),
                                    (768, False), (768, True)])
def test_row_layouts(d, bf16):
    """Rows of whole 16-byte words or not (element loads), several
    32-dimension slices, a width below one slice."""
    x, q = _data(3_001, d, 70)
    _check(x, q, _mask(3_001, 0.2), True, 10, bf16)


def test_unaligned_mask_and_rows():
    """A mask and rows that start off a 16-byte boundary (views one element
    into their buffers): the kernel reads them element by element."""
    x, q = _data(N, 32, 9, extra=1)
    v = torch.from_numpy(x).cuda().reshape(-1)[1: 1 + N * 32].view(N, 32)
    mk = torch.from_numpy(_mask(N + 1, 0.2)).cuda()[1:]
    qt = torch.from_numpy(q).cuda()
    assert v.data_ptr() % 16 and mk.data_ptr() % 16
    d, ids = ms.masked_scan_kernel(v, qt, mk, True, 10)
    td, ti = ms._masked_scan_ref(v.cpu(), qt.cpu(), mk.cpu(), True, 10)
    assert torch.equal(ids.cpu(), ti) and torch.equal(d.cpu(), td)


@pytest.mark.parametrize('n,k,selectivity', [(300_001, 256, 0.01), (300_001, 10, 0.2),
                                             (262_144, 10, 0.05), (17, 17, 0.5)])
def test_plan_tiles(n, k, selectivity):
    """Tiles of several 4,096-row compaction steps (k 256 cuts 300,001 rows
    into 63 tiles), the cell's 256 tiles, and every row of a tiny mask."""
    x, q = _data(n, 16, 64, extra=0)
    _check(x, q, _mask(n, selectivity), False, k)


def test_kernel_refuses_what_the_plan_refuses():
    x, q = _data(100, 8, 2)
    v, qt, m = (torch.from_numpy(a).cuda() for a in (x, q, _mask(100, 0.5)))
    with pytest.raises(ValueError):
        ms.masked_scan_kernel(v, qt, m, True, ms.MAX_K + 1)
    with pytest.raises(ValueError):
        ms.masked_scan_kernel(v.double(), qt, m, True, 10)
    with pytest.raises(ValueError):
        ms.masked_scan_kernel(v, qt, m.cpu(), True, 10)


def test_graph_index_answers_with_the_kernel_as_with_the_twin():
    """A ``GraphIndex`` on the card at 10% of rows passing (below
    ``filter_fallback_selectivity``): one scan and one merge launch a
    search, and the twin's ids and distances over the index's rows."""
    x, q = _data(4_000, 32, 64, extra=0)
    idx = GraphIndex(32, metric='euclidean', max_degree=16, l_build=32, ef_search=32,
                     beam_width=4, build_mode='device', device='cuda')
    idx.add_with_ids(x, np.arange(len(x)))
    mask = _mask(len(x), 0.1)
    assert 0.1 < idx.filter_fallback_selectivity
    before = _launches()
    d, ids = idx.search(q, limit=10, mask=mask)
    assert _launches() == (before[0] + 1, before[1] + 1)
    s = idx._sync_device()
    td, ti = ms._masked_scan_ref(s.vectors.cpu(), torch.from_numpy(q),
                                 torch.from_numpy(mask), True, 10)
    np.testing.assert_array_equal(ids, ti.numpy())
    np.testing.assert_array_equal(d, td.numpy())
