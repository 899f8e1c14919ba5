"""The masked exact scan (`annlite_torch/ops/masked_scan.py`) on the CPU:
``masked_scan_plan`` (its ceiling, shared memory and the shapes it refuses),
the plain twin against the JAX package's ``_masked_exact_scan`` on the same
numpy inputs, the graph's ``_masked_exact_scan`` against a numpy stable
sort, and the kernel's decomposition (each tile's k best passing rows and
first k failing rows, merged by (distance, row)) at the plan's tiles.

Rows and queries are small integers, so every distance is exact in float32
(and the rows in bf16) in any summation order.  The kernel itself runs on
the card: `tests/test_torch_masked_scan_card.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch import profile
from annlite_torch.index import graph as tg
from annlite_torch.ops import masked_scan as ms
from annlite_tpu.index import graph as jg

BIG32 = np.float32(3.4e38)


def _data(n, d, nq, seed=0, extra=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (n + extra, d)).astype(np.float32)
    q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    return x, q


def _mask(n, selectivity, seed=1):
    if selectivity == 'one':
        m = np.zeros(n, bool)
        m[n // 3] = True
        return m
    return np.random.default_rng(seed).random(n) < selectivity


def _dist(x, q, n, euclid):
    """Float64 distances of rows 0 .. n, exact on these integers, as float32."""
    v = x[:n].astype(np.float64)
    dots = q.astype(np.float64) @ v.T
    if euclid:
        return ((q.astype(np.float64) ** 2).sum(1)[:, None] + (v ** 2).sum(1)[None, :]
                - 2 * dots).astype(np.float32)
    return (1.0 - dots).astype(np.float32)


def _oracle(x, q, mask, euclid, k):
    """Failing rows BIG, a stable sort: the answer the product and stable
    sort give."""
    d = np.where(mask[None, :], _dist(x, q, len(mask), euclid), BIG32)
    ids = np.argsort(d, axis=1, kind='stable')[:, :k]
    return np.take_along_axis(d, ids, axis=1), ids.astype(np.int32)


# ------------------------------------------------------------------ the plan

def test_plan_at_the_cell_shape():
    """The filtered graph cell's scan: 64 queries, 262,144 rows, k 10."""
    p = ms.masked_scan_plan(262_144, 64, 10)
    assert (p.tile, p.tiles, p.list_slots, p.merge_warps) == (1024, 256, 32, 32)
    assert p.scan_smem == 8 * 64 * 32 + ms._FIXED_SMEM == 88_352
    assert p.merge_smem == 8 * 32 * 32


def test_plan_ceiling():
    """Every k up to MAX_K (256) is planned; above it the plan refuses and
    the wrapper keeps the product and sort.  At the ceiling the lists take
    128 KiB of a CTA's shared memory, the merge's 32 warps 64 KiB."""
    assert ms.MAX_K == 256
    assert ms.masked_scan_plan(262_144, 64, ms.MAX_K) is not None
    assert ms.masked_scan_plan(262_144, 64, ms.MAX_K + 1) is None
    top = ms.masked_scan_plan(262_144, 64, ms.MAX_K)
    assert top.list_slots == 256 and top.scan_smem == 203_040 <= ms.SMEM_LIMIT
    assert top.merge_smem == 8 * 32 * 256


@pytest.mark.parametrize('n', [1, 63, 5_003, 262_144, 300_001, 9_990_000])
@pytest.mark.parametrize('k', [1, 10, 32, 33, 100, 256])
def test_plan_geometry(n, k):
    """Tiles of whole row chunks that cover the rows; lists of a power of
    two of at least 32 slots holding k; the tiles' keys and k failing rows
    within MAX_KEYS; a power of two of merge warps, a warp a tile up to 32;
    shared memory inside a CTA's."""
    p = ms.masked_scan_plan(n, 64, k)
    if k > n:
        assert p is None
        return
    assert p.tile % ms.ROW_CHUNK == 0 and p.tiles * p.tile >= n > (p.tiles - 1) * p.tile
    assert p.list_slots >= max(32, k) and p.list_slots & (p.list_slots - 1) == 0
    assert (p.tiles + 1) * k <= ms.MAX_KEYS
    assert p.merge_warps & (p.merge_warps - 1) == 0
    assert min(p.tiles, 32) <= p.merge_warps <= 32 and p.merge_warps < 2 * p.tiles
    assert p.scan_smem <= ms.SMEM_LIMIT and p.merge_smem <= ms.SMEM_LIMIT
    assert p.tiles <= ms.TARGET_TILES


@pytest.mark.parametrize('n,nq,k', [(100, 4, 0), (100, 4, 101), (0, 4, 1), (2**31, 4, 1),
                                    (100, 0, 1), (100, 65535 * 64 + 1, 1)])
def test_plan_refuses(n, nq, k):
    assert ms.masked_scan_plan(n, nq, k) is None


# ---------------------------------------------- the twin against the JAX scan

@pytest.mark.parametrize('euclid', [True, False])
@pytest.mark.parametrize('selectivity', [0.05, 0.2])
def test_twin_equals_jax(selectivity, euclid):
    x, q = _data(3000, 24, 9, extra=40)
    mask = _mask(3000, selectivity)
    td, ti = ms._masked_scan_ref(torch.from_numpy(x), torch.from_numpy(q),
                                 torch.from_numpy(mask), euclid, 10)
    jd, ji = (np.asarray(a) for a in jg._masked_exact_scan(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(mask), euclid, 10))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)


# ------------------------------------------- the graph's scan on CPU tensors

@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('euclid', [True, False])
@pytest.mark.parametrize('selectivity', [0.0, 'one', 0.05, 0.2, 1.0])
@pytest.mark.parametrize('k', [1, 10, 100])
def test_graph_scan_on_cpu_is_the_stable_sort(k, selectivity, euclid, bf16):
    """``index/graph.py`` ``_masked_exact_scan`` on CPU tensors: a numpy
    stable sort's answer, failing rows (BIG, lowest row first) past the
    passing count, rows beyond the mask (a padded buffer) never read, ties
    between duplicate rows to the lower row; no kernel launched."""
    n = 1_001
    x, q = _data(n, 16, 5, seed=3, extra=23)
    x[1::9] = x[0::9][: len(x[1::9])]  # duplicate rows: equal distances
    mask = _mask(n, selectivity)
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    before = profile.snapshot()['counters'].get('launch.masked_scan', 0)
    d, ids = tg._masked_exact_scan(xt, torch.from_numpy(q), torch.from_numpy(mask), euclid, k)
    assert profile.snapshot()['counters'].get('launch.masked_scan', 0) == before
    assert d.dtype == torch.float32 and ids.dtype == torch.int32
    od, oi = _oracle(x, q, mask, euclid, k)
    np.testing.assert_array_equal(ids.numpy(), oi)
    np.testing.assert_array_equal(d.numpy(), od)


def test_limit_beyond_the_mask():
    """A limit beyond the mask's rows returns every row of it."""
    x, q = _data(40, 8, 3, extra=10)
    mask = _mask(40, 0.5)
    d, ids = tg._masked_exact_scan(torch.from_numpy(x), torch.from_numpy(q),
                                   torch.from_numpy(mask), True, 100)
    od, oi = _oracle(x, q, mask, True, 40)
    assert ids.shape == (3, 40)
    np.testing.assert_array_equal(ids.numpy(), oi)
    np.testing.assert_array_equal(d.numpy(), od)


# ------------------------------------ the kernel's decomposition, in numpy

def _tiled(x, q, mask, euclid, k):
    """The kernel's algorithm at its plan: per tile of rows the k best
    passing rows by (distance, row) and the first k failing rows; per query
    the sort of every tile's keys and the mask's first k failing rows."""
    n = len(mask)
    plan = ms.masked_scan_plan(n, len(q), k)
    d_row = _dist(x, q, n, euclid)
    fails = []
    keys = [[] for _ in q]
    for t in range(plan.tiles):
        rows = np.arange(t * plan.tile, min(n, (t + 1) * plan.tile))
        passing, failing = rows[mask[rows]], rows[~mask[rows]]
        fails.extend(failing[: k - len(fails)] if len(fails) < k else [])
        for qi in range(len(q)):
            dd = d_row[qi, passing]
            best = np.lexsort((passing, dd))[:k]
            keys[qi].extend(zip(dd[best], passing[best]))
    out_d, out_i = [], []
    for qi in range(len(q)):
        allk = keys[qi] + [(BIG32, r) for r in fails[:k]]
        allk.sort(key=lambda kv: (kv[0], kv[1]))
        out_d.append([kv[0] for kv in allk[:k]])
        out_i.append([kv[1] for kv in allk[:k]])
    return np.array(out_d, np.float32), np.array(out_i, np.int32)


@pytest.mark.parametrize('n,k,selectivity', [(5_003, 10, 0.05), (5_003, 256, 0.2),
                                             (5_003, 100, 'one'), (5_003, 7, 0.0),
                                             (300_001, 256, 0.01), (3_000, 30, 1.0)])
def test_tiled_selection_is_the_stable_sort(n, k, selectivity):
    """Keeping each tile's k best passing rows and k first failing rows,
    then sorting the union by (distance, row), gives the twin's answer at the
    plan's tiles (a ragged last tile, tiles of several compaction steps)."""
    x, q = _data(n, 8, 3, seed=5)
    x[1::5] = x[0::5][: len(x[1::5])]
    mask = _mask(n, selectivity)
    td, ti = ms._masked_scan_ref(torch.from_numpy(x), torch.from_numpy(q),
                                 torch.from_numpy(mask), True, k)
    ed, ei = _tiled(x, q, mask, True, k)
    np.testing.assert_array_equal(ei, ti.numpy())
    np.testing.assert_array_equal(ed, td.numpy())
