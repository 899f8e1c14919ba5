"""The persistent PQ beam search (``beam_pq``, `csrc/beam_pq.cu`): its
plain twin ``_beam_pq_ref``, which follows the kernel's algorithm step by
step, against annlite_tpu.ops.beam.beam_search_pq on one shared adjacency,
and the dispatch between the kernel and the eager loop around K8.

Tables are dyadic (k/8) and codes small integers, so every table sum is
exact in float32 in any order: ids and distances must be equal, ties and the
BIG tail of the list included (the tests ask for k = L)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch import profile
from annlite_torch.index.vamana_lib import VamanaGraph
from annlite_torch.ops import beam as tb
from annlite_tpu.ops import beam as jb

N, D, R, Q, M = 700, 16, 12, 7, 4
# (L, B, iters) as test_torch_beam.py: the default budget; a budget that cuts
# the search short; one far beyond convergence (each query stops early); B > L
SCHEDULES = [(32, 4, None), (16, 8, 3), (24, 4, 64), (8, 16, None)]


@pytest.fixture(scope='module')
def graph():
    """Integer rows, one single-threaded build; entry rows of width 3."""
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, (N, D)).astype(np.float32)
    g = VamanaGraph(D, max_degree=R, l_build=32)
    g.add(x, n_threads=1)
    entry = rng.integers(0, N, (Q, 3)).astype(np.int32)
    return g.adjacency(), entry


def _tables(code_dtype, k, seed=1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (N, M)).astype(code_dtype)
    dtable = (rng.integers(0, 128, (Q, M, k)) / 8.0).astype(np.float32)
    return codes, dtable


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(adj, entry, codes, dtable, L, B, iters, k=None):
    """(JAX beam_search_pq, the twin) on the same inputs, k = L."""
    k = L if k is None else k
    want = jb.beam_search_pq(jnp.asarray(adj), jnp.asarray(entry), jnp.asarray(codes),
                             jnp.asarray(dtable), k=k, L=L, B=B, iters=iters)
    b = min(B, L)
    got = tb._beam_pq_ref(_t(adj), _t(entry), _t(codes), _t(dtable), L, b,
                          tb._resolve_iters(iters, L, b), k)
    return [np.asarray(w) for w in want], got


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize('width', [1, 3])
@pytest.mark.parametrize('code_dtype,k', [(np.uint8, 16), (np.uint16, 300)])
@pytest.mark.parametrize('L,B,iters', SCHEDULES)
def test_twin_equals_jax(graph, width, code_dtype, k, L, B, iters):
    adj, entry = graph
    want, got = _both(adj, entry[:, :width], *_tables(code_dtype, k), L, B, iters)
    _assert_equal(got, want)
    its = got[2].numpy()
    budget = tb._resolve_iters(iters, L, min(B, L))
    assert ((its >= 1) & (its <= budget)).all()
    if iters == 64:  # far beyond convergence: every query stopped on its own
        assert (its < 64).all()


def test_invalid_entries(graph):
    """An entry of -1 (and one of N) beside valid ones, and a query whose
    only entries are invalid: its list stays (BIG, NO_ID) and it runs no
    iteration."""
    adj, entry = graph
    entry = entry.copy()
    entry[0, 1] = -1
    entry[2, 0] = N
    entry[4, :] = -1
    want, got = _both(adj, entry, *_tables(np.uint8, 16), 16, 4, None)
    _assert_equal(got, want)
    assert (got[1][4].numpy() == tb.NO_ID).all()
    assert (got[0][4].numpy() == np.float32(tb.BIG)).all()
    assert got[2][4] == 0


def test_tail_with_fewer_alive_than_k(graph):
    """A graph whose nodes reach only a few others: fewer than L entries
    stay alive, so the list's tail (the dedup's losing copies at BIG, then
    NO_ID) reaches the output and is compared."""
    adj, entry = graph
    small = np.full_like(adj, -1)
    small[:, :2] = adj[:, :2] % 5  # every row points into nodes 0..4
    small[5:] = -1
    ent = np.zeros((Q, 2), dtype=np.int32)
    ent[:, 1] = np.arange(Q) % 5
    want, got = _both(small, ent, *_tables(np.uint8, 16), 24, 4, None)
    _assert_equal(got, want)
    ids = got[1].numpy()
    alive = (got[0].numpy() < np.float32(tb.BIG)).sum(1)
    assert (alive <= 5).all() and (ids == tb.NO_ID).any()
    assert ((ids != tb.NO_ID) & (got[0].numpy() == np.float32(tb.BIG))).any()


def test_twin_equals_the_eager_loop(graph):
    """The CPU path (the eager loop with the plain scorer) and the twin."""
    adj, entry = graph
    codes, dtable = _tables(np.uint16, 300, seed=5)
    want = tb.beam_search_pq(_t(adj), _t(entry), _t(codes), _t(dtable), k=20, L=20, B=4)
    got = tb._beam_pq_ref(_t(adj), _t(entry), _t(codes), _t(dtable), 20, 4,
                          tb._resolve_iters(None, 20, 4), 20)
    _assert_equal(got, [w.numpy() for w in want])


def test_order_key_sorts_as_float32():
    d = torch.tensor([3.5, -2.0, 0.0, -0.0, np.float32(tb.BIG), 1e-30, -1e30, 7.0,
                      float('inf'), 2.0], dtype=torch.float32)
    key = tb._f32_order_key(d)
    assert key[2] == key[3]  # -0.0 folded to +0.0
    assert torch.equal(torch.sort(key, stable=True).indices,
                       torch.sort(d, stable=True).indices)
    assert ((key >= 0) & (key < 2**32)).all()


@pytest.mark.parametrize('L,B,R,want_p,want_threads', [
    (128, 8, 32, 512, 256), (8, 16, 12, 128, 64), (2048, 64, 32, 4096, 512),
    (16, 4, 12, 64, 32), (4, 2, 3, 64, 32), (1000, 8, 32, 2048, 512)])
def test_plan_below_the_ceiling(L, B, R, want_p, want_threads):
    """The graph phase's ef 128, B 8, R 32 takes 512 slots, two keys a
    thread; at least 64 slots (one warp); a geometry at the ceiling still
    launches the kernel, eight keys a thread."""
    plan = tb.beam_pq_plan(L, B, R, 64, 256)
    assert plan.sort_len == want_p == max(64, tb._next_pow2(L + min(B, L) * R))
    assert plan.sort_len <= tb.MAX_SORT
    assert plan.table_in_smem
    assert plan.smem_bytes == 64 * 256 * 4 + 24 * want_p + (min(B, L) + 2) // 2 * 8 + 8
    assert plan.smem_bytes <= tb.SMEM_LIMIT
    assert plan.threads == want_threads and plan.threads % 32 == 0
    assert plan.sort_len // plan.threads in (2, 4, 8)


@pytest.mark.parametrize('L,B,R', [(2049, 64, 32), (4096, 8, 32), (128, 128, 64)])
def test_plan_beyond_the_ceiling(L, B, R):
    """More than MAX_SORT slots: no plan, the eager loop around K8."""
    assert tb._next_pow2(L + min(B, L) * R) > tb.MAX_SORT
    assert tb.beam_pq_plan(L, B, R, 64, 256) is None


def test_plan_reads_a_large_table_from_global_memory():
    """u16 codes at K = 1024: a 256 KB table does not fit; K = 256 does.  A
    table of M * K floats that is not a whole number of 16-byte words is
    read from global memory too (one bulk copy stages the table)."""
    plan = tb.beam_pq_plan(128, 8, 32, 64, 1024)
    assert not plan.table_in_smem
    assert plan.smem_bytes == 24 * 512 + 5 * 8 + 8
    assert tb.beam_pq_plan(128, 8, 32, 64, 256).table_in_smem
    assert not tb.beam_pq_plan(128, 8, 32, 3, 301).table_in_smem
    assert tb.beam_pq_plan(128, 8, 32, 4, 301).table_in_smem


def test_cpu_search_takes_the_eager_loop(graph, monkeypatch):
    """On the CPU beam_search_pq never launches; the kernel's wrapper refuses
    CPU tensors."""
    adj, entry = graph
    codes, dtable = _tables(np.uint8, 16)
    launches0 = profile.snapshot()['counters'].get('launch.beam_pq', 0)
    seen = []
    real = tb._beam_loop
    monkeypatch.setattr(tb, '_beam_loop', lambda *a, **kw: seen.append(1) or real(*a, **kw))
    tb.beam_search_pq(_t(adj), _t(entry), _t(codes), _t(dtable), k=8, L=16, B=4)
    assert seen == [1]
    with pytest.raises(ValueError, match='CUDA'):
        tb.beam_pq_kernel(_t(adj), _t(entry), _t(codes), _t(dtable), 8, 16, 4, 8)
    assert profile.snapshot()['counters'].get('launch.beam_pq', 0) == launches0
