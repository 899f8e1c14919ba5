"""annlite_torch's host Vamana builder: its own copy of the C++ source, built
with g++ under build/annlite_torch/, held against the JAX package's builder
(the same code, loaded from native/ by annlite_tpu)."""
import re
from pathlib import Path

import numpy as np
import pytest

from annlite_torch.index import graph as tgraph
from annlite_torch.index import vamana_lib as tv
from annlite_tpu.index import vamana_lib as jv

ROOT = Path(__file__).resolve().parents[1]


def _code(path: Path) -> str:
    """The C++ source without its comments and blank lines."""
    lines = (re.sub(r'//.*$', '', ln).rstrip() for ln in path.read_text().splitlines())
    return '\n'.join(ln for ln in lines if ln)


def _clustered(n=1500, d=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, 8, n)] + rng.standard_normal((n, d))).astype(np.float32)


def test_copy_equals_native_source():
    """The port's copy is native/vamana.cpp with only its header comment
    rewritten: the code is the same, line for line."""
    copy, native = tv.SOURCE, ROOT / 'native' / 'vamana.cpp'
    assert copy == ROOT / 'annlite_torch' / 'csrc' / 'vamana.cpp'
    assert _code(copy) == _code(native)
    body = lambda p: p.read_text().split('#include', 1)[1]  # noqa: E731
    assert body(copy) == body(native)


def test_library_lives_under_build_annlite_torch():
    lib = tv.build()
    assert lib == tv.library_path()
    assert lib.is_relative_to(ROOT / 'build' / 'annlite_torch')
    assert not lib.is_relative_to(ROOT / 'native')
    assert not lib.is_relative_to(ROOT / 'annlite_tpu')
    loaded = Path(tv.load_lib()._name)
    assert loaded == lib and loaded.exists()


@pytest.mark.parametrize('metric_ip', [False, True])
def test_single_thread_build_equals_jax_builder(metric_ip):
    """One thread builds deterministically: the port's library and the JAX
    package's give the same adjacency and medoid."""
    x = _clustered(800, 16)
    if metric_ip:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    t = tv.VamanaGraph(16, max_degree=12, metric_ip=metric_ip, l_build=32)
    j = jv.VamanaGraph(16, max_degree=12, metric_ip=metric_ip, l_build=32)
    t.add(x[:500], n_threads=1)
    j.add(x[:500], n_threads=1)
    t.add(x[500:], n_threads=1)
    j.add(x[500:], n_threads=1)
    np.testing.assert_array_equal(t.adjacency(), j.adjacency())
    assert t.medoid == j.medoid and t.size == j.size == 800
    ids = np.array([3, 40, 700], dtype=np.int32)
    t.update(ids, x[ids] + 0.5)
    j.update(ids, x[ids] + 0.5)
    np.testing.assert_array_equal(t.adjacency(), j.adjacency())
    for qi in (0, 5, 600):
        dt, it = t.search(x[qi], k=5, L=32)
        dj, ij = j.search(x[qi], k=5, L=32)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(dt, dj)


def test_multithread_build_passes_integrity():
    x = _clustered()
    g = tv.VamanaGraph(24, max_degree=16, l_build=48)
    g.add(x, n_threads=0)
    rep = tgraph.graph_integrity_report(g.adjacency(), g.medoid, g.size)
    assert rep['ok'], rep
    assert rep['degree_min'] >= 1 and rep['out_of_range_edges'] == 0


def test_state_loads_and_comes_back_equal():
    x = _clustered(600, 16)
    a = tgraph.GraphIndex(16, metric='euclidean', max_degree=12, device='cpu')
    a.add_with_ids(x, np.arange(600))
    a.delete_rows([4, 9])
    st = a.state_arrays()
    b = tgraph.GraphIndex(16, metric='euclidean', max_degree=12, device='cpu')
    b.load_state_arrays(st)
    back = b.state_arrays()
    assert set(back) == {'kind', 'vectors', 'adjacency', 'alive'}
    for k in st:
        np.testing.assert_array_equal(back[k], st[k])
    assert b._graph.medoid == a._graph.medoid and b.n_deleted == 2
