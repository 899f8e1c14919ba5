"""The port's row→doc-id map (`annlite_torch/storage/table.py`
`get_docids_by_rows`, one take from the resident array) against
annlite_tpu's, which answers through SQL while its array is absent: the same
operations on both tables, the same row lists looked up after each."""
import numpy as np
import pytest

from annlite_torch import profile
from annlite_torch.storage.table import CellTable as TCellTable
from annlite_tpu.storage.table import CellTable as JCellTable

COLUMNS = [('price', float)]


def _builds() -> int:
    return profile.snapshot()['counters'].get('storage.idmap_builds', 0)


def _probes(n: int):
    """Row lists: in range, past the end, negative, duplicated, empty."""
    rng = np.random.default_rng(n)
    return [
        list(range(n)),
        rng.integers(0, max(n, 1), 50).tolist(),
        [n, n + 1, n + 1000],
        [-1, -2, 0, -n - 5],
        [3, 3, 0, 3, n, -1, n, 0],
        [],
    ]


def _tags(lo, hi):
    return [{'price': float(i)} for i in range(lo, hi)]


def _insert(tables, lo, hi):
    for t in tables:
        t.insert([f'd{i}' for i in range(lo, hi)], np.zeros(hi - lo, np.int64), _tags(lo, hi))


def _steps(tmp_path):
    """(name, write, drops the array) in order; each write takes both tables."""
    snap = tmp_path / 'cells.db'

    def update(tables):  # the container's update: dead-mark, then append
        for t in tables:
            t.delete(['d5', 'd17'])
            t.insert(['d5', 'd17'], [0, 0], [{'price': -5.0}, {'price': -17.0}])

    def execute(tables):
        for t in tables:
            t.execute(f'UPDATE {t.name} SET _doc_id = ? WHERE _id = ?', ('renamed', 2))

    def executemany(tables):
        for t in tables:
            t.executemany(f'UPDATE {t.name} SET _doc_id = ? WHERE _id = ?',
                          [('many1', 4), ('many2', 9)])

    def dump(tables):
        for t in tables:
            t.dump(snap)

    def load(tables):
        for t in tables:
            t.load(snap)

    return [
        ('insert 0-40', lambda ts: _insert(ts, 0, 40), False),
        ('insert 40-41', lambda ts: _insert(ts, 40, 41), False),
        ('insert 41-70', lambda ts: _insert(ts, 41, 70), False),
        ('update', update, False),
        ('update_columns', lambda ts: [t.update_columns(['d30'], [{'price': 0.5}]) for t in ts],
         False),
        ('delete', lambda ts: [t.delete(['d1', 'd2', 'd40', 'nope']) for t in ts], False),
        ('undelete', lambda ts: [t.undelete(['d1', 'd40']) for t in ts], False),
        ('execute', execute, True),
        ('executemany', executemany, True),
        ('dump', dump, False),
        ('insert 70-90', lambda ts: _insert(ts, 70, 90), False),
        ('load', load, True),
    ]


@pytest.mark.parametrize('as_array', [False, True], ids=['list', 'ndarray'])
def test_idmap_equal_jax_after_each_write(tmp_path, as_array):
    t, j = TCellTable('cells', COLUMNS), JCellTable('cells', COLUMNS)
    for name, write, _ in _steps(tmp_path):
        write((t, j))
        n = t.n_rows
        assert n == j.n_rows, name
        for rows in _probes(n):
            got = t.get_docids_by_rows(np.asarray(rows, np.int64) if as_array else rows)
            assert isinstance(got, list), name
            assert got == j.get_docids_by_rows(rows), (name, rows)
        assert j._docids_cache is None  # the JAX side answered through SQL
    t.close()
    j.close()


def test_idmap_builds_once_per_drop(tmp_path):
    t = TCellTable('cells', COLUMNS)
    before = _builds()
    expected = 0
    for name, write, drops in _steps(tmp_path):
        write((t,))
        if drops or expected == 0:
            expected += 1  # the first lookup, and the first after a drop, scan
        for _ in range(3):
            for rows in _probes(t.n_rows):
                t.get_docids_by_rows(rows)
        assert _builds() - before == expected, name
    t.close()


def test_soft_deleted_rows_keep_their_id():
    t = TCellTable('cells', COLUMNS)
    _insert((t,), 0, 4)
    t.delete(['d1'])
    t.get_docids_by_rows([0])  # builds the array
    t.delete(['d2'])
    assert t.get_docids_by_rows([1, 2, 4]) == ['d1', 'd2', None]
    assert list(t.docids_array()) == ['d0', 'd1', 'd2', 'd3']
    t.close()
