"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card skipped (``device='cpu'``), everything else a
run does, with one fault planted in the built ``AnnLite`` for each fault
the cells can have: half of a batch left out, and an answer altered where
it is produced (a doc id in the row-to-id map, a distance in the index, a
tag in the doc store, the filter in the mask).  A cell on one card has no
exchange between cards and no state that a step carries."""
import numpy as np
import pytest

from portbench.harness import run_cell

TINY = {'n_docs': 2000, 'ingest_batch': 1000, 'traffic': {'pool': 128}}


def patch(obj, name, make):
    setattr(obj, name, make(getattr(obj, name)))


def half_batch(ann):
    """Half of each batch left out (every other request at batch 1)."""
    from annlite_torch.ops import BIG
    calls = [0]

    def make(search):
        def f(q, *a, **kw):
            d, i = search(q, *a, **kw)
            calls[0] += 1
            d = d.copy()
            if d.shape[0] > 1:
                d[::2] = BIG
            elif calls[0] % 2:
                d[:] = BIG
            return d, i
        return f
    patch(ann._container.index, 'search', make)


def altered_id(ann):
    n = ann.total_docs

    def make(get):
        def f(rows):
            ids = get(rows)
            if ids:
                ids[0] = str((int(ids[0]) + 1) % n)
            return ids
        return f
    patch(ann._container.cell_table, 'get_docids_by_rows', make)


def altered_distance(ann):
    def make(search):
        def f(q, *a, **kw):
            d, i = search(q, *a, **kw)
            d = d.copy()
            d[:, 0] += 1e-3 * (np.abs(d[:, 0]) + 1.0)
            return d, i
        return f
    patch(ann._container.index, 'search', make)


def altered_tag(ann):
    def make(get):
        def f(ids):
            docs = get(ids)
            for d in docs[:1]:
                d.tags['price'] = d.tags['price'] + 1e-9
            return docs
        return f
    patch(ann._container.doc_store, 'get', make)


def filter_dropped(ann):
    c = ann._container
    patch(c, '_build_mask', lambda build: (lambda flt: build(None)))


CASES = [
    ('flat768.batch64', half_batch), ('flat768.batch64', altered_id),
    ('flat768.batch64', altered_distance),
    ('flat768.filtered1', half_batch), ('flat768.filtered1', altered_tag),
    ('flat768.filtered1', filter_dropped), ('flat768.filtered1', altered_id),
    ('graph128.batch64', half_batch), ('graph128.batch64', altered_distance),
    ('graph128.single', half_batch), ('graph128.single', altered_id),
]


@pytest.mark.parametrize('cell,fault', CASES, ids=[f'{c}-{f.__name__}' for c, f in CASES])
def test_fault_makes_the_run_not_correct(bench, cell, fault):
    out = run_cell(bench, cell, 2**31 + 5, 0.4, False, device='cpu', overrides=TINY,
                   tamper=fault)
    assert out['attempted'] > 0
    assert out['correct'] is False and out['failed'] > 0
    failing = {k for k, v in out['checks'].items()
               if (v['value'] < v['limit'] if k == 'recall_at_10' else v['value'] > v['limit'])}
    assert 'failed_requests' in failing


def test_unbroken_run_is_correct(bench):
    out = run_cell(bench, 'flat768.filtered1', 2**31 + 5, 0.4, False, device='cpu',
                   overrides=TINY)
    assert out['correct'] and out['failed'] == 0
