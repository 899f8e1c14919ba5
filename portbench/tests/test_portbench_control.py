"""The control (the reference in the program's place, one precision down)
comes out not correct, at a size a test run holds; the reference itself in
the program's place, at the stated precision, comes out correct."""
import pytest

from portbench.control import run_control

SMALL = {'n_docs': 4000, 'traffic': {'pool': 256}}
CELLS = ['flat768.batch64', 'flat768.filtered1', 'graph128.batch64', 'graph128.single']


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails(bench, cell):
    out = run_control(bench, cell, 2**31 + 21, 'cpu', n_requests=300, overrides=SMALL)
    assert out['precision'] == ('tf32' if cell.startswith('flat') else 'fp8')
    assert out['correct'] is False
    assert out['dist_err'] > out['checks']['dist_err']['limit']


@pytest.mark.parametrize('cell', ['flat768.filtered1', 'graph128.batch64'])
def test_integer_rows_hide_tf32_and_bf16(bench, cell):
    """On the SIFT-shaped rows (integers up to 255) TF32 and bf16 are exact,
    which is why the graph's control is fp8; on float rows they are not."""
    for precision in ('tf32', 'bf16'):
        out = run_control(bench, cell, 7, 'cpu', n_requests=100, overrides=SMALL,
                          precision=precision)
        assert out['correct'] is cell.startswith('graph')
