"""A cell at a small size on the card, through the same function the
command line calls; it skips without one (decided in the fixture)."""
import pytest

from portbench.harness import Bench, run_cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return 'cuda'


@pytest.mark.parametrize('cell', ['flat768.batch64', 'graph128.batch64'])
def test_small_cell_on_the_card(card, cell):
    out = run_cell(Bench(), cell, 17, 0.5, True, device=card,
                   overrides={'n_docs': 40000, 'ingest_batch': 10000, 'traffic': {'pool': 500}})
    assert out['correct'] and out['device']['platform'] == 'gpu'
    assert out['device']['busy_s'] > 0
