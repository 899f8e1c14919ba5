"""The benchmark's own tests: CPU only, small sizes; importable from the
root of a checkout (``python -m pytest portbench/tests``)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the single-request cells kept for later (their mixes are in traffic/):
# the tests drive the harness's ``search`` call, filters and tags through them
OPEN_CELLS = [
    {'name': 'flat768.filtered1', 'config': 'annlite-readme-768-flat', 'traffic': 'filtered1',
     'chips': 1, 'why': 'one query a request under a price filter, tags returned'},
    {'name': 'graph128.single', 'config': 'sift-128-euclidean-graph', 'traffic': 'single',
     'chips': 1, 'why': 'one query a request on the graph'},
]


@pytest.fixture(scope='session')
def bench(tmp_path_factory):
    """``BENCHMARK.json`` with the cells kept for later added."""
    from portbench.harness import HERE, Bench

    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    spec['workloads'] += OPEN_CELLS
    path = tmp_path_factory.mktemp('bench') / 'BENCHMARK.json'
    path.write_text(json.dumps(spec))
    return Bench(path, HERE)
