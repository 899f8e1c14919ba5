"""Nothing under portbench/ imports the JAX package or its stack, the
repository's other benchmarks or its tests; the yardstick (reference,
comparison, data, rooflines) imports nothing of the program either.
Top-level names are compared whole: ``annlite_torch`` starts with
``annlite``, which is not ``annlite_tpu``."""
import ast
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'annlite_tpu', 'benchmarks', 'tests'}
YARDSTICK = ('reference.py', 'compare.py', 'datasets.py', 'traffic.py', 'rooflines')
MODULES = sorted(HOME.rglob('*.py'))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split('.')[0])
    return names


def test_modules_found():
    assert len(MODULES) > 20
    assert HOME / 'reference.py' in MODULES


@pytest.mark.parametrize('path', MODULES, ids=lambda p: str(p.relative_to(HOME)))
def test_no_jax_package_or_its_stack(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize('path', [p for p in MODULES
                                  if p.relative_to(HOME).parts[0] in YARDSTICK],
                         ids=lambda p: str(p.relative_to(HOME)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert 'annlite_torch' not in top_level_imports(path)


def test_names_compared_whole(tmp_path):
    p = tmp_path / 'm.py'
    p.write_text('import annlite_torch.doc\nfrom jaxlib import x\nimport numpy as jax_like\n')
    assert top_level_imports(p) == {'annlite_torch', 'jaxlib', 'numpy'}
