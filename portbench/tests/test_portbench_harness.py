"""The harness end to end on ``AnnLite(device='cpu')`` at a tiny size,
through a function call; the command line refuses without a card; a cell,
configuration, mix and per-layer metric added as files alone are found by
name."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import HERE, ROOT, Bench, run_cell

TINY = {'n_docs': 3000, 'ingest_batch': 1000, 'traffic': {'pool': 200}}


@pytest.mark.parametrize('cell', ['flat768.batch64', 'flat768.filtered1',
                                  'graph128.batch64', 'graph128.single'])
def test_request_loop_end_to_end_on_cpu(bench, cell):
    out = run_cell(bench, cell, 2**31 + 99, 0.5, False, device='cpu', overrides=TINY)
    assert out['correct'] and out['failed'] == 0 and out['attempted'] > 0
    assert list(out)[-1] == 'checks'
    names = set(out['metrics'])
    assert {'recall_at_10', 'setup_s'} <= names
    assert ('qps' in names) == cell.endswith('batch64')
    assert 'peak_device_gib' not in names  # no card, no device number
    assert out['device']['platform'] == 'cpu'
    assert out['metrics']['recall_at_10']['value'] >= 0.9


def test_traced_run_reports_per_layer_metrics_on_cpu():
    out = run_cell(Bench(), 'flat768.batch64', 5, 0.5, True, device='cpu', overrides=TINY)
    assert out['correct']
    # host spans only: device metrics need the card's trace
    assert set(out['metrics']) == {'facade_ms.qps', 'storage_ms.qps', 'index_ms.qps'}
    assert all(v['value'] >= 0 for v in out['metrics'].values())
    split = out['detail']['setup_split_s']
    assert sum(split.values()) == pytest.approx(out['detail']['setup_s'])


def cli(cwd, *args):
    return subprocess.run([sys.executable, 'portbench/run.py', *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_cli_refuses_without_a_card():
    r = cli(ROOT, '--workload', 'flat768.batch64', '--seed', '4294967311',
            '--seconds', '1', '--trace', '0')
    assert r.returncode != 0 and r.stdout.strip() == ''
    assert 'CUDA' in r.stderr


def test_cli_refuses_outside_a_checkout(tmp_path):
    shutil.copytree(HERE, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    r = cli(tmp_path, '--workload', 'flat768.batch64', '--seed', '1', '--seconds', '1',
            '--trace', '0')
    assert r.returncode != 0 and r.stdout.strip() == ''


def test_new_cell_config_mix_and_metric_found_by_name(tmp_path):
    home = tmp_path / 'portbench'
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cfg = json.loads((home / 'configs' / 'annlite-readme-768-flat.json').read_text())
    cfg.update(name='tiny-flat', n_docs=2500, ingest_batch=500)
    (home / 'configs' / 'tiny-flat.json').write_text(json.dumps(cfg))
    (home / 'traffic' / 'batch8.json').write_text(json.dumps(
        {'call': 'search_numpy', 'batch': 8, 'limit': 10, 'pool': 64, 'filter': None,
         'warmup_requests': 2, 'profile_requests': 2}))
    (home / 'metrics' / 'queries_per_req.qps.py').write_text(
        'def read(ctx):\n    return float(ctx.mix["batch"])\n')
    spec['configs'].append({**spec['configs'][0], 'name': 'tiny-flat',
                            'file': 'portbench/configs/tiny-flat.json'})
    spec['workloads'].append({'name': 'tiny.batch8', 'config': 'tiny-flat',
                              'traffic': 'batch8', 'chips': 1, 'why': 'a test'})
    spec['per_layer'].append({'name': 'queries_per_req.qps', 'unit': 'queries', 'better': 'higher',
                              'source': 'program_counter', 'layer': 'facade', 'moves': 'qps',
                              'workloads': ['tiny.batch8']})
    qps = next(m for m in spec['end_to_end'] if m['name'] == 'qps')
    qps['workloads'].append('tiny.batch8')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
    bench = Bench(tmp_path / 'BENCHMARK.json', home)
    out = run_cell(bench, 'tiny.batch8', 3, 0.3, False, device='cpu')
    assert out['correct'] and {'qps', 'recall_at_10', 'setup_s'} <= set(out['metrics'])
    out = run_cell(bench, 'tiny.batch8', 3, 0.3, True, device='cpu')
    assert out['metrics']['queries_per_req.qps']['value'] == 8.0
