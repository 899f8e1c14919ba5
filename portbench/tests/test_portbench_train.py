"""A configuration with a trained codec: ``train`` in its file makes set-up
call ``AnnLite.train`` once, on a sample of distinct corpus rows drawn from
the seed alone, before the first ``AnnLite.index``; one that needs training
and has no ``train`` is refused when it is read; the accepted
configurations, which train nothing, make the same calls as before."""
import json
import shutil

import numpy as np
import pytest

from portbench.harness import HERE, ROOT, Bench, configure, make_data, run_cell, train_rows

# bf16 rerank rows: each element of a unit row is rounded by at most 2^-9 of
# itself, so 1 - q.x moves by at most 2^-9 (|q||x| = 1), 2^-10 = 9.77e-4 of
# cosine's scale 2; 1e-3 leaves the float32 sums room (read up to 8.9e-4 at d 32)
BF16_DIST_ERR = 1e-3
TINY_DATA = {'n_docs': 2048, 'ingest_batch': 512,
             'data': {'generator': 'synth_glove_like', 'kwargs': {'d': 32}}, 'tags': {},
             'control': 'bf16', 'train': {'sample': 1024}}
CODEC = {'n_dim': 32, 'metric': 'cosine', 'n_subvectors': 8, 'n_clusters': 16, 'rerank': 100}
TINY = {
    # recall: a codec of 16 centroids on 4-d subspaces shortlists 100 of
    # 2,048 rows loosely (0.66-0.98 over seeds 1-5); the limit keeps answers
    # from being empty or random, the test holds the harness, not the codec
    'tiny-pq': {**TINY_DATA, 'annlite': CODEC,
                'limits': {'dist_err': BF16_DIST_ERR, 'recall_at_10': 0.5}},
    'tiny-graph-pq': {**TINY_DATA,
                      'annlite': {**CODEC, 'rerank': 40, 'index_type': 'graph',
                                  'graph_build_mode': 'device', 'max_degree': 16,
                                  'ef_construction': 64, 'ef_search': 32},
                      'limits': {'dist_err': BF16_DIST_ERR, 'recall_at_10': 0.9}},
}
ACCEPTED = {'flat768.batch64': 'annlite-readme-768-flat',
            'graph128.batch64': 'sift-128-euclidean-graph'}


@pytest.fixture(scope='module')
def tiny_bench(tmp_path_factory):
    """A bench home with the two tiny codec configurations, each in a cell
    on a mix of 8 queries a request."""
    tmp = tmp_path_factory.mktemp('train')
    home = tmp / 'portbench'
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    (home / 'traffic' / 'batch8.json').write_text(json.dumps(
        {'call': 'search_numpy', 'batch': 8, 'limit': 10, 'pool': 64, 'filter': None,
         'warmup_requests': 2, 'profile_requests': 2}))
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for name, cfg in TINY.items():
        (home / 'configs' / f'{name}.json').write_text(json.dumps({'name': name, **cfg}))
        spec['configs'].append({**spec['configs'][0], 'name': name,
                                'file': f'portbench/configs/{name}.json'})
        spec['workloads'].append({'name': f'{name}.batch8', 'config': name,
                                  'traffic': 'batch8', 'chips': 1, 'why': 'a test'})
    (tmp / 'BENCHMARK.json').write_text(json.dumps(spec))
    return Bench(tmp / 'BENCHMARK.json', home)


class Spy:
    """Records ``AnnLite.train`` and ``AnnLite.index`` calls in order."""

    def __init__(self, monkeypatch):
        from annlite_torch import AnnLite

        self.calls = []
        train, index = AnnLite.train, AnnLite.index

        def spy_train(ann, x, *a, **k):
            self.calls.append(('train', np.array(x, copy=True)))
            return train(ann, x, *a, **k)

        def spy_index(ann, docs, *a, **k):
            self.calls.append(('index', [(d.id, np.array(d.embedding), dict(d.tags))
                                         for d in docs]))
            return index(ann, docs, *a, **k)

        monkeypatch.setattr(AnnLite, 'train', spy_train)
        monkeypatch.setattr(AnnLite, 'index', spy_index)


@pytest.mark.parametrize('config', sorted(TINY))
def test_codec_configuration_trains_then_serves(tiny_bench, monkeypatch, config):
    spy = Spy(monkeypatch)
    seed = 2**31 + 7
    out = run_cell(tiny_bench, f'{config}.batch8', seed, 0.3, False, device='cpu')
    assert out['correct'] and out['failed'] == 0 and out['attempted'] > 0
    assert out['checks']['dist_err']['limit'] == BF16_DIST_ERR
    split = out['detail']['setup_split_s']
    assert list(split) == ['data', 'train', 'ingest', 'warmup'] and split['train'] > 0
    assert sum(split.values()) == pytest.approx(out['detail']['setup_s'])
    # one train call, first, on the seeded sample of the generated corpus
    assert [c[0] for c in spy.calls] == ['train'] + ['index'] * 4
    cfg, mix = configure(tiny_bench, tiny_bench.cell(f'{config}.batch8'))
    xb, _, _ = make_data(cfg, mix['pool'], seed)
    np.testing.assert_array_equal(spy.calls[0][1], xb[train_rows(seed, 2048, 1024)])


@pytest.mark.parametrize('config', sorted(TINY))
def test_codec_configuration_without_train_is_refused_when_read(tiny_bench, config):
    cell = tiny_bench.cell(f'{config}.batch8')
    with pytest.raises(ValueError, match="'train'"):
        configure(tiny_bench, cell, {'train': None})
    with pytest.raises(ValueError, match="'train'"):
        run_cell(tiny_bench, f'{config}.batch8', 1, 0.1, False, device='cpu',
                 overrides={'train': None})


@pytest.mark.parametrize('annlite', [{'n_subvectors': 8}, {'n_cells': 4},
                                     {'n_components': 16}])
def test_every_codec_argument_needs_train(tiny_bench, annlite):
    cell = tiny_bench.cell('tiny-pq.batch8')
    with pytest.raises(ValueError, match="'train'"):
        configure(tiny_bench, cell, {'train': None,
                                     'annlite': {'n_dim': 32, 'metric': 'cosine', **annlite}})
    # n_cells 1 is the flat index's default: nothing to train
    configure(tiny_bench, cell, {'train': None,
                                 'annlite': {'n_dim': 32, 'metric': 'cosine', 'n_cells': 1}})


@pytest.mark.parametrize('train', [{'sample': 0}, {'sample': -5}, {'sample': 1.5},
                                   {'sample': '1024'}, {'sample': True}, {},
                                   {'sample': 1024, 'iters': 5}, 1024])
def test_malformed_train_is_refused(tiny_bench, train):
    with pytest.raises(ValueError, match="'train' must be"):
        configure(tiny_bench, tiny_bench.cell('tiny-pq.batch8'), {'train': train})


def test_training_rows_depend_on_the_seed_alone():
    seed = 2**32 + 11
    a = train_rows(seed, 262144, 65536)
    assert len(a) == 65536 and len(np.unique(a)) == 65536
    assert a.min() >= 0 and a.max() < 262144 and np.all(np.diff(a) > 0)
    np.testing.assert_array_equal(a, train_rows(seed, 262144, 65536))
    assert not np.array_equal(a, train_rows(seed + 1, 262144, 65536))
    # capped at the corpus: every row once
    np.testing.assert_array_equal(train_rows(seed, 3000, 5000), np.arange(3000))


@pytest.mark.parametrize('cell', sorted(ACCEPTED))
def test_accepted_configurations_never_train_and_ingest_as_before(bench, monkeypatch, cell):
    spy = Spy(monkeypatch)
    over = {'n_docs': 3000, 'ingest_batch': 1000, 'traffic': {'pool': 200}}
    seed = 2**31 + 99
    out = run_cell(bench, cell, seed, 0.3, False, device='cpu', overrides=over)
    assert out['correct']
    assert list(out['detail']['setup_split_s']) == ['data', 'ingest', 'warmup']
    config, mix = configure(bench, bench.cell(cell), over)
    assert 'train' not in config and config['name'] == ACCEPTED[cell]
    xb, _, cols = make_data(config, mix['pool'], seed)
    # the parent's ingest: AnnLite.index over consecutive blocks of
    # ingest_batch rows, ids str(row), each row's generated tags
    assert [c[0] for c in spy.calls] == ['index'] * 3
    for (_, docs), lo in zip(spy.calls, range(0, 3000, 1000)):
        assert [d[0] for d in docs] == [str(r) for r in range(lo, lo + 1000)]
        np.testing.assert_array_equal(np.stack([d[1] for d in docs]), xb[lo:lo + 1000])
        assert [d[2] for d in docs] == [{c: float(cols[c][r]) for c in sorted(cols)}
                                        for r in range(lo, lo + 1000)]
