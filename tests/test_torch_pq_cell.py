"""The SIFT PQ64 linear-scan deployment (configuration
``sift-128-euclidean-pq64-scan``, cell ``siftpq64.batch64``) on the CPU at a
small size.

``AnnLite(index_type='pq_scan', n_subvectors=64, rerank=40)`` over
``synth_sift_like`` rows is held to the plain reference
(`portbench/pq_reference.py`), both given one trained codec (the store loads
it from its model directory; CPU k-means at 64 x 256 takes about a minute):
codes equal but at float32 ties, returned distances exact, ids equal where
distances separate, and the deep select's shortlists (its plain twin) equal
the reference's but where a bucket keeps only its top 2.  Also: the
configuration and cell found by name and run end to end, the index spans,
the training spans, the ADC launch counters, and the ADC roofline counted
by hand."""
import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from annlite_torch import AnnLite, profile  # noqa: E402
from annlite_torch.codecs import PQCodec  # noqa: E402
from annlite_torch.doc import Doc  # noqa: E402
from annlite_torch.index.base import padded_mask  # noqa: E402
from annlite_torch.ops import adc  # noqa: E402
from portbench import pq_reference as ref  # noqa: E402
from portbench.datasets import synth_sift_like  # noqa: E402

N, NQ, M, K, RERANK, LIMIT = 8192, 64, 64, 256, 40, 10
BLOCK_N = adc.BLOCK_N
CELL = 'siftpq64.batch64'
CONFIG = 'sift-128-euclidean-pq64-scan'
# float32 rounds |x|^2 + |c|^2 - 2 x.c at a few units of 2^-24 of its
# terms, each at most |x|^2 + |c|^2: two codewords whose float64 distances
# lie within 2^-20 of that are a tie to the codec's float32 encode
TIE = 2.0 ** -20


def _ann(path, **kw):
    return AnnLite(n_dim=128, metric='euclidean', index_type='pq_scan', n_subvectors=M,
                   n_clusters=K, rerank=RERANK, data_path=str(path), device='cpu', **kw)


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    """Rows, queries, one trained codec and a store that loaded it."""
    xb, xq = synth_sift_like(N, NQ, seed=2**31 + 5)
    codec = PQCodec(128, M, K, n_init=1, seed=3, device='cpu').fit(xb[:4096], iter=4)
    path = tmp_path_factory.mktemp('pq_cell')
    first = _ann(path)
    first.model_path.mkdir(parents=True, exist_ok=True)
    codec.dump(first.model_path / 'pq.npz')
    first.close()
    ann = _ann(path)
    assert ann.is_trained
    ann.index([Doc(id=str(r), embedding=xb[r]) for r in range(N)])
    index = ann._container.index
    codes = torch.from_numpy(index._codes_t.host_view().T.astype(np.int64))
    cb = torch.from_numpy(codec.codebooks)
    ref_codes = ref.encode(torch.from_numpy(xb), cb)
    want = ref.search(torch.from_numpy(xq), torch.from_numpy(xb), ref_codes, cb, RERANK, LIMIT)
    yield {'ann': ann, 'index': index, 'xb': xb, 'xq': xq, 'cb': cb, 'codes': codes,
           'ref_codes': ref_codes, 'ref': want}
    ann.close()


def test_codes_equal_the_reference_but_at_float32_ties(built):
    codes, ref_codes = built['codes'], built['ref_codes']
    np.testing.assert_array_equal(built['cb'].numpy(), built['index'].pq_codec.codebooks)
    ties = ref.code_ties(torch.from_numpy(built['xb']), built['cb'], codes)
    differ = torch.nonzero(codes != ref_codes)
    assert len(ties['rows']) == len(differ) <= 1e-4 * codes.numel()
    assert torch.all(ties['gap'] >= 0) and torch.all(ties['gap'] <= TIE * ties['scale'])


def test_search_matches_the_reference(built):
    ann, xb, xq, want = built['ann'], built['xb'], built['xq'], built['ref']
    dists, ids = ann.search_numpy(xq, limit=LIMIT)
    rows = np.asarray([[int(i) for i in row] for row in ids])
    d = np.asarray(dists, dtype=np.float64)
    # exact: the float64 distance of each returned row (integer rows)
    exact = np.sum((xq[:, None, :].astype(np.float64) - xb[rows]) ** 2, axis=2)
    np.testing.assert_array_equal(d, exact)
    ref_d, ref_ids = want['dists'].numpy(), want['ids'].numpy()
    np.testing.assert_array_equal(d, ref_d)
    # ids equal where the distances separate them from their neighbours
    sep = np.ones_like(ref_d, dtype=bool)
    sep[:, 1:] &= ref_d[:, 1:] != ref_d[:, :-1]
    sep[:, :-1] &= ref_d[:, :-1] != ref_d[:, 1:]
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(rows[sep], ref_ids[sep])


@pytest.mark.parametrize('deep', [False, True])
def test_shortlists_equal_the_reference_but_where_a_bucket_is_full(built, deep):
    """The first pass's shortlist of 40 against the reference's exact top 40
    of ADC scores: the full scores and their sort (the CPU's path) keep the
    same rows; the deep select's twin (the card's path: the top 2 of each
    lane of a 4,096-row block, then 8 a lane class) loses a reference row
    only where its bucket holds two rows that score lower, or at the
    shortlist's edge, where float32 and float64 sums order otherwise."""
    index, xq = built['index'], built['xq']
    dt = index.pq_codec.dist_mat(xq)
    ct = index._codes_t.device_view()
    assert ct.shape[1] % BLOCK_N == 0 and ct.shape[1] >= 4 * BLOCK_N
    mt = torch.from_numpy(padded_mask(None, N, ct.shape[1]))
    got_d, got = adc.adc_topk(dt, ct, RERANK, mt, deep=deep)
    got = got.long().numpy()
    want = built['ref']['shortlist'].numpy()
    scores = adc.adc_scores_ref(dt, ct)[:, :N].numpy()
    lost = 0
    for i in range(NQ):
        for r in set(want[i]) - set(got[i]):
            lost += 1
            bucket = np.arange(r // BLOCK_N * BLOCK_N + r % 128, (r // BLOCK_N + 1) * BLOCK_N, 128)
            full = np.sum(scores[i, bucket] < scores[i, r]) >= 2
            assert deep and full or scores[i, r] >= got_d[i, -1].item(), (i, r)
    if not deep:
        assert lost == 0
    assert lost <= 0.05 * NQ * RERANK


def test_cell_found_by_name_and_runs_correct_on_cpu():
    from portbench.harness import Bench, configure, run_cell

    bench = Bench(ROOT / 'BENCHMARK.json')
    cell = bench.cell(CELL)
    assert (cell['config'], cell['traffic'], cell['chips']) == (CONFIG, 'batch64', 1)
    config, mix = configure(bench, cell)
    assert config['annlite'] == {'n_dim': 128, 'metric': 'euclidean', 'index_type': 'pq_scan',
                                 'n_subvectors': 64, 'n_clusters': 256, 'rerank': 40}
    assert config['train'] == {'sample': 100000} and config['n_docs'] == 1000000
    assert config['limits'] == {'dist_err': 1e-6, 'recall_at_10': 0.95}
    assert (config['control'], config['reduced'], config['data']['generator']) == \
        ('fp8', {}, 'synth_sift_like')
    assert (mix['call'], mix['batch'], mix['limit'], mix['filter']) == \
        ('search_numpy', 64, 10, None)
    entry = next(c for c in bench.spec['configs'] if c['name'] == CONFIG)
    assert entry['reduced'] == [] and entry['file'] == f'portbench/configs/{CONFIG}.json'
    assert {m['name'] for m in bench.end_to_end(cell)} == \
        {'qps', 'recall_at_10', 'peak_device_gib', 'setup_s'}
    layer = {m['name'] for m in bench.per_layer(cell)}
    assert {'adc_roofline.qps', 'train_s.setup_s', 'index_prep_ms.qps', 'index_dispatch_ms.qps',
            'index_wait_ms.qps', 'host_syncs_per_req.qps', 'h2d_kib_per_req.qps'} <= layer
    assert 'k1_roofline.qps' not in layer and 'beam_vec_roofline.qps' not in layer
    tiny = {'n_docs': 4096, 'ingest_batch': 1024, 'train': {'sample': 512},
            'traffic': {'pool': 256, 'warmup_requests': 4, 'profile_requests': 4}}
    out = run_cell(bench, CELL, 2**31 + 12345, 0.3, True, device='cpu', overrides=tiny)
    assert out['correct'] and out['failed'] == 0 and out['attempted'] >= 1
    assert out['checks']['dist_err']['value'] == 0.0
    train_s = out['metrics']['train_s.setup_s']['value']
    assert 0 < train_s <= out['detail']['setup_split_s']['train']


def _records_since(mark):
    rec = profile.records()
    keep = rec['seq'] > mark
    return {k: (v[keep] if isinstance(v, np.ndarray) else v) for k, v in rec.items()}


def _mark():
    seq = profile.records()['seq']
    return int(seq[-1]) if len(seq) else -1


def _parent_names(rec):
    pos = {int(s): i for i, s in enumerate(rec['seq'])}
    return [rec['name'][pos[int(p)]] if p >= 0 else '' for p in rec['parent']]


def test_index_spans_syncs_and_uploads(built):
    ann, xq, index = built['ann'], built['xq'], built['index']
    ann.search_numpy(xq[:1], limit=LIMIT)  # the first search uploads the codes
    mark = _mark()
    ann.search_numpy(xq, limit=LIMIT)
    rec = _records_since(mark)
    pairs = list(zip(rec['name'], _parent_names(rec)))
    for name, parent in (('annlite.index.prep', 'annlite.index'),
                         ('annlite.index.dispatch', 'annlite.index'),
                         ('annlite.index', 'annlite.search')):
        assert pairs.count((name, parent)) == 1, name
    # the query's and the mask's uploads, and the results' copy
    assert pairs.count(('annlite.index.wait', 'annlite.index.prep')) == 2
    assert pairs.count(('annlite.index.wait', 'annlite.index')) == 1
    root = np.flatnonzero(rec['root'] & (rec['name'] == 'annlite.search'))[-1]
    assert rec['host_syncs'][root] == 3
    n_pad = index._codes_t.device_view().shape[1]
    assert rec['h2d_bytes'][root] == xq.nbytes + n_pad


@pytest.mark.parametrize('kw, fitted', [
    ({'n_subvectors': 4, 'n_clusters': 16}, ['pq']),
    ({'n_subvectors': 4, 'n_clusters': 16, 'n_cells': 4}, ['vq', 'pq']),
    ({'n_components': 8}, ['projector']),
])
def test_training_spans(tmp_path, kw, fitted):
    x = np.random.default_rng(1).standard_normal((512, 16)).astype(np.float32)
    ann = AnnLite(n_dim=16, metric='euclidean', data_path=str(tmp_path), device='cpu', **kw)
    mark = _mark()
    ann.train(x)
    rec = _records_since(mark)
    ann.close()
    names, parents = list(rec['name']), _parent_names(rec)
    roots = [n for n, r in zip(names, rec['root']) if r]
    assert roots == ['annlite.train']
    children = sorted(n for n, p in zip(names, parents) if p == 'annlite.train')
    assert children == sorted([f'annlite.train.{c}' for c in fitted] + ['annlite.train.save'])


def test_adc_launch_counters():
    """The ADC core's wrappers count the table interleave (unless the core
    reads the table in place) and the splits' merge beside the core."""
    def counted(entry, plan, k, top2):
        tab = None if adc._in_place(plan, k) else torch.empty(1)
        c0 = profile.snapshot()['counters']
        adc._count_launches(entry, tab, plan, top2)
        c1 = profile.snapshot()['counters']
        return {n: c1.get(n, 0) - c0.get(n, 0) for n in
                ('launch.adc_interleave', f'launch.{entry}', 'launch.adc_merge')}

    # the cell: 64 queries, 1,048,576 padded rows in 256 blocks, M 64, K 256
    cell = adc.adc_plan(64, 256, BLOCK_N, 64, 256)
    assert (cell.qt, cell.splits) == (32, 1)
    assert counted('adc_block_top2', cell, 256, True) == \
        {'launch.adc_interleave': 1, 'launch.adc_block_top2': 1, 'launch.adc_merge': 0}
    one = adc.adc_plan(1, 4, BLOCK_N, 64, 256)
    assert one.qt == 1 and one.splits > 1
    assert counted('adc_block_top2', one, 256, True) == \
        {'launch.adc_interleave': 0, 'launch.adc_block_top2': 1, 'launch.adc_merge': 1}
    assert counted('adc_scores', one, 256, False) == \
        {'launch.adc_interleave': 0, 'launch.adc_scores': 1, 'launch.adc_merge': 0}


@pytest.mark.parametrize('nq,wide', [(64, True), (17, True), (32, True), (128, True),
                                     (1, False), (2, False), (8, False), (16, False),
                                     (33, False), (100, False)])
def test_adc_wide_tile_counter(nq, wide):
    """``adc.wide_tile`` counts each core launch that takes the wide tile of
    32 queries, once, beside the core's own counter, and no launch of a
    smaller tile; the deep select's other kernels never count it."""
    plan = adc.adc_plan(nq, 256, BLOCK_N, 64, 256)
    assert (plan.qt == adc.WIDE_TILE) == wide
    c0 = profile.snapshot()['counters']
    adc._count_launches('adc_block_top2', torch.empty(1), plan, True)
    adc._count_launches('adc_scores', torch.empty(1), plan, False)
    c1 = profile.snapshot()['counters']
    got = {n: c1.get(n, 0) - c0.get(n, 0) for n in
           ('adc.wide_tile', 'launch.adc_block_top2', 'launch.adc_scores')}
    assert got == {'adc.wide_tile': 2 * int(wide), 'launch.adc_block_top2': 1,
                   'launch.adc_scores': 1}


class _Ctx:
    def __init__(self, bench, config, mix, kernel_s, kernel_n):
        self.bench, self.config, self.mix = bench, config, mix
        self._s, self._n = kernel_s, kernel_n

    def kernels(self, names):
        return (sum(v for k, v in self._s.items() if any(n in k for n in names)),
                {n: sum(c for k, c in self._n.items() if n in k) for n in names})


def test_adc_roofline_counted_by_hand():
    from portbench.harness import Bench, configure

    bench = Bench(ROOT / 'BENCHMARK.json')
    rf = bench.roofline('adc')
    nbytes, adds = rf.bytes_ops(64, 1_000_000, 64, 256, 1)
    # each code byte once, each query's float32 table once, 1,024 candidates
    # a query of a float32 score and an int32 row
    assert nbytes == 64_000_000 + 64 * 64 * 256 * 4 + 64 * 1024 * 8 == 68_718_592
    assert adds == 64 * 1_000_000 * 64
    assert rf.ADDS_PER_S == 132 * 128 * 2 * 1.98e9
    bound = rf.bound_s(64, 1_000_000, 64, 256, 1)
    assert bound == adds / rf.ADDS_PER_S > nbytes / rf.HBM_BYTES_PER_S
    config, mix = configure(bench, bench.cell(CELL))
    reader = bench.reader('metrics', 'adc_roofline.qps')
    names = {'void (anonymous namespace)::adc_kernel<unsigned char, 1, 16>(Args)': (0.020, 16),
             'void (anonymous namespace)::interleave_kernel(float const*)': (0.001, 16),
             'lane8_merge_kernel(float const*, int const*)': (0.0005, 16),
             'block_top2_kernel': (1.0, 3)}
    ctx = _Ctx(bench, config, mix, {k: v[0] for k, v in names.items()},
               {k: v[1] for k, v in names.items()})
    assert reader.read(ctx) == pytest.approx(100.0 * bound * 16 / 0.0215)
    assert reader.read(_Ctx(bench, config, mix, {}, {})) is None


def test_reference_imports_nothing_of_the_program():
    path = ROOT / 'portbench' / 'pq_reference.py'
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split('.')[0])
    assert names == {'typing', 'torch'}
