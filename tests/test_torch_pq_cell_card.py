"""The cell ``siftpq64.batch64``'s store at its full size on the card, held to
the plain reference (`portbench/pq_reference.py`): the store is built as
the benchmark builds it (`portbench/harness.py`: 1,000,000
``synth_sift_like`` rows, the PQ64 codec trained on 100,000 of them on the
card, ingest by 32,768), and the reference is handed the codec's trained
codebooks.  Held: the stored codes against the reference's encode (equal
but at float32 ties), the kernels one search launches (the deep select,
never K5's full scores), every returned distance against float64, and each
query's top 10 and first-pass shortlist of 40 against the reference's.  The
counts are printed as one JSON line.  Every test is marked ``cuda`` and
skips without a card; on the card:

    python -m pytest -m cuda -s tests/test_torch_pq_cell_card.py
"""
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from annlite_torch import profile  # noqa: E402
from annlite_torch.index.base import padded_mask  # noqa: E402
from annlite_torch.ops import adc  # noqa: E402
from portbench import pq_reference as ref  # noqa: E402

pytestmark = pytest.mark.cuda

CELL = 'siftpq64.batch64'
SEED = 2**31 + 77
RERANK, LIMIT, BATCH = 40, 10, 64
TIE = 2.0 ** -20  # as in test_torch_pq_cell.py
LAUNCHES = ('launch.adc_interleave', 'launch.adc_block_top2', 'launch.adc_merge',
            'launch.lane8_merge', 'launch.adc_scores', 'adc.wide_tile')


@pytest.fixture(scope='module')
def cell():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    from portbench.harness import Bench, build, configure, make_data

    ref.no_tf32()
    bench = Bench(ROOT / 'BENCHMARK.json')
    config, mix = configure(bench, bench.cell(CELL))
    xb, xq, cols = make_data(config, int(mix['pool']), SEED)
    tmp = Path(tempfile.mkdtemp(prefix='pq-cell-'))
    ann, train_s = build(config, xb, cols, tmp / 'store', 'cuda', SEED)
    index = ann._container.index
    out = {'ann': ann, 'index': index, 'xb': xb, 'xq': xq, 'config': config,
           'cb': torch.from_numpy(index.pq_codec.codebooks).cuda(),
           'xb_t': torch.from_numpy(xb).cuda(), 'report': {'train_s': train_s}}
    yield out
    print(json.dumps({'pq_cell_card': out['report']}), flush=True)
    ann.close()
    shutil.rmtree(tmp, ignore_errors=True)


def test_codes_equal_the_reference_but_at_float32_ties(cell):
    index = cell['index']
    codes = torch.from_numpy(index._codes_t.host_view().T.astype(np.int64)).cuda()
    assert codes.shape == (cell['config']['n_docs'], 64)
    ties = ref.code_ties(cell['xb_t'], cell['cb'], codes)
    cell['report'].update(codes=codes.numel(), codes_differing=len(ties['rows']),
                          largest_tie_gap=float(ties['gap'].max()) if len(ties['gap']) else 0.0)
    assert torch.all(ties['gap'] >= 0) and torch.all(ties['gap'] <= TIE * ties['scale'])
    assert len(ties['rows']) <= 1e-4 * codes.numel()


def test_each_search_launches_the_deep_select_once(cell):
    ann, xq = cell['ann'], cell['xq']
    ann.search_numpy(xq[:BATCH], limit=LIMIT)
    before = profile.snapshot()['counters']
    ann.search_numpy(xq[BATCH:2 * BATCH], limit=LIMIT)
    after = profile.snapshot()['counters']
    got = {n: after.get(n, 0) - before.get(n, 0) for n in LAUNCHES}
    cell['report']['launches'] = got
    assert got == {'launch.adc_interleave': 1, 'launch.adc_block_top2': 1,
                   'launch.adc_merge': 0, 'launch.lane8_merge': 1, 'launch.adc_scores': 0,
                   'adc.wide_tile': 1}


@pytest.mark.parametrize('nq', [17, 32, 33, 64, 100])
def test_core_bit_equal_on_the_cells_codes(cell, nq):
    """The lookup core on the store's trained codes (1,000,000 rows padded to
    2^20), the wide tile (17, 32, 64 queries) and tiles of 16 (33, 100): K4's
    block pass and K5's scores bit-equal to their plain versions, half the
    rows masked; the same codes as IVF blocks of 1,024 rows through K7 and
    K6 on the core, with a pad selection."""
    from annlite_torch.ops import ivf
    index = cell['index']
    codes_t = index._codes_t.device_view()
    n = codes_t.shape[1]
    q_t = torch.from_numpy(cell['xq'][:nq]).cuda()
    dt = index.pq_codec.dist_mat(q_t).float().contiguous()
    mask = (torch.arange(n, device='cuda') % 3 != 1).to(torch.int8)
    plan = adc.adc_plan(nq, n // adc.BLOCK_N, adc.BLOCK_N, 64, 256)
    assert (plan.qt == adc.WIDE_TILE) == (nq in (17, 32, 64))
    got = adc.adc_block_top2(dt, codes_t, mask, adc.BLOCK_N)
    want = adc._adc_block_top2_ref(dt, codes_t, mask, adc.BLOCK_N)
    assert all(map(torch.equal, got, want))
    assert torch.equal(adc.adc_scores_kernel(dt, codes_t, mask),
                       adc._adc_scores_ref(dt, codes_t, mask))
    blocks = codes_t[:, :139 * 1024].reshape(64, 139, 1024).permute(1, 0, 2).contiguous()
    ids = torch.cat([torch.arange(138, dtype=torch.int32, device='cuda'),
                     torch.full((1,), -1, dtype=torch.int32, device='cuda')])
    mb = mask[:139 * 1024].reshape(139, 1024).contiguous()
    assert torch.equal(ivf.ivf_scores(ids, dt, blocks), ivf._ivf_scores_ref(ids, dt, blocks))
    core = ivf._core_plan(nq, 139, 1024, 64, 256)
    assert all(map(torch.equal, ivf.ivf_block_top2(ids, dt, blocks, mb, core),
                   ivf._ivf_block_top2_ref(ids, dt, blocks, mb)))


def test_answers_and_shortlists_against_the_reference(cell):
    ann, index, xb, xq = cell['ann'], cell['index'], cell['xb'], cell['xq']
    n = xb.shape[0]
    q_t = torch.from_numpy(xq).cuda()
    want = ref.search(q_t, cell['xb_t'], ref.encode(cell['xb_t'], cell['cb']), cell['cb'],
                      RERANK, LIMIT)
    ids, dists, short, short_d = [], [], [], []
    codes_t = index._codes_t.device_view()
    mt = torch.from_numpy(padded_mask(None, n, codes_t.shape[1])).cuda()
    for s in range(0, xq.shape[0], BATCH):
        d, i = ann.search_numpy(xq[s:s + BATCH], limit=LIMIT)
        dists.append(np.asarray(d, dtype=np.float64))
        ids.append(np.asarray([[int(x) for x in row] for row in i]))
        # the first pass as PQScanIndex.search runs it
        sd, sc = adc.adc_topk(index.pq_codec.dist_mat(q_t[s:s + BATCH]), codes_t, RERANK, mt)
        short.append(sc.long().cpu().numpy())
        short_d.append(sd.cpu().numpy())
    ids, dists = np.concatenate(ids), np.concatenate(dists)
    short, short_d = np.concatenate(short), np.concatenate(short_d)
    exact = np.sum((xq[:, None, :].astype(np.float64) - xb[ids]) ** 2, axis=2)
    ref_ids, ref_d = want['ids'].cpu().numpy(), want['dists'].cpu().numpy()
    ref_short = want['shortlist'].cpu().numpy()
    top10_same = [set(a) == set(b) for a, b in zip(ids, ref_ids)]
    dist_same = np.all(dists == ref_d, axis=1)
    short_diff = [len(set(a) - set(b)) for a, b in zip(ref_short, short)]
    cell['report'].update(
        queries=int(xq.shape[0]), largest_dist_gap=float(np.abs(dists - exact).max()),
        top10_ids_equal=int(sum(top10_same)), top10_dists_equal=int(dist_same.sum()),
        recall_vs_reference=float(np.mean([len(set(a) & set(b)) / LIMIT
                                           for a, b in zip(ids, ref_ids)])),
        shortlists_differing=int(sum(x > 0 for x in short_diff)),
        shortlist_rows_differing=int(sum(short_diff)))
    np.testing.assert_array_equal(dists, exact)
    assert np.all(np.diff(dists, axis=1) >= 0)
    assert dist_same.mean() >= 0.999
    assert sum(short_diff) <= 1e-3 * short.size
