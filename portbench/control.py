"""The control of a cell: the reference put in the program's place, computed
in the precision below the one its configuration states (the
configuration's ``control``), and judged by the same comparison as a run.
It has to come out not correct.  The benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

Prints one JSON line per seed: the numbers compared and whether the control
passed them.  The control answers the cell's own request sequence (its
pool, batch and filter draws) at the cell's own size, enough requests to
cover the pool once and at least 2,000.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def control_records(xb, xq, cols, config, t, n_requests: int, precision: str):
    """The control's answers to the first ``n_requests`` window requests,
    in the records' format a run produces."""
    from .compare import OPS
    from .reference import exact_topk

    masks = {}
    for vi, v in enumerate(t.values):
        masks[vi] = (None if v is None else
                     torch.from_numpy(OPS[t.filter['op']](cols[t.filter['column']], v)))
    ans = exact_topk(xq, xb, config['annlite']['metric'], t.limit, masks, precision=precision)
    ans = {vi: (i.cpu().numpy(), d.cpu().numpy()) for vi, (i, d) in ans.items()}
    col = cols[t.filter['column']] if t.filter else None
    records = []
    for i in range(n_requests):
        rows, value = t.request(i)
        vi = t.values.index(value)
        ids, dists = ans[vi][0][rows], ans[vi][1][rows]
        rec = {'rows': rows, 'value_index': vi, 'error': None,
               'ids': [[str(int(r)) for r in row if r >= 0] for row in ids],
               'dists': [d[ids[j] >= 0] for j, d in enumerate(dists)]}
        if t.filter and t.include_metadata:
            rec['tags'] = [[float(col[r]) for r in row if r >= 0] for row in ids]
        records.append(rec)
    return records


def run_control(bench, cell_name: str, seed: int, device: str, n_requests=None,
                overrides=None, precision=None):
    from . import compare, reference
    from .harness import configure, make_data
    from .traffic import Traffic

    reference.no_tf32()
    config, mix = configure(bench, bench.cell(cell_name), overrides)
    t = Traffic(mix, seed)
    xb, xq, cols = make_data(config, t.pool, seed)
    dev = torch.device(device)
    xb_t, xq_t = torch.from_numpy(xb).to(dev), torch.from_numpy(xq).to(dev)
    if n_requests is None:
        n_requests = max(-(-t.pool // t.batch), 2000)
    precision = precision or config['control']
    records = control_records(xb_t, xq_t, cols, config, t, n_requests, precision)
    col = cols[t.filter['column']] if t.filter else None
    res = compare.judge(records, xb_t, xq_t, config['annlite']['metric'], t.limit, col,
                        t.filter, t.values,
                        t.filter['column'] if (t.filter and t.include_metadata) else None,
                        config['limits'])
    return {'workload': cell_name, 'seed': seed, 'precision': precision,
            'requests': n_requests, 'correct': res['correct'], 'dist_err': res['dist_err'],
            'recall_at_10': res['recall_at_10'], 'failed': res['failed'],
            'faults': res['faults'], 'checks': res['checks']}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('control: no CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench.control import run_control as run
    from portbench.harness import Bench

    bench = Bench(ROOT / 'BENCHMARK.json')
    for seed in args.seeds:
        t = time.perf_counter()
        out = run(bench, args.workload, seed, 'cuda')
        out['seconds'] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
