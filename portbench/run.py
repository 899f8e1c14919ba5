"""Run one cell of the benchmark once, on the card this machine holds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints one JSON line last on standard
output (the end-to-end metrics with ``--trace 0``, the per-layer metrics with
``--trace 1``) and the numbers compared against the reference, each beside
its limit, last on standard error.  Without a CUDA card, or with fewer cards
than the cell asks for, it exits 2 and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the JAX package and its stack: none may be loaded in a run's process
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'annlite_tpu')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if args.seed < 0 or args.seconds <= 0:
        print('portbench: --seed must be >= 0 and --seconds > 0', file=sys.stderr)
        return 2
    if not (ROOT / 'annlite_torch').is_dir() or not (ROOT / 'BENCHMARK.json').is_file():
        print(f'portbench: {ROOT} holds no annlite_torch/ or no BENCHMARK.json: '
              'run from a checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench.harness import Bench

    bench = Bench(ROOT / 'BENCHMARK.json')
    try:
        cell = bench.cell(args.workload)
    except KeyError as e:
        print(f'portbench: {e}', file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell['chips']):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} '
              'available. No result.', file=sys.stderr)
        return 2

    from portbench.harness import run_cell

    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   device='cuda', t_process=T_PROCESS)
    loaded = sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f'portbench: the run loaded {", ".join(loaded)}; no result', file=sys.stderr)
        return 3
    try:  # bytes this process wrote (Linux): to write calls, and to storage
        with open('/proc/self/io') as f:
            io = dict(line.split(': ') for line in f.read().splitlines())
        out['detail'].update(wchar=int(io['wchar']), write_bytes=int(io['write_bytes']))
    except (OSError, KeyError, ValueError):
        pass
    try:  # the host the run shared: its CPU and load
        with open('/proc/cpuinfo') as f:
            cpu = next(line.split(':', 1)[1].strip() for line in f if line.startswith('model name'))
        out['detail']['host'] = {'cpu': cpu, 'cores': os.cpu_count(), 'load1': os.getloadavg()[0]}
    except (OSError, StopIteration):
        pass
    out['checks'] = out.pop('checks')  # the numbers compared come last
    print(json.dumps(out['detail']), file=sys.stderr)
    for name, c in out['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
