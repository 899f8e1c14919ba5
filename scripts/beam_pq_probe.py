#!/usr/bin/env python3
"""A short first run of ``beam_pq`` (``annlite_torch/csrc/beam_pq.cu``) on one
NVIDIA GPU: build, registers, bit-equality at every template and plan edge.

    python3 scripts/beam_pq_probe.py

Builds the kernels, prints ptxas's registers and spills of each
``beam_pq`` instance (``nvcc -Xptxas -v``), then holds ``beam_pq`` to the
eager loop with the plain scorer (ids and distances over the whole list) on
a random degree-32 graph of 131,072 rows (10% -1 pads), 8 entries a query
(a -1, a duplicate, a query with no valid entry): PQ64 u8 at ef 128, B 8,
Q = 64 and 1; u16 codes at K = 1024 (the table in L2); 3 iterations; 64,
2,048 and 4,096 sort slots (2, 4 and 8 keys a thread); M = 7 (code rows
read byte by byte).  Each line gives the first call's host time, the
iterations of the first queries, the plan, and CUDA-event medians of the
kernel and of the eager loop (no L2 flush).  Exits non-zero on a mismatch.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('beam_pq_probe: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from annlite_torch.ops import _ext
    from annlite_torch.ops import adc as ad
    from annlite_torch.ops import beam as bm

    t0 = time.time()
    _ext.build()
    print('build_s', time.time() - t0, flush=True)
    out = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, '-Xptxas', '-v', '-o', '/dev/null',
                          str(_ext.CSRC / 'beam_pq.cu')], capture_output=True, text=True)
    print('\n'.join(line for line in out.stderr.splitlines() if 'Used' in line), flush=True)

    dev = torch.device('cuda')
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    n, r = 131072, 32
    adj = torch.randint(0, n, (n, r), device=dev, generator=g, dtype=torch.int32)
    adj[torch.rand((n, r), device=dev, generator=g) < 0.1] = -1

    def event_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return sorted(times)[len(times) // 2]

    failed = False
    for tag, nq, m, kc, dtype, L, B, iters, e in (
            ('q64 u8 ef128', 64, 64, 256, torch.uint8, 128, 8, 32, 8),
            ('q1 u8 ef128', 1, 64, 256, torch.uint8, 128, 8, 32, 8),
            ('q64 u16 k1024 (table in L2)', 64, 64, 1024, torch.uint16, 128, 8, 32, 8),
            ('q64 iters3', 64, 64, 256, torch.uint8, 128, 8, 3, 8),
            ('q8 ef2048 B64 (4,096 slots)', 8, 64, 256, torch.uint8, 2048, 64, 8, 8),
            ('q5 m7', 5, 7, 256, torch.uint8, 40, 4, 20, 3),
            ('q9 ef16 B1 (64 slots)', 9, 64, 256, torch.uint8, 16, 1, 40, 2),
            ('q9 ef1024 B8 (2,048 slots)', 9, 64, 256, torch.uint8, 1024, 8, 12, 8)):
        codes = torch.randint(0, kc, (n, m), device=dev, generator=g,
                              dtype=torch.int32).to(dtype)
        dt = torch.rand((nq, m, kc), device=dev, generator=g) * 10
        entry = torch.randint(0, n, (nq, e), device=dev, generator=g, dtype=torch.int32)
        entry[0, 0] = -1
        if nq > 2:
            entry[1, :] = -1
            entry[2, 1] = entry[2, 0]

        def plain(ids, codes=codes, dt=dt):
            return ad._lut_pq_scores_ref(ids, codes, dt)

        torch.cuda.synchronize()
        t = time.time()
        d, ids, its = bm.beam_pq_kernel(adj, entry, codes, dt, L, L, B, iters)
        torch.cuda.synchronize()
        first_s = time.time() - t
        d_ref, ids_ref = bm._beam_loop(adj, entry, L, B, iters, L, plain)
        ok = torch.equal(d, d_ref) and torch.equal(ids, ids_ref)
        line = {'tag': tag, 'ok': ok, 'first_call_s': first_s, 'iters': its.tolist()[:8],
                'plan': bm.beam_pq_plan(L, B, r, m, kc)._asdict()}
        if ok:
            line['ms'] = event_ms(lambda: bm.beam_pq_kernel(adj, entry, codes, dt, L, L, B,
                                                            iters))
            line['eager_plain_ms'] = event_ms(lambda: bm._beam_loop(adj, entry, L, B, iters,
                                                                    L, plain), 3)
        failed |= not ok
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
