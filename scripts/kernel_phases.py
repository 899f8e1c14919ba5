#!/usr/bin/env python3
"""Where the time of two of annlite_torch's kernels goes, on one NVIDIA GPU.

    python3 scripts/kernel_phases.py

1. ``beam_pq`` (``annlite_torch/csrc/beam_pq.cu``): builds a copy of the
   kernel under ``build/kernel_phases/`` in which thread 0 of each CTA adds
   ``clock64()`` deltas per phase (table staging, seed, frontier, expansion,
   key building, sorts, write-back) into a device array, checks that the copy
   returns what the kernel returns, and prints microseconds per iteration and
   phase (at the card's maximum SM clock) on a random degree-32 graph of
   131,072 rows, PQ64 u8 codes, ef 128, B 8, at Q = 64 and 1.
2. ``lane8_merge``: CUDA-event times (L2 flushed before each run, the host
   out of the window) of the kernel over 128 and 256 blocks at Q = 64 and 1
   with 1, 2, 4, 8 and 16 block ranges per lane class, each checked against
   the plain version.

Prints one JSON line per measurement and the card's name and power limit.
Needs one card; a measurement aid, not part of the library.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPIN_US = 200  # device spin before a timed run's start event (as chip_smoke.py)
PHASES = ['stage', 'seed', 'frontier', 'expand', 'keys', 'sort', 'writeback']


def instrumented_source(src: str) -> str:
    """The kernel's source with a prof pointer in its arguments and a
    counter after each phase's closing barrier (thread 0's clock)."""
    def sub(old, new, count=1):
        assert src.count(old) == count, f'kernel source changed near: {old[:60]!r}'
        return src.replace(old, new)

    src = sub('int* iters_out;       // [nq] or null',
              'int* iters_out;       // [nq] or null\n  long long* prof;')
    seed = '  // ---- seed: score the entries, pad to L, sort by d ----'
    src = sub(seed, '  __syncthreads();\n  TICK(0)\n' + seed)
    src = sub('  const int nbr = a.B * a.r;\n', '  TICK(1)\n  const int nbr = a.B * a.r;\n')
    src = sub('    __syncthreads();\n    const int ns = *nsel;',
              '    __syncthreads();\n    TICK(2)\n    const int ns = *nsel;')
    src = sub('''    __syncthreads();
    // ---- merge''', '''    __syncthreads();
    TICK(3)
    // ---- merge''')
    src = sub('    bitonic<E>(k, a.p, key1);\n', '    TICK(4)\n    bitonic<E>(k, a.p, key1);\n'
              '    __syncthreads();\n    TICK(5)\n')
    src = sub('    bitonic<E>(k, a.p, key2);\n    __syncthreads();',
              '    TICK(4)\n    bitonic<E>(k, a.p, key2);\n    __syncthreads();\n    TICK(5)')
    src = sub('''    __syncthreads();
  }

  for (int i = tid; i < a.k; i += nthreads) {''', '''    __syncthreads();
    TICK(6)
  }

  for (int i = tid; i < a.k; i += nthreads) {''')
    src = sub('  const int q = blockIdx.x;\n  const int tid = threadIdx.x;\n',
              '  const int q = blockIdx.x;\n  const int tid = threadIdx.x;\n'
              '  long long t0 = clock64();\n'
              '#define TICK(n) if (tid == 0) { const long long t1 = clock64(); '
              'a.prof[q * 8 + n] += t1 - t0; t0 = t1; }\n')
    src = sub('int threads, int smem_tab, void* stream) {',
              'int threads, int smem_tab, void* prof, void* stream) {')
    src = sub('  a.p = p;\n', '  a.p = p;\n  a.prof = static_cast<long long*>(prof);\n')
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('kernel_phases: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from annlite_torch.ops import _ext
    from annlite_torch.ops import beam as bm
    from annlite_torch.ops import fused_scan as fs

    _ext.build()
    dev = torch.device('cuda')

    def smi(query, fmt='csv,noheader'):
        return subprocess.run(['nvidia-smi', f'--query-gpu={query}', f'--format={fmt}'],
                              capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]

    mhz = float(smi('clocks.max.sm', 'csv,noheader,nounits'))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def cuda_ms(fn, reps=20):
        """chip_smoke.py's timer: L2 flushed, the start event behind a device
        spin that outlasts the host's enqueue of ``fn``."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(int(SPIN_US * mhz))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    # ---- beam_pq by phase ----
    out_dir = ROOT / 'build' / 'kernel_phases'
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / 'beam_pq_phases.cu').write_text(
        instrumented_source((_ext.CSRC / 'beam_pq.cu').read_text()))
    (out_dir / 'wgmma.cuh').write_text((_ext.CSRC / 'wgmma.cuh').read_text())
    lib_path = out_dir / 'libbeam_pq_phases.so'
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, '-o', str(lib_path),
                    str(out_dir / 'beam_pq_phases.cu')], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.annlite_beam_pq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p] * 2
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    n, r, m, kc, L, B, iters = 131072, 32, 64, 256, 128, 8, 32
    adj = torch.randint(0, n, (n, r), device=dev, generator=g, dtype=torch.int32)
    adj[torch.rand((n, r), device=dev, generator=g) < 0.1] = -1
    codes = torch.randint(0, kc, (n, m), device=dev, generator=g,
                          dtype=torch.int32).to(torch.uint8)
    dtable = torch.rand((64, m, kc), device=dev, generator=g) * 10
    entry = torch.randint(0, n, (64, 1), device=dev, generator=g, dtype=torch.int32)
    plan = bm.beam_pq_plan(L, B, r, m, kc)
    for nq in (64, 1):
        dt, ent = dtable[:nq].contiguous(), entry[:nq].contiguous()
        d = torch.empty((nq, L), device=dev)
        ids = torch.empty((nq, L), dtype=torch.int32, device=dev)
        its = torch.empty((nq,), dtype=torch.int32, device=dev)
        prof = torch.zeros((nq, 8), dtype=torch.int64, device=dev)
        err = lib.annlite_beam_pq(adj.data_ptr(), ent.data_ptr(), codes.data_ptr(),
                                  dt.data_ptr(), d.data_ptr(), ids.data_ptr(), its.data_ptr(),
                                  n, r, 1, m, kc, nq, L, B, iters, L, 1, plan.sort_len,
                                  plan.threads, int(plan.table_in_smem), prof.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        want = bm.beam_pq_kernel(adj, ent, codes, dt, L, L, B, iters)
        if err or not (torch.equal(want[0], d) and torch.equal(want[1], ids)):
            print('kernel_phases: the instrumented copy differs from beam_pq', file=sys.stderr)
            return 1
        total = prof.sum(0).tolist()
        n_it = int(its.sum())
        us = {p: total[i] / n_it / mhz for i, p in enumerate(PHASES)}
        us['stage'], us['seed'] = total[0] / nq / mhz, total[1] / nq / mhz  # once a query
        us['keys'] /= 2  # two sorts an iteration: per sort
        us['sort'] /= 2
        print(json.dumps({'kernel': 'beam_pq', 'q': nq, 'plan': plan._asdict(),
                          'mean_iterations': n_it / nq, 'max_iterations': int(its.max()),
                          'us': us, 'us_per_iteration': sum(
                              v for p, v in us.items() if p not in ('stage', 'seed'))
                          + us['keys'] + us['sort'],
                          'ms_kernel': cuda_ms(lambda: bm.beam_pq_kernel(
                              adj, ent, codes, dt, L, L, B, iters))}), flush=True)

    # ---- lane8_merge by range count ----
    libf = _ext.library('fused_scan')
    for nq in (64, 1):
        for nb in (128, 256):
            s = torch.randint(0, 4, (nq, nb * 256), device=dev, generator=g).float()
            rows = torch.randperm(nq * nb * 256, device=dev, generator=g,
                                  dtype=torch.int32).reshape(nq, -1)
            want = fs._lane8_merge_ref(s, rows)
            s8 = torch.empty((nq, 1024), device=dev)
            r8 = torch.empty((nq, 1024), dtype=torch.int32, device=dev)
            line = {'kernel': 'lane8_merge', 'q': nq, 'nb': nb,
                    'plan_ranges': fs.lane8_merge_plan(nq, nb), 'ms_by_ranges': {}}
            for ranges in (1, 2, 4, 8, 16):
                def run():
                    return libf.annlite_lane8_merge(
                        s.data_ptr(), rows.data_ptr(), s8.data_ptr(), r8.data_ptr(), nq, nb,
                        ranges, torch.cuda.current_stream().cuda_stream)

                if run() != 0:
                    return 1
                torch.cuda.synchronize()
                if not (torch.equal(s8, want[0]) and torch.equal(r8, want[1])):
                    print(f'kernel_phases: lane8_merge with {ranges} ranges differs',
                          file=sys.stderr)
                    return 1
                line['ms_by_ranges'][ranges] = cuda_ms(run)
            print(json.dumps(line), flush=True)
    print(smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
