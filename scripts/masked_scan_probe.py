#!/usr/bin/env python3
"""Registers of the masked exact scan's kernels, and the scan at the
filtered graph cell's shape, on one NVIDIA GPU.

    python3 scripts/masked_scan_probe.py [--reps N]

Builds the kernels and prints ptxas's registers and spills of each
``masked_scan`` instance and of the merge (``nvcc -Xptxas -v``), and the
CTAs an SM holds (``masked_scan_info``).  Then, over
262,144 clustered integer rows of 96 dims in 0..255 and 64 queries (every
sum exact in float32), k = 10, at 5, 15 and 20% of rows passing and in both
metrics: the kernel held bit-equal to its plain twin on the card, and both
timed in turns (CUDA-event medians of ``--reps``, L2 flushed, the start
behind a 200 us device spin), beside the bound from the passing rows' bytes
and the float32 FMA rate; then the scan's and the merge's device times
apart (``torch.profiler``) at 0, 5, 20 and 100% of rows passing and k 1,
10, 32 and 256; then a CTA's time by phase, from a copy built with its
phase clocks (``build/masked_scan_probe/``).  Exits non-zero when the
kernel and the twin differ.  The kernel's edges are
``tests/test_torch_masked_scan_card.py``'s.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPIN_US = 200
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('masked_scan_probe: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    from annlite_torch.ops import _ext
    from annlite_torch.ops import masked_scan as msc

    _ext.build()
    out = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, '-Xptxas', '-v', '-o', '/dev/null',
                          str(_ext.CSRC / 'masked_scan.cu')], capture_output=True, text=True)
    emit({'ptxas': [ln.strip() for ln in out.stderr.splitlines()
                    if 'entry function' in ln or 'Used' in ln or 'spill' in ln]})
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip()
    emit({'nvidia_smi': smi})
    mhz = float(smi.split(',')[-1].split()[0])
    dev = torch.device('cuda')
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def cuda_ms(fn):
        for _ in range(2):
            fn()
        times = []
        for _ in range(args.reps):
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

    n, dim, nq, k = 262_144, 96, 64, 10
    rng = np.random.default_rng(24)
    cent = rng.integers(0, 200, (1024, dim))
    x = np.clip(cent[rng.integers(0, 1024, n)] + rng.integers(-24, 25, (n, dim)), 0, 255)
    q = np.clip(x[rng.integers(0, n, nq)] + rng.integers(-6, 7, (nq, dim)), 0, 255)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    q = torch.from_numpy(q.astype(np.float32)).to(dev)
    emit({'plan': msc.masked_scan_plan(n, nq, k)._asdict(),
          'info': {f'{slots} {b} {v}': msc.masked_scan_info(slots, b, v)
                   for slots in (32, 256) for b in (4, 2) for v in (True, False)}})
    bad = 0
    for sel in (0.05, 0.15, 0.2):
        m = torch.from_numpy(rng.random(n) < sel).to(dev)
        p = int(m.sum())
        nbytes = n + p * dim * 4 + nq * dim * 4 + nq * k * 8
        bound = max(nbytes / HBM_BYTES_PER_S, 2.0 * nq * p * dim / FP32_OPS_PER_S) * 1e3
        for euclid in (True, False):
            d, ids = msc.masked_scan_kernel(x, q, m, euclid, k)
            td, ti = msc._masked_scan_ref(x, q, m, euclid, k)
            torch.cuda.synchronize()
            equal = bool(torch.equal(d, td) and torch.equal(ids, ti))
            bad += not equal
            emit({'selectivity': sel, 'metric': 'l2' if euclid else 'ip', 'passing_rows': p,
                  'bit_equal': equal,
                  'kernel_ms': [cuda_ms(lambda: msc.masked_scan_kernel(x, q, m, euclid, k)),
                                cuda_ms(lambda: msc.masked_scan_kernel(x, q, m, euclid, k))],
                  'plain_ms': cuda_ms(lambda: msc._masked_scan_ref(x, q, m, euclid, k)),
                  'bound_ms': bound})
    # the scan and the merge apart (torch.profiler's device times), by the
    # share of rows passing and by k: where the time goes
    from torch.profiler import ProfilerActivity, profile

    x, q = x / 255.0, q / 255.0  # any order of sums will do here
    for sel in (0.0, 0.05, 0.2, 1.0):
        m = torch.from_numpy(rng.random(n) < sel).to(dev)
        for kk in (1, 10, 32, 256):
            for _ in range(3):
                msc.masked_scan_kernel(x, q, m, False, kk)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    msc.masked_scan_kernel(x, q, m, False, kk)
                torch.cuda.synchronize()
            us = {}
            for ev in prof.key_averages():
                name = 'merge' if 'merge' in ev.key else 'scan' if 'masked_scan' in ev.key else None
                if name:
                    t = getattr(ev, 'device_time_total', None) or ev.cuda_time_total
                    us[name] = t / 10
            emit({'profile': {'selectivity': sel, 'k': kk, 'us_per_call': us}})
    # where a CTA's time goes: a copy whose phase clocks add thread 0's
    # clock64() deltas (prologue, compaction, loads and products, the
    # products' write-out, selection, the lists' write-out) per CTA
    lib = phase_library()
    big, bigq = x * 255.0, q * 255.0
    for sel in (0.05, 0.2):
        m = torch.from_numpy(rng.random(n) < sel).to(dev)
        for kk in (1, 10):
            plan = msc.masked_scan_plan(n, nq, kk)
            work = torch.empty(nq * plan.tiles * kk + nq + plan.tiles * (kk + 1),
                               dtype=torch.int64, device=dev)
            d = torch.empty((nq, kk), dtype=torch.float32, device=dev)
            ids = torch.empty((nq, kk), dtype=torch.int32, device=dev)
            bnd = work.data_ptr() + 8 * nq * plan.tiles * kk
            fr = bnd + 8 * nq
            for rep in range(3):
                torch.cuda.synchronize()
                lib.annlite_prof_zero()
                flush.zero_()
                err = lib.annlite_masked_scan(
                    big.data_ptr(), bigq.data_ptr(),
                    m.data_ptr(), work.data_ptr(), bnd, fr, fr + 4 * plan.tiles * kk, d.data_ptr(),
                    ids.data_ptr(), n, dim, nq, kk, 4, 0, plan.tile, plan.tiles,
                    plan.list_slots, plan.merge_warps, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
            assert err == 0, err
            prof = (ctypes.c_uint64 * (plan.tiles * 8))()
            lib.annlite_prof_read(prof, plan.tiles * 64)
            cyc = np.frombuffer(prof, dtype=np.uint64).reshape(plan.tiles, 8)[:, :6].astype(float)
            emit({'phases_us': {'selectivity': sel, 'k': kk,
                                'mean': dict(zip(PHASES, (cyc.mean(0) / mhz).round(3).tolist())),
                                'slowest_cta': dict(zip(PHASES, (cyc[cyc.sum(1).argmax()] / mhz)
                                                        .round(3).tolist())),
                                'cta_total_max': float(cyc.sum(1).max() / mhz)}})
    return 1 if bad else 0


PHASES = ['prologue', 'compaction', 'loads_products', 'products_out', 'selection', 'lists_out']


def phase_library():
    """The scan built with its phase clocks defined, under
    build/masked_scan_probe/, loaded."""
    import ctypes as c
    from annlite_torch.ops import _ext

    out = ROOT / 'build' / 'masked_scan_probe'
    out.mkdir(parents=True, exist_ok=True)
    head = (
        '#include <cuda_runtime.h>\n'
        '__device__ unsigned long long annlite_prof[65536];\n'
        '#define ANNLITE_SLOT_ (annlite_prof + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8)\n'
        '#define ANNLITE_MARK_START() do { if (threadIdx.x == 0) ANNLITE_SLOT_[7] = clock64(); '
        '} while (0)\n'
        '#define ANNLITE_MARK(p) do { if (threadIdx.x == 0) { const unsigned long long n_ = '
        'clock64(); ANNLITE_SLOT_[p] += n_ - ANNLITE_SLOT_[7]; ANNLITE_SLOT_[7] = n_; } } '
        'while (0)\n')
    tail = (
        '\nextern "C" int annlite_prof_read(void* out, int bytes) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, annlite_prof, bytes);\n}\n'
        'extern "C" int annlite_prof_zero() {\n  void* p = nullptr;\n'
        '  cudaGetSymbolAddress(&p, annlite_prof);\n'
        '  return (int)cudaMemset(p, 0, sizeof(annlite_prof));\n}\n')
    src = out / 'masked_scan_prof.cu'
    src.write_text(head + (_ext.CSRC / 'masked_scan.cu').read_text() + tail)
    lib_path = out / 'libmasked_scan_prof.so'
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, '-o', str(lib_path), str(src)], check=True)
    lib = c.CDLL(str(lib_path))
    lib.annlite_masked_scan.argtypes = _ext.SIGNATURES['masked_scan']['annlite_masked_scan']
    lib.annlite_prof_read.argtypes = [c.c_void_p, c.c_int]
    return lib


if __name__ == '__main__':
    sys.exit(main())
