#!/usr/bin/env python3
"""The IVF kernels K6 and K7 (``annlite_torch/csrc/ivf.cu``) on one NVIDIA
GPU: build, registers, bit-equality at their plan edges, and the times of
their variants.

    python3 scripts/ivf_probe.py

Builds the kernels and prints ptxas's registers and spills of each
``ivf.cu`` instance (``nvcc -Xptxas -v``).  Then, on 1,024 random blocks of
1,024 slots (M = 64; u8 codes at K = 256, u16 at K = 1,024), with -1 pads,
90% live slots, blocks 0 and 1 equal and group 1 of each block repeating
group 0, holds every body of ``ivf_scores`` (K7: its own with the table
staged or read through L2, or the lookup core) and of ``ivf_block_top2``
(K6: its own with the table resident or read through L2, and the core) to
the plain versions over the whole output at S in {1, 2, 15, 16, 17, 139,
140, 300} and Q in {1, 2, 7, 8, 9, 16, 17, 33}, also on a table of three
values (ties).  Then CUDA-event medians (L2 flushed before each run; the
start event recorded after a device spin that covers the host's enqueue,
and for some also without it) at the IVF-PQ phase's shapes: K7 at Q = 1..4,
S = 1 (its body's variants and table chunks, and the core) against
``embedding_bag``; K6 at Q = 8, S = 139 (its variants, query tiles of 2
and 1, the core with 2 and 4 group splits); K6's own body against the core
at Q = 8 to 64 over 139 and 256 selections (what ``ivf_plan``'s cost model
is fitted to); an empty launch; and K6 by phase (clock counters in an
instrumented copy of ``ivf.cu`` under ``build/ivf_probe/``).  Prints one
JSON line per part and the card's name and power limit; exits non-zero on
a mismatch.  A measurement aid, not part of the library.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPIN_US = 200  # device spin before the start event, above any wrapper's enqueue
K6_PHASES = ['stage', 'rounds', 'flush', 'end']


def instrumented_source(src: str) -> str:
    """``ivf.cu`` with a prof pointer in K6's arguments and thread 0's clock
    added per phase, each ended by a barrier: table staging, the rounds
    (lookups and insertion), the last flush, the range ends' merge."""
    def sub(old, new, count=1):
        assert src.count(old) == count, f'kernel source changed near: {old[:60]!r}'
        return src.replace(old, new)

    src = sub('  int cpt;                // CTAs of a query tile; grid = tiles * cpt\n',
              '  int cpt;\n  long long* prof;\n')
    src = sub('  const float inf = __int_as_float(0x7f800000);\n',
              '  const float inf = __int_as_float(0x7f800000);\n  long long t0 = clock64();\n'
              '#define TICK(n) if (threadIdx.x == 0) { const long long t1 = clock64(); '
              'a.prof[blockIdx.x * 4 + n] += t1 - t0; t0 = t1; }\n')
    src = sub('  // steps of a unit, a multiple of the ring',
              '  TICK(0)\n  // steps of a unit, a multiple of the ring')
    src = sub('  }\n  if (reader) flush<QT>(a, q0 + rq, open, lo, hi, rq, rl, mn1, mn2, gg);\n',
              '  }\n  __syncthreads();\n  TICK(1)\n'
              '  if (reader) flush<QT>(a, q0 + rq, open, lo, hi, rq, rl, mn1, mn2, gg);\n'
              '  __syncthreads();\n  TICK(2)\n')
    src = sub('  if (!part0 && !part1) return;\n',
              '  if (!part0 && !part1) { __syncthreads(); TICK(3) return; }\n')
    src = sub('    write_final(a, q, sel, rl, m1, m2, (uint32_t)g1, (uint32_t)g2);\n  }\n}\n',
              '    write_final(a, q, sel, rl, m1, m2, (uint32_t)g1, (uint32_t)g2);\n  }\n'
              '  __syncthreads();\n  TICK(3)\n}\n')
    src = sub('int qt, int smem_tab, int cpt, void* stream) {',
              'int qt, int smem_tab, int cpt, void* prof, void* stream) {')
    src = sub('  a.cpt = cpt;\n', '  a.cpt = cpt;\n  a.prof = (long long*)prof;\n')
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('ivf_probe: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from annlite_torch.ops import _ext
    from annlite_torch.ops import fused_scan as fs
    from annlite_torch.ops import ivf as iv

    _ext.build()
    out = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, '-Xptxas', '-v', '-o', '/dev/null',
                          str(_ext.CSRC / 'ivf.cu')], capture_output=True, text=True)
    names = [ln.split("'")[1] if "'" in ln else ln for ln in out.stderr.splitlines()
             if 'Compiling entry function' in ln]
    used = [ln.strip() for ln in out.stderr.splitlines() if 'Used' in ln]
    print(json.dumps({'ptxas': dict(zip(names, used))}), flush=True)

    def smi(query, fmt='csv,noheader'):
        return subprocess.run(['nvidia-smi', f'--query-gpu={query}', f'--format={fmt}'],
                              capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]

    mhz = float(smi('clocks.max.sm', 'csv,noheader,nounits'))
    dev = torch.device('cuda')
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def cuda_ms(fn, reps=20, spin=True):
        """Median CUDA-event time of ``fn``, L2 flushed before each run; with
        ``spin`` the start event waits behind a device spin, so the host has
        queued ``fn``'s launches before it fires."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            if spin:
                torch.cuda._sleep(int(SPIN_US * mhz))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    nblk, m = 1024, 64

    def blocks(k, dtype):
        cb = torch.randint(0, k, (nblk, m, 1024), device=dev, generator=g, dtype=torch.int32)
        cb[1] = cb[0]
        cb[:, :, 128:256] = cb[:, :, :128]
        mb = (torch.rand((nblk, 1024), device=dev, generator=g) < 0.9).to(torch.int8)
        mb[:, 128:256] = mb[:, :128]
        return cb.to(dtype), mb

    def k7_plans(nq, s, k):  # K7's bodies: its own with each table variant, the core
        if nq > iv.ROWS_MAX_QUERIES:
            return [iv._core_plan(nq, s, 1024, m, k)]
        return [iv._rows_plan(nq, s, 1024, m, k, st) for st in (False, True)]

    def k6_plans(nq, s, k):  # K6's bodies: its own with each table variant, the core
        return [iv._top2_plan(nq, s, 1024, m, k, 132, st) for st in (False, True)] + [
            iv._core_plan(nq, s, 1024, m, k)]

    checks = 0
    for k, dtype in ((256, torch.uint8), (1024, torch.uint16)):
        cb, mb = blocks(k, dtype)
        for s in (1, 2, 15, 16, 17, 139, 140, 300):
            ids = torch.randperm(nblk, device=dev, generator=g)[:s].to(torch.int32)
            if s > 2:
                ids[:2] = torch.tensor([0, 1], device=dev)
                ids[-1] = -1
            for nq in (1, 2, 7, 8, 9, 16, 17, 33):
                for ties in (False, True):
                    if ties and dtype == torch.uint16:
                        continue
                    dt = (torch.randint(0, 3, (nq, m, k), device=dev, generator=g).float() if ties
                          else torch.rand((nq, m, k), device=dev, generator=g) * 10)
                    ref = iv._ivf_scores_ref(ids, dt, cb)
                    for plan in k7_plans(nq, s, k):
                        if not torch.equal(iv.ivf_scores(ids, dt, cb, plan), ref):
                            print(f'ivf_probe: ivf_scores differs at k={k} S={s} Q={nq} '
                                  f'{plan.kernel} smem={plan.smem_tab}', file=sys.stderr)
                            return 1
                        checks += 1
                    ref6 = iv._ivf_block_top2_ref(ids, dt, cb, mb)
                    for plan in k6_plans(nq, s, k):
                        got = iv.ivf_block_top2(ids, dt, cb, mb, plan)
                        if not (torch.equal(got[0], ref6[0]) and torch.equal(got[1], ref6[1])):
                            print(f'ivf_probe: ivf_block_top2 differs at k={k} S={s} Q={nq} '
                                  f'{plan.kernel} smem={plan.smem_tab} ties={ties}',
                                  file=sys.stderr)
                            return 1
                        checks += 1
        torch.cuda.synchronize()
        print(json.dumps({'k': k, 'checks_bit_equal': checks}), flush=True)
        del cb, mb

    cb, mb = blocks(256, torch.uint8)
    t = {}
    ids1 = torch.tensor([517], dtype=torch.int32, device=dev)
    for nq in (1, 2, 3, 4):
        dt = torch.rand((nq, m, 256), device=dev, generator=g) * 10
        core = iv._core_plan(nq, 1, 1024, m, 256)
        t[f'k7_core_q{nq}'] = cuda_ms(lambda: iv.ivf_scores(ids1, dt, cb, core))
        if nq <= iv.ROWS_MAX_QUERIES:
            for st in (False, True):
                plan = iv._rows_plan(nq, 1, 1024, m, 256, st)
                t[f'k7_rows_q{nq}_{"smem" if st else "l2"}'] = cuda_ms(
                    lambda: iv.ivf_scores(ids1, dt, cb, plan))
                t[f'k7_rows_q{nq}_{"smem" if st else "l2"}_old_timer'] = cuda_ms(
                    lambda: iv.ivf_scores(ids1, dt, cb, plan), spin=False)
        if nq == 1:  # the staged table's chunk size
            for mc in (4, 16, 64):
                plan = iv._rows_plan(1, 1, 1024, m, 256)._replace(mc=mc)
                t[f'k7_rows_q1_smem_mc{mc}'] = cuda_ms(lambda: iv.ivf_scores(ids1, dt, cb, plan))
            idx = (cb[ids1.long()].long().permute(0, 2, 1)
                   + torch.arange(m, device=dev) * 256).reshape(-1, m).contiguous()
            w = dt.reshape(1, m * 256).T.contiguous()
            t['k7_embedding_bag'] = cuda_ms(
                lambda: torch.nn.functional.embedding_bag(idx, w, mode='sum'))
            t['k7_embedding_bag_old_timer'] = cuda_ms(
                lambda: torch.nn.functional.embedding_bag(idx, w, mode='sum'), spin=False)
    tiny = torch.zeros(1, device=dev)
    t['empty_launch'] = cuda_ms(lambda: tiny.zero_())

    ids8 = torch.randperm(nblk, device=dev, generator=g)[:139].to(torch.int32)
    dt8 = torch.rand((8, m, 256), device=dev, generator=g) * 10
    for st, qt in ((True, 2), (False, 2), (True, 1)):
        plan = iv._top2_plan(8, 139, 1024, m, 256, 132, st, qt)
        name = f'k6_qt{qt}_' + ('resident' if st else 'l2')
        t[name] = cuda_ms(lambda: iv.ivf_block_top2(ids8, dt8, cb, mb, plan))
        t[name + '_old_timer'] = cuda_ms(lambda: iv.ivf_block_top2(ids8, dt8, cb, mb, plan),
                                         spin=False)
        t[name + '_with_lane8_merge'] = cuda_ms(
            lambda: fs.lane8_merge(*iv.ivf_block_top2(ids8, dt8, cb, mb, plan)))

    # K6's own body against the lookup core (ivf_plan's K6_OWN_MS and
    # K6_CORE_MS are fitted to these), at the phase's 139 selections and 256
    for s_ in (139, 256):
        ids_ = torch.randperm(nblk, device=dev, generator=g)[:s_].to(torch.int32)
        for nq in (8, 16, 17, 24, 33, 64):
            dtq = torch.rand((nq, m, 256), device=dev, generator=g) * 10
            own = iv._top2_plan(nq, s_, 1024, m, 256, 132)
            core = iv._core_plan(nq, s_, 1024, m, 256)
            want = iv._ivf_block_top2_ref(ids_, dtq, cb, mb)
            for name, plan in (('own', own), ('core', core)):
                got = iv.ivf_block_top2(ids_, dtq, cb, mb, plan)
                if not all(map(torch.equal, got, want)):
                    print(f'ivf_probe: K6 {name} differs at S={s_} Q={nq}', file=sys.stderr)
                    return 1
                t[f'k6_{name}_s{s_}_q{nq}'] = cuda_ms(
                    lambda: iv.ivf_block_top2(ids_, dtq, cb, mb, plan))

    # the core's K6 at this shape with its plan's 2 group splits (70 CTAs),
    # and with 4 (140 CTAs: the card filled)
    ref6 = iv._ivf_block_top2_ref(ids8, dt8, cb, mb)
    for splits in (2, 4):
        core = iv._core_plan(8, 139, 1024, m, 256)
        core = core._replace(core=core.core._replace(splits=splits))
        if not all(map(torch.equal, iv.ivf_block_top2(ids8, dt8, cb, mb, core), ref6)):
            print(f'ivf_probe: the core K6 at {splits} splits differs', file=sys.stderr)
            return 1
        t[f'k6_core_qt8_splits{splits}'] = cuda_ms(
            lambda: iv.ivf_block_top2(ids8, dt8, cb, mb, core))
        t[f'k6_core_qt8_splits{splits}_old_timer'] = cuda_ms(
            lambda: iv.ivf_block_top2(ids8, dt8, cb, mb, core), spin=False)
    # K6 by phase: an instrumented copy of ivf.cu, checked against the kernel
    out_dir = ROOT / 'build' / 'ivf_probe'
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / 'ivf_phases.cu').write_text(
        instrumented_source((_ext.CSRC / 'ivf.cu').read_text()))
    for h in ('lookup.cuh', 'wgmma.cuh'):
        (out_dir / h).write_text((_ext.CSRC / h).read_text())
    lib_path = out_dir / 'libivf_phases.so'
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, '-o', str(lib_path),
                    str(out_dir / 'ivf_phases.cu')], check=True)
    plib = ctypes.CDLL(str(lib_path))
    plib.annlite_ivf_top2.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p] * 2
    plan = iv.ivf_plan('ivf_block_top2', 8, 139, 1024, m, 256)
    so = torch.empty((8, 139 * 256), device=dev)
    ro = torch.empty((8, 139 * 256), dtype=torch.int32, device=dev)
    ps = torch.empty((plan.grid, 2, plan.qt, 256), device=dev)
    pg = torch.empty((plan.grid, 2, plan.qt, 256), dtype=torch.int32, device=dev)
    cnt = torch.zeros(plan.tiles * 139, dtype=torch.int32, device=dev)
    prof = torch.zeros((plan.grid, 4), dtype=torch.int64, device=dev)
    err = plib.annlite_ivf_top2(ids8.data_ptr(), dt8.data_ptr(), cb.data_ptr(), mb.data_ptr(),
                                so.data_ptr(), ro.data_ptr(), ps.data_ptr(), pg.data_ptr(),
                                cnt.data_ptr(), 139, 8, m, 256, 1024, 1, plan.qt, 1, plan.cpt,
                                prof.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want = iv._ivf_block_top2_ref(ids8, dt8, cb, mb)
    if err or not (torch.equal(so, want[0]) and torch.equal(ro, want[1])):
        print('ivf_probe: the instrumented K6 differs', file=sys.stderr)
        return 1
    us = prof.double() / mhz
    print(json.dumps({'k6_phases_us_mean': dict(zip(K6_PHASES, us.mean(0).tolist())),
                      'k6_phases_us_max': dict(zip(K6_PHASES, us.max(0).values.tolist())),
                      'k6_cta_total_us_max': float(us.sum(1).max())}), flush=True)

    print(json.dumps({'ms': t, 'info': {
        'k6': iv.ivf_info('ivf_block_top2', 8, 139, 1024, m, 256),
        'k7': iv.ivf_info('ivf_scores', 1, 1, 1024, m, 256)}}), flush=True)
    print(smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
