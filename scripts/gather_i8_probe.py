#!/usr/bin/env python3
"""K3 (``gather_rerank``, ``annlite_torch/csrc/gather.cu``) and K9
(``adc_scores_i8``, ``annlite_torch/csrc/adc_i8.cu``) on one NVIDIA GPU:
build, registers, checks at their edges, and the times of their variants.

    python3 scripts/gather_i8_probe.py [--parent DIR]

Builds the kernels and prints ptxas's registers and spills of each instance
of the two sources (``nvcc -Xptxas -v``).  Checks K3 against its plain
version (rtol 1e-5, atol 1e-5 * (|q|^2 + |c|^2), ``chip_smoke.py``'s
tolerance) at D in {128, 768, 1024, 1100, 12288} with float4 loads and D =
100 and an unaligned base with scalar loads, Q in {1, 64, 65}, R in {1, 40,
128, 1000}, ids out of range, L2 and cosine; and K9 bit-equal to its plain
version at Q in {1, 3, 4, 5, 8, 9, 64, 100}, M = 64 (u8, K = 256; u16, K =
1024) and M = 258, N = 2^17 + 5, masked and unmasked, at the plan's tile
and at every tile width.  Then CUDA-event medians (L2 flushed before each
run, the start event behind a device spin that covers the host's enqueue):
K3 at Q in {64, 1}, R in {40, 128}, D = 768 with 1 to 8 warps per CTA,
beside its bound, the two-call yardstick ``index_select`` + ``torch.bmm``
and an empty launch; K9 at Q = 64 and 1, N = 2^20, M = 64, K = 256 u8 with
tiles of 1, 4 and 8, beside K5 and ``embedding_bag``.  With ``--parent
DIR`` (a directory holding an earlier ``gather.cu`` and ``adc_i8.cu``
whose entry points take ``(q, x, cand, out, nq, n, d, r, l2, vec4,
stream)`` and ``(t8, codes, mask, scale, offset, out, nq, m, k, n,
code_bytes, stream)``) the earlier kernels are built and timed in the same
run.  Prints one JSON line per part and the card's name and power
limit; exits non-zero on a mismatch.  A measurement aid, not part of the
library.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPIN_US = 200  # device spin before the start event, above any wrapper's enqueue
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', type=Path, default=None,
                    help='directory with the earlier gather.cu and adc_i8.cu to time beside')
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print('gather_i8_probe: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    from annlite_torch.enums import Metric
    from annlite_torch.math import l2_normalize
    from annlite_torch.ops import _ext
    from annlite_torch.ops import adc as ad
    from annlite_torch.ops import adc_i8 as ai
    from annlite_torch.ops import gather as ga

    _ext.build()
    ptxas = {}
    for src in ('gather.cu', 'adc_i8.cu'):
        out = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, '-Xptxas', '-v', '-o', '/dev/null',
                              str(_ext.CSRC / src)], capture_output=True, text=True)
        names = [ln.split("'")[1] if "'" in ln else ln for ln in out.stderr.splitlines()
                 if 'Compiling entry function' in ln]
        used = [ln.strip() for ln in out.stderr.splitlines() if 'Used' in ln]
        ptxas[src] = dict(zip(names, used))
    emit({'ptxas': ptxas})

    parent = {}
    if args.parent is not None:
        out_dir = ROOT / 'build' / 'gather_i8_probe'
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, argtypes in (('gather', [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                + [ctypes.c_void_p]),
                               ('adc_i8', [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                + [ctypes.c_void_p])):
            lib = out_dir / f'libparent_{name}.so'
            subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, '-o', str(lib),
                            str(args.parent / f'{name}.cu')], check=True)
            dll = ctypes.CDLL(str(lib))
            fn = getattr(dll, 'annlite_gather_rerank' if name == 'gather'
                         else 'annlite_adc_i8_scores')
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            parent[name] = fn

    def smi(query, fmt='csv,noheader'):
        return subprocess.run(['nvidia-smi', f'--query-gpu={query}', f'--format={fmt}'],
                              capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]

    mhz = float(smi('clocks.max.sm', 'csv,noheader,nounits'))
    dev = torch.device('cuda')
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def cuda_ms(fn, reps=20):
        """Median CUDA-event time of ``fn``, L2 flushed before each run, the
        start event behind a device spin."""
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

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    failures = []

    # ---------------- K3: checks ----------------
    def check_gather(tag, qf, x, cand, metric):
        out = ga.gather_rerank(qf, x, cand, int(metric))
        ref = ga._gather_rerank_ref(qf, x, cand, int(metric))
        cn = torch.sum(x[cand.long().clamp(0, x.shape[0] - 1)] ** 2, dim=-1)
        tol = 1e-5 * (torch.sum(qf * qf, dim=1)[:, None] + cn)
        diff = (out - ref).abs()
        ok = bool((diff <= 1e-5 * ref.abs() + tol).all())
        if not ok:
            failures.append(f'gather_rerank {tag} {metric.name}')
        return ok, float(diff.max())

    k3_checks = {}
    n3 = 1 << 16
    for d in (128, 768, 1024, 1100, 12288, 100):
        xb = torch.randn((n3 if d <= 1100 else 4096) * d + 1, device=dev, generator=g)
        nrows = xb.numel() // d
        views = {'aligned': xb[:nrows * d].view(nrows, d)}
        if d == 768:
            views['unaligned'] = xb[1:nrows * d + 1].view(nrows, d)  # 4-byte offset: scalar path
        for vtag, x in views.items():
            for nq_, r in ((1, 1), (1, 40), (64, 40), (65, 128), (64, 1000), (1, 1000)):
                if d == 12288 and nq_ * r > 4096:
                    continue
                q = torch.randn((nq_, d), device=dev, generator=g)
                cand = torch.randint(-5, nrows + 5, (nq_, r), device=dev, generator=g,
                                     dtype=torch.int32)
                for metric in (Metric.EUCLIDEAN, Metric.COSINE):
                    qm = q if metric == Metric.EUCLIDEAN else l2_normalize(q)
                    xm = x if metric == Metric.EUCLIDEAN else l2_normalize(x)
                    tag = f'd{d} {vtag} q{nq_} r{r} {metric.name.lower()}'
                    k3_checks[tag] = check_gather(tag, qm, xm, cand, metric)
    emit({'part': 'k3_checks', 'n': len(k3_checks),
          'passed': sum(ok for ok, _ in k3_checks.values()),
          'max_abs_err': max(e for _, e in k3_checks.values()),
          'info': {f'd{d}': ga.gather_info(d) for d in (128, 768, 1024, 1100, 12288)},
          'info_scalar_d100': ga.gather_info(100, False)})

    # ---------------- K9: checks ----------------
    k9_checks = {}

    def check_i8(tag, t8, codes, mask, sc, off, qt=None):
        q_, m_, k_ = t8.shape
        n_ = codes.shape[1]
        if qt is None:
            out = ai.adc_i8_kernel(t8, codes, mask, sc, off)
        else:
            plan = ai.adc_i8_plan(q_, n_, m_, k_, 1 if codes.dtype == torch.uint8 else 2, qt)
            out = ai._adc_i8_launch(plan, t8, codes, mask, sc, off,
                                    torch.empty((q_, n_), device=dev))
        ok = torch.equal(out, ai._adc_scores_i8_ref(t8, codes, mask, sc, off))
        if not ok:
            failures.append(f'adc_scores_i8 {tag} qt={qt}')
        k9_checks[f'{tag} qt={qt}'] = ok

    n9 = (1 << 17) + 5
    for m_, k_, dtype in ((64, 256, torch.uint8), (64, 1024, torch.uint16),
                          (258, 256, torch.uint8)):
        codes = torch.randint(0, k_, (m_, n9), device=dev, generator=g,
                              dtype=torch.int32).to(dtype)
        keep = (torch.rand(n9, device=dev, generator=g) < 0.5).to(torch.int8)
        ones = torch.ones(n9, dtype=torch.int8, device=dev)
        for nq_ in (1, 3, 4, 5, 8, 9, 64, 100):
            dt = torch.rand((nq_, m_, k_), device=dev, generator=g) * 10
            t8, sc, off = ai.quantize_dtable(dt)
            sc, off = sc[:, 0].contiguous(), off[:, 0].contiguous()
            for mtag, mk in (('unmasked', ones), ('mask 50%', keep)):
                tag = f'm{m_} k{k_} {str(dtype)[6:]} n{n9} q{nq_} {mtag}'
                check_i8(tag, t8, codes, mk, sc, off)
                if nq_ in (3, 9) and mtag == 'unmasked':
                    for qt in ai.QUERY_TILES:
                        check_i8(tag, t8, codes, mk, sc, off, qt)
    emit({'part': 'k9_checks', 'n': len(k9_checks), 'passed': sum(k9_checks.values()),
          'info': {f'q{q_} m{m_} k{k_} cb{cb}': ai.adc_i8_info(q_, 1 << 20, m_, k_, cb)
                   for q_, m_, k_, cb in ((64, 64, 256, 1), (1, 64, 256, 1), (4, 64, 256, 1),
                                          (64, 64, 1024, 2), (64, 258, 256, 1))}})
    if failures:
        emit({'failures': failures[:50]})
        return 1

    # ---------------- K3: times ----------------
    lib = _ext.library('gather')
    d, n = 768, 1 << 20
    x = l2_normalize(torch.randn((n, d), device=dev, generator=g))
    k3 = {}
    empty = torch.empty(1, device=dev)
    k3['empty_launch_ms'] = cuda_ms(lambda: empty.zero_())
    for nq_, r in ((64, 40), (64, 128), (1, 40), (1, 128)):
        q = l2_normalize(torch.randn((nq_, d), device=dev, generator=g))
        cand = torch.randint(0, n, (nq_, r), device=dev, generator=g, dtype=torch.int32)
        out = torch.empty((nq_, r), device=dev)
        st = torch.cuda.current_stream().cuda_stream
        row = {'plan': ga.gather_plan(nq_, r)._asdict(),
               'ms': cuda_ms(lambda: ga.gather_rerank(q, x, cand, 3)),
               'bound_ms': (nq_ * d * 4 + nq_ * r * d * 4 + nq_ * r * 8) / HBM_BYTES_PER_S * 1e3,
               'plain_ms': cuda_ms(lambda: ga._gather_rerank_ref(q, x, cand, 3))}
        for w in (1, 2, 4, 8):
            row[f'warps{w}_ms'] = cuda_ms(lambda: lib.annlite_gather_rerank(
                q.data_ptr(), x.data_ptr(), cand.data_ptr(), out.data_ptr(), nq_, n, d, r, 0, 1,
                w, st))
        cl = cand.long().view(-1)
        qv = q.view(nq_, d, 1)
        row['index_select_plus_bmm_ms'] = cuda_ms(
            lambda: torch.bmm(x.index_select(0, cl).view(nq_, r, d), qv))
        if 'gather' in parent:
            row['parent_ms'] = cuda_ms(lambda: parent['gather'](
                q.data_ptr(), x.data_ptr(), cand.data_ptr(), out.data_ptr(), nq_, n, d, r, 0, 1,
                st))
        k3[f'q{nq_} r{r}'] = row
    emit({'part': 'k3_times', **k3})
    del x

    # ---------------- K9: times ----------------
    npq, pm, pk = 1 << 20, 64, 256
    codes = torch.randint(0, pk, (pm, npq), device=dev, generator=g,
                          dtype=torch.int32).to(torch.uint8)
    ones = torch.ones(npq, dtype=torch.int8, device=dev)
    bag_idx = (codes.long().T + torch.arange(pm, device=dev)[None, :] * pk).contiguous()
    k9 = {}
    for nq_ in (64, 1):
        dt = torch.rand((nq_, pm, pk), device=dev, generator=g) * 10
        t8, sc, off = ai.quantize_dtable(dt)
        sc, off = sc[:, 0].contiguous(), off[:, 0].contiguous()
        out = torch.empty((nq_, npq), device=dev)
        row = {'plan': ai.adc_i8_plan(nq_, npq, pm, pk)._asdict(),
               'ms': cuda_ms(lambda: ai.adc_i8_kernel(t8, codes, ones, sc, off)),
               'k5_ms': cuda_ms(lambda: ad.adc_scores_kernel(dt, codes, ones))}
        for qt in ai.QUERY_TILES:
            plan = ai.adc_i8_plan(nq_, npq, pm, pk, 1, qt)
            row[f'qt{qt}_ms'] = cuda_ms(lambda: ai._adc_i8_launch(plan, t8, codes, ones, sc, off,
                                                                  out))
        bag_w8 = t8.float().permute(1, 2, 0).reshape(pm * pk, nq_).contiguous()
        row['embedding_bag_ms'] = cuda_ms(lambda: torch.nn.functional.embedding_bag(
            bag_idx, bag_w8, mode='sum'))
        if 'adc_i8' in parent:
            st = torch.cuda.current_stream().cuda_stream
            row['parent_ms'] = cuda_ms(lambda: parent['adc_i8'](
                t8.data_ptr(), codes.data_ptr(), ones.data_ptr(), sc.data_ptr(), off.data_ptr(),
                out.data_ptr(), nq_, pm, pk, npq, 1, st))
        k9[f'q{nq_}'] = row
    emit({'part': 'k9_times', 'shape': 'N=2^20 M=64 K=256 u8', **k9})
    print(smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
