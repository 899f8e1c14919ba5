#!/usr/bin/env python3
"""Drive annlite_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from ``annlite_torch/csrc`` (``nvcc``, one process
per source, all at once), then runs four phases, each printing one JSON line:

1. ``build``: build time, the card's name and ``nvidia-smi``'s name and power
   limit;
2. ``kernels_vs_plain``: every kernel against its plain PyTorch version on the
   card at the main path's shapes (D = 768 at N = 16384 and 2^20 with 1, 64
   and 100 queries; the facade's D = 128 at N = 131072 with 8 and 100) with
   rows equal, scores bit-equal for the scan kernels and the stated
   tolerance for the rerank kernel, and CUDA-event times;
3. ``flat``: ``scan_topk`` at N = 16384 (the block2 select), then a
   2^20 x 768 cosine ``FlatIndex``: recall@10 against a float32 brute force,
   batch 1 against row 0 of batch 64, batch-64 and batch-1 latency, masked
   search at 5% and 80% selectivity;
4. ``facade``: ``AnnLite`` with 100,000 docs of 128 dimensions (euclidean,
   a ``price`` tag): self-hits, a filtered search, updates and deletes,
   ``serving_searcher`` against ``search_numpy``, dump and reopen.

Each main-path run resets the kernels' launch counters just before it and
reads them just after; a kernel of the path that was never launched fails the
run.  The ``kernels`` line and the ``nvidia-smi`` line come last but one and
two; the last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that line.  Needs one card; imports nothing of JAX.
"""
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): memory rate, dense int8 tensor-core
# rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12

SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def main() -> int:
    if not (ROOT / 'annlite_torch' / 'csrc').is_dir():
        print('chip_smoke: run from a checkout of the repository '
              '(annlite_torch/ not found)', file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from annlite_torch import AnnLite
    from annlite_torch.doc import Doc
    from annlite_torch.enums import Metric
    from annlite_torch.index.flat import FlatIndex
    from annlite_torch.math import l2_normalize
    from annlite_torch.ops import _ext
    from annlite_torch.ops import fused_scan as fs
    from annlite_torch.ops import gather as ga
    from annlite_torch.ops.scan import quantize_rows_int8_device, scan_topk

    kernels = {'block_top2': fs.block_top2, 'lane8_merge': fs.lane8_merge,
               'gather_rerank': ga.gather_rerank}
    main_launches = {k: 0 for k in kernels}

    def drive(path_name: str, expected, fn):
        """Run one main path with the counters at 0; fail if a kernel it must
        go through was never launched."""
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in kernels.items()}
        for name in expected:
            if counts[name] == 0:
                fail(f'{path_name}: kernel {name} was never launched')
        for name, c in counts.items():
            main_launches[name] += c
        return out, counts

    # ---------------- 1. build and device ----------------
    t0 = time.perf_counter()
    _ext.build()
    build_s = time.perf_counter() - t0
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({'phase': 'build', 'build_s': build_s, 'device': name,
          'nvidia_smi': smi, 'torch': torch.__version__,
          'cuda': torch.version.cuda})

    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB

    def cuda_ms(fn, reps: int = 20):
        """Median CUDA-event time of ``fn`` over ``reps`` runs after two
        warm-up runs, with L2 flushed before each run (a caller finds the
        corpus and the shortlist rows cold)."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def host_ms(fn, reps: int = 30):
        """Median wall time of ``fn`` ending in a synchronize."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    # ---------------- 2. kernels against their plain versions ----------------
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    nq, d, br = 64, 768, 8192

    def corpus(n):
        x = torch.randn((n, d), device=dev, generator=g)
        # duplicated rows exercise the tie rules: rows 128..255 share block
        # 0's buckets with rows 0..127, rows 8192.. share lane classes with
        # rows 0.. across blocks
        x[128:256] = x[0:128]
        x[br:br + 2048] = x[0:2048]
        x = l2_normalize(x)
        x8, xs = quantize_rows_int8_device(x)
        return x, x8, xs

    q = torch.randn((nq, d), device=dev, generator=g)
    q8, qsc = quantize_rows_int8_device(q)
    # the main path's batch sizes: 64, 1 and 100 (the last two leave a
    # partial 16-query tile in block_top2)
    q100 = torch.randn((100, d), device=dev, generator=g)
    qsets = {64: (q8, qsc), 1: (q8[:1], qsc[:1]),
             100: quantize_rows_int8_device(q100)}
    err = {k: 0.0 for k in kernels}
    checks = []

    def check_scan(tag, q8, qsc, x8, xs, bias, coef, lane8):
        tag = f'{tag} q={q8.shape[0]}'
        s, r = fs.block_top2(q8, qsc, x8, xs, bias, br, coef)
        s_ref, r_ref = fs._fused_scan_ref(q8, qsc, x8, xs, bias, br, coef)
        if not (torch.equal(r, r_ref) and torch.equal(s, s_ref)):
            fail(f'block_top2 {tag}: rows or scores differ from the plain version')
        err['block_top2'] = max(err['block_top2'], (s - s_ref).abs().max().item())
        if lane8:
            s8, r8 = fs.lane8_merge(s, r)
            s8_ref, r8_ref = fs._lane8_merge_ref(s_ref, r_ref)
            if not (torch.equal(r8, r8_ref) and torch.equal(s8, s8_ref)):
                fail(f'lane8_merge {tag}: rows or scores differ from the plain version')
            err['lane8_merge'] = max(err['lane8_merge'], (s8 - s8_ref).abs().max().item())
        checks.append(f'block_top2{"+lane8_merge" if lane8 else ""} {tag}: '
                      'rows equal, scores bit-equal')
        return s, r

    def check_gather(tag, qf, x, cand, metric):
        """rtol 1e-5, atol 1e-5 * (|q|^2 + |c|^2): the rounding of a float32
        dot product of that size"""
        out = ga.gather_rerank(qf, x, cand, int(metric))
        ref = ga._gather_rerank_ref(qf, x, cand, int(metric))
        cn = torch.sum(x[cand.long().clamp(0, x.shape[0] - 1)] ** 2, dim=-1)
        tol = 1e-5 * (torch.sum(qf * qf, dim=1)[:, None] + cn)
        diff = (out - ref).abs()
        if not bool((diff <= 1e-5 * ref.abs() + tol).all()):
            fail(f'gather_rerank {tag} {metric.name}: outside rtol 1e-5, '
                 'atol 1e-5*(|q|^2+|c|^2)')
        err['gather_rerank'] = max(err['gather_rerank'], diff.max().item())
        checks.append(f'gather_rerank {tag} {metric.name.lower()} '
                      f'q{qf.shape[0]} r{cand.shape[1]}: within tolerance')

    # K2 shape: scan_topk's block2 select at N = 16384
    x_s, x8_s, xs_s = corpus(16384)
    bias_s = torch.zeros(16384, device=dev)
    for qq in qsets.values():
        check_scan('n=16384 d=768 cosine', *qq, x8_s, xs_s, bias_s, -1.0, False)
    # K1 shape: 2^20 x 768, cosine and L2, once with a 5% mask
    n = 1 << 20
    x, x8, xs = corpus(n)
    norms = torch.sum(x * x, dim=1)
    keep5 = torch.rand(n, device=dev, generator=g) < 0.05
    cases = [
        ('cosine', torch.zeros(n, device=dev), -1.0),
        ('l2', norms.clone(), -2.0),
        ('cosine mask5%', torch.where(keep5, 0.0, 3.4e38).float(), -1.0),
    ]
    for tag, bias, coef in cases:
        for qq in qsets.values():
            s, r = check_scan(f'n=2^20 d=768 {tag}', *qq, x8, xs, bias, coef, True)
            if tag == 'cosine' and qq[0] is q8:
                s_blk, r_blk = s, r
    # K3 at the flat path's shapes: cosine queries are normalized there, as
    # the corpus rows are
    cand = torch.randint(-5, n + 5, (nq, 40), device=dev, generator=g,
                         dtype=torch.int32)
    qf = q.contiguous()
    check_gather('n=2^20 d=768', l2_normalize(qf), x, cand, Metric.COSINE)
    check_gather('n=2^20 d=768', qf, x, cand, Metric.EUCLIDEAN)

    # the facade's shapes: 100,000 rows of D = 128 in a device view padded to
    # 131072 (the padding masked by BIG), L2 bias, batches of 8 and 100
    na, da, nreal = 131072, 128, 100_000
    xa = torch.randn((na, da), device=dev, generator=g) * 2.0
    xa[128:256] = xa[0:128]
    xa8, xas = quantize_rows_int8_device(xa)
    bias_a = torch.sum(xa * xa, dim=1) + torch.where(
        torch.arange(na, device=dev) < nreal, 0.0, 3.4e38).float()
    qa = torch.randn((100, da), device=dev, generator=g) * 2.0
    qa8, qasc = quantize_rows_int8_device(qa)
    for nqa in (100, 8):
        check_scan('n=131072 d=128 l2 padded', qa8[:nqa], qasc[:nqa], xa8, xas,
                   bias_a, -2.0, True)
    cand_a = torch.randint(-5, nreal + 5, (100, 40), device=dev, generator=g,
                           dtype=torch.int32)
    check_gather('n=131072 d=128', qa, xa, cand_a, Metric.EUCLIDEAN)
    check_gather('n=131072 d=128', l2_normalize(qa), l2_normalize(xa), cand_a,
                 Metric.COSINE)
    del xa, xa8, xas, bias_a, qa, qa8, qasc, cand_a, q100, qsets

    cos_bias = cases[0][1]
    times = {
        'block_top2': (cuda_ms(lambda: fs.block_top2(q8, qsc, x8, xs, cos_bias, br, -1.0)),
                       cuda_ms(lambda: fs._fused_scan_ref(q8, qsc, x8, xs, cos_bias, br, -1.0))),
        'lane8_merge': (cuda_ms(lambda: fs.lane8_merge(s_blk, r_blk)),
                        cuda_ms(lambda: fs._lane8_merge_ref(s_blk, r_blk))),
        'gather_rerank': (cuda_ms(lambda: ga.gather_rerank(qf, x, cand, 3)),
                          cuda_ms(lambda: ga._gather_rerank_ref(qf, x, cand, 3))),
    }
    block_ms_16k = cuda_ms(lambda: fs.block_top2(q8, qsc, x8_s, xs_s, bias_s, br, -1.0))
    block_plain_ms_16k = cuda_ms(lambda: fs._fused_scan_ref(q8, qsc, x8_s, xs_s, bias_s, br, -1.0))
    k1_ms = cuda_ms(lambda: fs.lane8_merge(*fs.block_top2(q8, qsc, x8, xs, cos_bias, br, -1.0)))
    nb = n // br
    bounds = {
        'block_top2': bound(n * d + 8 * n + nq * d + 4 * nq + nq * nb * 256 * 8,
                            2.0 * nq * n * d, INT8_OPS_PER_S),
        'lane8_merge': bound(nq * nb * 256 * 8 + nq * 1024 * 8,
                             2.0 * 8 * nq * 128 * nb * 2, FP32_OPS_PER_S),
        'gather_rerank': bound(nq * d * 4 + nq * 40 * d * 4 + nq * 40 * 8,
                               2.0 * nq * 40 * d, FP32_OPS_PER_S),
    }
    emit({'phase': 'kernels_vs_plain', 'checks': checks,
          'max_abs_err': err,
          'ms': {k: v[0] for k, v in times.items()},
          'plain_ms': {k: v[1] for k, v in times.items()},
          'block_top2_ms_n16384': block_ms_16k,
          'block_top2_plain_ms_n16384': block_plain_ms_16k,
          'k1_block_top2_plus_lane8_merge_ms': k1_ms,
          'shapes': 'Q=64 D=768; block_top2/lane8_merge N=2^20; gather R=40'})
    del x8, xs, norms, cases, cos_bias, s_blk, r_blk, cand, s, r
    del x

    # ---------------- 3. scan_topk (block2) and the flat index ----------------
    mask_s = torch.ones(16384, dtype=torch.int8, device=dev)
    qn = l2_normalize(q)
    (d_s, i_s), k2_counts = drive(
        'scan_topk n=16384', ['block_top2', 'gather_rerank'],
        lambda: scan_topk(qn, x8_s, xs_s, None, mask_s, 10, Metric.COSINE,
                          x_f32=x_s))
    # the rerank returns the exact distances of the rows it returns, sorted
    at_rows = 1.0 - torch.sum(qn[:, None, :] * x_s[i_s.long()], dim=-1)
    if not (torch.allclose(d_s, at_rows, rtol=1e-5, atol=1e-5)
            and bool((d_s[:, 1:] >= d_s[:, :-1]).all())):
        fail('scan_topk n=16384: distances are not the rows\' exact distances')
    exact_s = torch.sort(1.0 - qn @ x_s.T, dim=1, stable=True)
    recall_s = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(
        i_s.tolist(), exact_s.indices[:, :10].tolist())]))
    del x_s, x8_s, xs_s, exact_s

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    xn = rng.standard_normal((n, d), dtype=np.float32)
    index = FlatIndex(d, metric='cosine')
    index.add_with_ids(xn, np.arange(n))
    del xn
    ingest_s = time.perf_counter() - t0
    queries = torch.from_numpy(rng.standard_normal((nq, d), dtype=np.float32)).to(dev)
    masks = {sel: rng.random(n) < sel for sel in (0.05, 0.80)}

    def flat_path():
        run = index.device_searcher(limit=10)
        out = {'b64': run(queries), 'b1': run(queries[:1])}
        for sel, m in masks.items():
            out[sel] = index.device_searcher(limit=10, mask=m)(queries)
        return run, out

    (run, res), flat_counts = drive(
        'flat 2^20x768', ['block_top2', 'lane8_merge', 'gather_rerank'], flat_path)
    xdev = index._buf.device_view()
    exact = torch.sort(1.0 - l2_normalize(queries) @ xdev.T, dim=1, stable=True)
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(
        res['b64'][1].tolist(), exact.indices[:, :10].tolist())]))
    del exact
    if recall < 0.995:
        fail(f'flat recall@10 {recall} < 0.995')
    (d1, i1), (d64, i64) = res['b1'], res['b64']
    if not (torch.equal(i1[0], i64[0])
            and torch.allclose(d1[0], d64[0], rtol=1e-6, atol=0.0)):
        fail('flat batch 1: result differs from row 0 of batch 64')
    lat = {'batch64_ms': host_ms(lambda: run(queries)),
           'batch1_ms': host_ms(lambda: run(queries[:1]))}
    for sel, m in masks.items():
        rows = res[sel][1].cpu().numpy()
        if not m[rows].all():
            fail(f'flat mask {sel}: a returned row lies outside the mask')
        mrun = index.device_searcher(limit=10, mask=m)
        lat[f'mask{int(sel * 100)}pct_batch64_ms'] = host_ms(lambda: mrun(queries))
    emit({'phase': 'flat', 'scan_topk_n16384_recall_at_10': recall_s,
          'scan_topk_n16384_launches': k2_counts,
          'n': n, 'dim': d, 'metric': 'cosine', 'host_ingest_s': ingest_s,
          'recall_at_10_vs_fp32': recall, 'qps_batch64': nq / lat['batch64_ms'] * 1e3,
          'latency_ms': lat, 'masked_rows_in_mask': True,
          'batch1_equals_batch64_row0': True, 'launches': flat_counts,
          'peak_device_bytes': torch.cuda.max_memory_allocated()})
    del index, run, res, xdev
    torch.cuda.empty_cache()

    # ---------------- 4. the facade ----------------
    data_dir = ROOT / 'build' / 'chip_smoke_data'
    shutil.rmtree(data_dir, ignore_errors=True)
    nf, df = 100_000, 128
    frng = np.random.default_rng(SEED)
    centers = (frng.standard_normal((1024, df)) * 2.0).astype(np.float32)
    xf = (centers[frng.integers(0, 1024, nf)]
          + frng.standard_normal((nf, df))).astype(np.float32)
    prices = frng.uniform(0, 100, nf)
    qf_np = xf[:nq].copy()

    def facade_path():
        ann = AnnLite(n_dim=df, metric='euclidean', index_type='flat',
                      columns=[('price', float)], data_path=data_dir)
        t = time.perf_counter()
        for lo in range(0, nf, 20_000):
            ann.index([Doc(id=str(i), embedding=xf[i],
                           tags={'price': float(prices[i])})
                       for i in range(lo, min(lo + 20_000, nf))])
        ingest = time.perf_counter() - t
        _, ids = ann.search_numpy(qf_np[:16], limit=10)
        hits = sum(ids[i][0] == str(i) for i in range(16))
        if hits != 16:
            fail(f'facade self-hits {hits}/16')
        flt = {'price': {'$lt': 50.0}}
        for matches in ann.search_by_vectors(qf_np[:8], filter=flt, limit=10,
                                             include_metadata=True):
            if not matches or any(m.tags['price'] >= 50.0 for m in matches):
                fail('facade filtered search returned a doc outside the filter')
        upd = np.arange(1000, 1100)
        ann.update([Doc(id=str(i), embedding=xf[i] + 0.5,
                        tags={'price': float(prices[i])}) for i in upd])
        gone = [str(i) for i in range(2000, 2100)]
        ann.delete(gone)
        _, ids = ann.search_numpy(xf[2000:2100], limit=10)
        serve = ann.serving_searcher(limit=10)
        _, sids = serve(xf[2000:2064])
        if set(gone) & {i for row in ids + sids for i in row}:
            fail('facade returned a deleted doc')
        _, ids = ann.search_numpy(xf[upd[:16]] + 0.5, limit=1)
        if [row[0] for row in ids] != [str(i) for i in upd[:16]]:
            fail('facade update: updated docs do not find themselves')
        d_np, ids_np = ann.search_numpy(qf_np, limit=10)
        _, ids_sv = serve(qf_np)
        if ids_sv != ids_np:
            fail('facade serving_searcher ids differ from search_numpy')
        serve_ms = host_ms(lambda: serve(qf_np))
        ann.dump()
        ann.close()
        ann = AnnLite(n_dim=df, metric='euclidean', index_type='flat',
                      columns=[('price', float)], data_path=data_dir)
        d_re, ids_re = ann.search_numpy(qf_np, limit=10)
        if ids_re != ids_np or not all(np.array_equal(a, b) for a, b in zip(d_re, d_np)):
            fail('facade results differ after dump and reopen')
        ann.close()
        return ingest, serve_ms

    (ingest, serve_ms), facade_counts = drive(
        'facade 100k x 128', ['block_top2', 'lane8_merge', 'gather_rerank'],
        facade_path)
    shutil.rmtree(data_dir, ignore_errors=True)
    emit({'phase': 'facade', 'docs': nf, 'dim': df, 'metric': 'euclidean',
          'ingest_docs_per_s': nf / ingest, 'self_hits_16': 16,
          'filtered_ok': True, 'deleted_never_returned': True,
          'serving_equals_search_numpy': True, 'reopen_equal': True,
          'serving_ms_batch64': serve_ms, 'serving_qps': nq / serve_ms * 1e3,
          'launches': facade_counts})

    # ---------------- result ----------------
    src = {'block_top2': 'annlite_torch/csrc/fused_scan.cu',
           'lane8_merge': 'annlite_torch/csrc/fused_scan.cu',
           'gather_rerank': 'annlite_torch/csrc/gather.cu'}
    replaces = {'block_top2': 'annlite_tpu/ops/fused_scan.py:99',
                'lane8_merge': 'annlite_tpu/ops/fused_scan.py:121',
                'gather_rerank': 'annlite_tpu/ops/gather.py:31'}
    emit({'kernels': [
        {'name': k, 'route': 'cuda', 'source': src[k], 'replaces': replaces[k],
         'launches': main_launches[k], 'max_abs_err': err[k],
         'ms': times[k][0], 'plain_ms': times[k][1],
         'bound_ms': bounds[k][0], 'bound_by': bounds[k][1],
         'library_ms': None}
        for k in kernels]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
