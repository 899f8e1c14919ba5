#!/usr/bin/env python3
"""Drive annlite_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from ``annlite_torch/csrc`` (``nvcc``, one process
per source, all at once), then runs seven phases, each printing one JSON line:

1. ``build``: build time, the card's name and ``nvidia-smi``'s name and power
   limit;
2. ``kernels_vs_plain``: every kernel against its plain PyTorch version on the
   card at the main paths' shapes, and CUDA-event times.  The scan kernels
   at D = 768 (N = 16384 and 2^20, 1, 64 and 100 queries) and at the
   facade's D = 128 (N = 131072, 8 and 100 queries); the ADC kernels at
   M = 64, K = 256, u8 codes, N = 2^20 with 1, 64 and 100 queries, masked
   and unmasked, once at K = 1024 with u16 codes (the m-tiled table), and
   the IVF kernels on 1024 blocks of 1024 slots with probe sets of 1, 8 and
   32 cells padded with -1.  Rows equal and scores bit-equal for the scan
   and ADC kernels, the stated tolerance for the rerank kernel;
3. ``flat``: ``scan_topk`` at N = 16384 (the block2 select), then a
   2^20 x 768 cosine ``FlatIndex``: recall@10 against a float32 brute force,
   batch 1 against row 0 of batch 64, batch-64 and batch-1 latency, masked
   search at 5% and 80% selectivity;
4. ``facade``: ``AnnLite`` with 100,000 docs of 128 dimensions (euclidean,
   a ``price`` tag): self-hits, a filtered search, updates and deletes,
   ``serving_searcher`` against ``search_numpy``, dump and reopen;
5. ``pq_scan``: the JAX package's ``bench.py`` PQ recipe, 2^20 x 128
   clustered rows, a PQ64 codec trained on the card, ``PQScanIndex`` at
   batch 64 with rerank 0 and 100 (recall@10 >= 0.99 against a float32 brute
   force), ``exact_topk``, a 5% mask, batch 1 against row 0 of batch 64;
6. ``ivf_pq``: the same corpus in 1024 VQ cells fitted on the card,
   ``IVFPQIndex(rerank=100)`` at batch 8 / n_probe 8 (recall@10 >= 0.98)
   and batch 1 / n_probe 1;
7. ``facade_pq``: ``AnnLite`` over phase 4's docs with ``n_subvectors=64``,
   then with ``n_cells=64`` as well: train, index, self-hits, a filtered
   search, updates and deletes, encode/decode, dump and reopen.

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
T0 = time.perf_counter()


def emit(obj):
    if 'phase' in obj:  # where the script's time goes
        obj['script_s'] = time.perf_counter() - T0
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
    from annlite_torch.codecs import PQCodec, VQCodec
    from annlite_torch.doc import Doc
    from annlite_torch.enums import Metric
    from annlite_torch.index.flat import FlatIndex
    from annlite_torch.index.ivf_pq import IVFPQIndex
    from annlite_torch.index.pq_scan import PQScanIndex
    from annlite_torch.math import cdist, l2_normalize, top_k
    from annlite_torch.ops import _ext
    from annlite_torch.ops import adc as ad
    from annlite_torch.ops import fused_scan as fs
    from annlite_torch.ops import gather as ga
    from annlite_torch.ops import ivf as iv
    from annlite_torch.ops.scan import quantize_rows_int8_device, scan_topk

    kernels = {'block_top2': fs.block_top2, 'lane8_merge': fs.lane8_merge,
               'gather_rerank': ga.gather_rerank,
               'adc_scores': ad.adc_scores_kernel, 'adc_block_top2': ad.adc_block_top2,
               'ivf_scores': iv.ivf_scores, 'ivf_block_top2': iv.ivf_block_top2}
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
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({'phase': 'build', 'build_s': build_s, 'device': device_name,
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

    def merge_bound(nq_, nb_):
        """lane8_merge's bound over ``nb_`` blocks' candidates of ``nq_``
        queries, as K1's below."""
        return bound(nq_ * nb_ * 256 * 8 + nq_ * 1024 * 8, 2.0 * 8 * nq_ * 128 * nb_ * 2,
                     FP32_OPS_PER_S)

    def maxerr(a, b):
        """Largest |a - b| where they differ (0 when bit-equal; BIG and inf
        entries compare equal to themselves)."""
        return float(torch.where(a == b, torch.zeros_like(a), (a - b).abs()).max())

    # K4/K5 at the PQ path's shapes: M = 64, K = 256, u8 codes, N = 2^20.
    # Duplicated codes exercise the tie rules: rows 128..255 repeat rows
    # 0..127 in block 0's buckets, rows 4096.. repeat rows 0.. across blocks.
    pm, pk = 64, 256

    def adc_inputs(nq_, n_, k_, dtype):
        dt = torch.rand((nq_, pm, k_), device=dev, generator=g) * 10
        c = torch.randint(0, k_, (pm, n_), device=dev, generator=g, dtype=torch.int32)
        c[:, 128:256] = c[:, 0:128]
        c[:, 4096:4096 + 2048] = c[:, 0:2048]
        return dt, c.to(dtype)

    def check_adc(tag, dt, codes, mask, block_n):
        tag = f'{tag} q={dt.shape[0]}'
        s = ad.adc_scores_kernel(dt, codes, mask)
        ref = ad._adc_scores_ref(dt, codes, mask)
        if not torch.equal(s, ref):
            fail(f'adc_scores {tag}: scores differ from the plain version')
        err['adc_scores'] = max(err['adc_scores'], maxerr(s, ref))
        s2, r2 = ad.adc_block_top2(dt, codes, mask, block_n)
        s2r, r2r = ad._adc_block_top2_ref(dt, codes, mask, block_n)
        if not (torch.equal(r2, r2r) and torch.equal(s2, s2r)):
            fail(f'adc_block_top2 {tag}: rows or scores differ from the plain version')
        err['adc_block_top2'] = max(err['adc_block_top2'], maxerr(s2, s2r))
        s8, r8 = fs.lane8_merge(s2, r2)
        if not all(map(torch.equal, (s8, r8), fs._lane8_merge_ref(s2r, r2r))):
            fail(f'lane8_merge {tag}: rows or scores differ on ADC candidates')
        checks.append(f'adc_scores, adc_block_top2+lane8_merge {tag}: rows equal, '
                      'scores bit-equal')

    npq = 1 << 20
    dt_all, codes_pq = adc_inputs(100, npq, pk, torch.uint8)
    keep_pq = (torch.rand(npq, device=dev, generator=g) < 0.5).to(torch.int8)
    ones_pq = torch.ones(npq, dtype=torch.int8, device=dev)
    for nq_ in (1, 64, 100):
        for mtag, mk in (('unmasked', ones_pq), ('mask 50%', keep_pq)):
            check_adc(f'n=2^20 m=64 k=256 u8 {mtag}', dt_all[:nq_].contiguous(),
                      codes_pq, mk, 4096)
    # K = 1024 (u16): one query's table is 256 KB, so the kernel tiles it
    # over subspaces; the deep select's blocks shrink to 1024 rows
    dt_u, codes_u = adc_inputs(64, 1 << 17, 1024, torch.uint16)
    keep_u = (torch.rand(1 << 17, device=dev, generator=g) < 0.5).to(torch.int8)
    check_adc('n=2^17 m=64 k=1024 u16 mask 50%', dt_u, codes_u, keep_u,
              ad._scale_blocks(1024))
    del dt_u, codes_u, keep_u

    # K6/K7: 1024 one-block cells of 1024 slots (2^20 rows), probe sets of 1,
    # 8 and 32 cells padded with -1 (a pad scores block 0, masked out);
    # blocks 0 and 1 hold the same codes and are both selected, for ties
    nblk = 1024
    cb_ivf = torch.randint(0, pk, (nblk, pm, 1024), device=dev, generator=g,
                           dtype=torch.int32)
    cb_ivf[1] = cb_ivf[0]
    cb_ivf = cb_ivf.to(torch.uint8)
    mb_ivf = (torch.rand((nblk, 1024), device=dev, generator=g) < 0.9).to(torch.int8)

    def check_ivf(tag, ids, dt, cb, mb):
        tag = f'{tag} S={ids.shape[0]} q={dt.shape[0]}'
        out = iv.ivf_scores(ids, dt, cb)
        ref = iv._ivf_scores_ref(ids, dt, cb)
        if not torch.equal(out, ref):
            fail(f'ivf_scores {tag}: scores differ from the plain version')
        err['ivf_scores'] = max(err['ivf_scores'], maxerr(out, ref))
        s6, r6 = iv.ivf_block_top2(ids, dt, cb, mb)
        s6r, r6r = iv._ivf_block_top2_ref(ids, dt, cb, mb)
        if not (torch.equal(r6, r6r) and torch.equal(s6, s6r)):
            fail(f'ivf_block_top2 {tag}: rows or scores differ from the plain version')
        err['ivf_block_top2'] = max(err['ivf_block_top2'], maxerr(s6, s6r))
        # the plain merge needs 8 candidates per lane class: 4 selections
        if ids.shape[0] >= 4 and not all(map(
                torch.equal, fs.lane8_merge(s6, r6), fs._lane8_merge_ref(s6r, r6r))):
            fail(f'lane8_merge {tag}: rows or scores differ on IVF candidates')
        checks.append(f'ivf_scores, ivf_block_top2+lane8_merge {tag}: rows equal, '
                      'scores bit-equal')

    for ncell in (1, 8, 32):
        ids = torch.randperm(nblk, device=dev, generator=g)[:ncell]
        if ncell > 1:
            ids[:2] = torch.tensor([0, 1], device=dev)
        pad = -(-(ncell + 1) // 8) * 8 - ncell  # at least one pad
        ids = torch.cat([ids, torch.full((pad,), -1, device=dev)]).to(torch.int32)
        for nq_ in (1, 8, 64):
            check_ivf(f'1024 blocks x 1024 probe={ncell}', ids,
                      dt_all[:nq_].contiguous(), cb_ivf, mb_ivf)
    del cb_ivf, mb_ivf

    # the ADC kernels' times at the PQ path's shape (Q = 64, N = 2^20); the
    # library yardstick for K5 is one embedding_bag over the codes offset by
    # m * K (the same sums in another order)
    dt64 = dt_all[:64].contiguous()
    bag_idx = (codes_pq.T.long() + torch.arange(pm, device=dev) * pk).contiguous()
    bag_w = dt64.permute(1, 2, 0).reshape(pm * pk, 64).contiguous()
    bag = torch.nn.functional.embedding_bag(bag_idx, bag_w, mode='sum')
    if not torch.allclose(bag.T, ad._adc_scores_ref(dt64, codes_pq, ones_pq), rtol=1e-5):
        fail('embedding_bag does not compute the ADC scores')
    adc_times = {
        'adc_scores': (cuda_ms(lambda: ad.adc_scores_kernel(dt64, codes_pq, ones_pq)),
                       cuda_ms(lambda: ad._adc_scores_ref(dt64, codes_pq, ones_pq), 5)),
        'adc_block_top2': (
            cuda_ms(lambda: ad.adc_block_top2(dt64, codes_pq, ones_pq, 4096)),
            cuda_ms(lambda: ad._adc_block_top2_ref(dt64, codes_pq, ones_pq, 4096), 5)),
    }
    library_ms = {'adc_scores': cuda_ms(lambda: torch.nn.functional.embedding_bag(
        bag_idx, bag_w, mode='sum'))}
    k4_ms = cuda_ms(lambda: fs.lane8_merge(*ad.adc_block_top2(dt64, codes_pq, ones_pq, 4096)))
    nb_pq = npq // 4096
    adc_bounds = {
        'adc_scores': bound(npq * pm + 64 * pm * pk * 4 + npq + 64 * npq * 4,
                            64.0 * npq * pm, FP32_OPS_PER_S),
        'adc_block_top2': bound(npq * pm + 64 * pm * pk * 4 + npq + 64 * nb_pq * 256 * 8,
                                64.0 * npq * pm, FP32_OPS_PER_S),
    }
    k4_merge_bound = merge_bound(64, nb_pq)
    del dt_all, codes_pq, keep_pq, ones_pq, bag_idx, bag_w, bag, dt64

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
        'lane8_merge': merge_bound(nq, nb),
        'gather_rerank': bound(nq * d * 4 + nq * 40 * d * 4 + nq * 40 * 8,
                               2.0 * nq * 40 * d, FP32_OPS_PER_S),
    }
    times.update(adc_times)
    bounds.update(adc_bounds)
    emit({'phase': 'kernels_vs_plain', 'checks': checks,
          'max_abs_err': err,
          'ms': {k: v[0] for k, v in times.items()},
          'plain_ms': {k: v[1] for k, v in times.items()},
          'library_ms': library_ms,
          'block_top2_ms_n16384': block_ms_16k,
          'block_top2_plain_ms_n16384': block_plain_ms_16k,
          'k1_block_top2_plus_lane8_merge_ms': k1_ms,
          'k4_adc_block_top2_plus_lane8_merge_ms': k4_ms,
          'k4_lane8_merge_bound_ms': k4_merge_bound,
          'shapes': 'Q=64 D=768; block_top2/lane8_merge N=2^20; gather R=40; '
                    'adc_* Q=64 N=2^20 M=64 K=256 u8'})
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

    # ---------------- 5. PQ scan (bench.py ph_pqivf) ----------------
    # 2^20 x 128 euclidean: 1024 centres x 2.0 plus unit normal noise, numpy
    # seed 0; PQ64 x 256 codewords trained on the card from 20,000 rows
    n2, d2 = 1 << 20, 128
    crng = np.random.default_rng(SEED)
    centers2 = (crng.standard_normal((1024, d2)) * 2.0).astype(np.float32)
    xs = (centers2[crng.integers(0, 1024, n2)]
          + crng.standard_normal((n2, d2))).astype(np.float32)
    t0 = time.perf_counter()
    pq = PQCodec(d2, n_subvectors=64, n_clusters=256, metric='euclidean', n_init=1)
    pq.fit(xs[:20000], iter=15)
    codes = pq.encode(xs)
    pq_train_encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pq_idx = {r: PQScanIndex(d2, pq, rerank=r) for r in (0, 100)}
    for index in pq_idx.values():
        index.add_with_ids(xs, np.arange(n2), codes=codes)
    pq_ingest_s = time.perf_counter() - t0
    xs_dev = torch.from_numpy(xs).to(dev)
    xs_sq = torch.sum(xs_dev * xs_dev, dim=1)

    def brute(qv, k=10):
        """Exact float32 L2 top-k rows over the corpus."""
        qd = torch.from_numpy(qv).to(dev)
        dd = xs_sq[None, :] - 2.0 * (qd @ xs_dev.T)
        return torch.sort(dd, dim=1, stable=True).indices[:, :k].cpu().numpy()

    def recall_at_10(got, gt):
        return float(np.mean([len(set(a[:10]) & set(b[:10])) / 10
                              for a, b in zip(got.tolist(), gt.tolist())]))

    qv = xs[:nq]
    gt = brute(qv)
    mask5 = np.random.default_rng(SEED + 1).random(n2) < 0.05
    idx100 = pq_idx[100]

    def pq_path():
        out = {'r0': pq_idx[0].search(qv, 10), 'r100': idx100.search(qv, 10),
               'b1': idx100.search(qv[:1], 10),
               'mask5': idx100.search(qv, 10, mask=mask5)}
        idx100.exact_topk = True  # the full scores (K5) and an exact top-k
        out['exact'] = idx100.search(qv, 10)
        idx100.exact_topk = False
        return out

    res, pq_counts = drive('pq_scan 2^20 x PQ64',
                           ['adc_block_top2', 'lane8_merge', 'adc_scores'], pq_path)
    for search, (dd, ii) in res.items():
        want = (1, 10) if search == 'b1' else (nq, 10)
        if dd.shape != want or ii.shape != want or not np.isfinite(dd).all():
            fail(f'pq_scan {search}: result of shape {dd.shape} or not finite')
    pq_recall = {s: recall_at_10(res[s][1], gt) for s in ('r0', 'r100', 'exact')}
    if pq_recall['r100'] < 0.99 or pq_recall['exact'] < 0.99:
        fail(f'pq_scan rerank-100 recall@10 {pq_recall} < 0.99')
    if not mask5[res['mask5'][1]].all():
        fail('pq_scan mask 5%: a returned row lies outside the mask')
    (d1, i1), (d64, i64) = res['b1'], res['r100']
    if not (np.array_equal(i1[0], i64[0]) and np.allclose(d1[0], d64[0], rtol=1e-6, atol=0)):
        fail('pq_scan batch 1: result differs from row 0 of batch 64')
    pq_lat = {'rerank100_batch64_ms': host_ms(lambda: idx100.search(qv, 10)),
              'rerank100_batch1_ms': host_ms(lambda: idx100.search(qv[:1], 10)),
              'rerank0_batch64_ms': host_ms(lambda: pq_idx[0].search(qv, 10)),
              'rerank100_mask5pct_batch64_ms': host_ms(
                  lambda: idx100.search(qv, 10, mask=mask5))}
    emit({'phase': 'pq_scan', 'n': n2, 'dim': d2, 'm': 64, 'k': 256,
          'train_encode_s': pq_train_encode_s, 'host_ingest_s_two_indexes': pq_ingest_s,
          'recall_at_10_vs_fp32': pq_recall, 'latency_ms': pq_lat,
          'qps_rerank100_batch64': nq / pq_lat['rerank100_batch64_ms'] * 1e3,
          'masked_rows_in_mask': True, 'batch1_equals_batch64_row0': True,
          'launches': pq_counts})
    del pq_idx, idx100, res

    # ---------------- 6. IVF-PQ (bench.py _ivf_substeps) ----------------
    # cells from a VQ codec of 1024 centroids fitted on the card from 65,536
    # rows; IVFPQIndex(rerank=100); batch 8 at n_probe 8 (the deep select,
    # K6) and batch 1 at n_probe 1 (K7); queries from a fresh generator
    t0 = time.perf_counter()
    vq = VQCodec(1024, metric='euclidean')
    vq.fit(xs[:65536])
    cells = vq.encode(xs)
    ivf = IVFPQIndex(d2, pq, rerank=100)
    ivf.add_with_ids(xs, np.arange(n2), cells=cells, codes=codes)
    ivf_build_s = time.perf_counter() - t0
    rng_q = np.random.default_rng(4242)
    qv2 = (centers2[rng_q.integers(0, 1024, nq)]
           + rng_q.normal(size=(nq, d2))).astype(np.float32)
    gt2 = brute(qv2)

    def probes(q_np, n_probe):
        dd = cdist(torch.from_numpy(q_np).to(dev), vq._cb, metric='euclidean')
        return top_k(dd, n_probe)[1].cpu().numpy()

    p8, p1 = probes(qv2, 8), probes(qv2[:1], 1)
    sel8 = [ivf._store.select_blocks(np.unique(p8[lo:lo + 8])) for lo in range(0, nq, 8)]
    sel1 = ivf._store.select_blocks(np.unique(p1))
    if min(map(len, sel8)) < 16 or len(sel1) >= 16:
        fail(f'ivf_pq: probe sets of {[len(s) for s in sel8]} and {len(sel1)} blocks '
             'do not take the K6 and K7 paths')

    def ivf_path():
        b8 = [ivf.search(qv2[lo:lo + 8], 10, cells=p8[lo:lo + 8]) for lo in range(0, nq, 8)]
        return b8, ivf.search(qv2[:1], 10, cells=p1)

    (b8, b1), ivf_counts = drive('ivf_pq 2^20, 1024 cells',
                                 ['ivf_block_top2', 'lane8_merge', 'ivf_scores'], ivf_path)
    d8 = np.concatenate([b[0] for b in b8])
    i8 = np.concatenate([b[1] for b in b8])
    if d8.shape != (nq, 10) or not np.isfinite(d8).all() or b1[1].shape != (1, 10):
        fail('ivf_pq: results of the wrong shape or not finite')
    ivf_recall = recall_at_10(i8, gt2)
    if ivf_recall < 0.98:
        fail(f'ivf_pq probe-8 recall@10 {ivf_recall} < 0.98')
    if not np.isin(cells[b1[1][0]], p1[0]).all():
        fail('ivf_pq probe 1: a returned row lies outside the probed cell')
    ivf_lat = {'probe8_batch8_ms': host_ms(lambda: ivf.search(qv2[:8], 10, cells=p8[:8])),
               'probe1_batch1_ms': host_ms(lambda: ivf.search(qv2[:1], 10, cells=p1))}
    # K6 and K7 at these shapes: checked against their plain versions, timed
    cb, mb, _ = ivf._store.device_arrays()
    s8_ids = torch.from_numpy(sel8[0]).to(dev)
    s1_ids = torch.from_numpy(sel1).to(dev)
    dt8, dt1 = pq.dist_mat(qv2[:8]), pq.dist_mat(qv2[:1])
    check_ivf('ivf_pq phase probe=8', s8_ids, dt8, cb, mb)
    check_ivf('ivf_pq phase probe=1', s1_ids, dt1, cb, mb)
    times['ivf_block_top2'] = (cuda_ms(lambda: iv.ivf_block_top2(s8_ids, dt8, cb, mb)),
                               cuda_ms(lambda: iv._ivf_block_top2_ref(s8_ids, dt8, cb, mb), 5))
    k6_ms = cuda_ms(lambda: fs.lane8_merge(*iv.ivf_block_top2(s8_ids, dt8, cb, mb)))
    times['ivf_scores'] = (cuda_ms(lambda: iv.ivf_scores(s1_ids, dt1, cb)),
                           cuda_ms(lambda: iv._ivf_scores_ref(s1_ids, dt1, cb), 5))
    n8, n1 = len(sel8[0]) * 1024, len(sel1) * 1024
    bounds['ivf_block_top2'] = bound(n8 * 64 + 8 * 64 * 256 * 4 + len(sel8[0]) * 4 + n8
                                     + 8 * len(sel8[0]) * 256 * 8, 8.0 * n8 * 64,
                                     FP32_OPS_PER_S)
    bounds['ivf_scores'] = bound(n1 * 64 + 64 * 256 * 4 + len(sel1) * 4 + n1 * 4,
                                 1.0 * n1 * 64, FP32_OPS_PER_S)
    emit({'phase': 'ivf_pq', 'n': n2, 'cells': 1024, 'block': 1024,
          'build_s': ivf_build_s, 'recall_at_10_vs_fp32_probe8': ivf_recall,
          'scanned_fraction_probe8': {'mean': float(np.mean([len(s) for s in sel8])) * 1024 / n2,
                                      'max': max(len(s) for s in sel8) * 1024 / n2},
          'blocks_probe8': [len(s) for s in sel8], 'blocks_probe1': len(sel1),
          'latency_ms': ivf_lat, 'qps_probe8_batch8': 8 / ivf_lat['probe8_batch8_ms'] * 1e3,
          'k6_ivf_block_top2_plus_lane8_merge_ms': k6_ms,
          'k6_lane8_merge_bound_ms': merge_bound(8, len(sel8[0])),
          'launches': ivf_counts, 'kernel_shapes': {
              'ivf_block_top2': f'Q=8 S={len(sel8[0])}', 'ivf_scores': f'Q=1 S={len(sel1)}'}})
    del ivf, cb, mb, xs_dev, xs_sq, xs, codes
    torch.cuda.empty_cache()

    # ---------------- 7. the facade with PQ codecs ----------------
    def facade_pq_path(kind, data_dir, kw):
        shutil.rmtree(data_dir, ignore_errors=True)
        cfg = dict(n_dim=df, metric='euclidean', columns=[('price', float)],
                   data_path=data_dir, **kw)
        ann = AnnLite(**cfg)
        t = time.perf_counter()
        ann.train(xf[:10240])
        train_s = time.perf_counter() - t
        t = time.perf_counter()
        for lo in range(0, nf, 20_000):
            ann.index([Doc(id=str(i), embedding=xf[i], tags={'price': float(prices[i])})
                       for i in range(lo, min(lo + 20_000, nf))])
        ingest = time.perf_counter() - t
        _, ids = ann.search_numpy(qf_np[:16], limit=10)
        hits = sum(ids[i][0] == str(i) for i in range(16))
        if hits != 16:
            fail(f'facade_pq {kind}: self-hits {hits}/16')
        flt = {'price': {'$lt': 50.0}}
        for matches in ann.search_by_vectors(qf_np[:8], filter=flt, limit=10,
                                             include_metadata=True):
            if not matches or any(m.tags['price'] >= 50.0 for m in matches):
                fail(f'facade_pq {kind}: filtered search returned a doc outside the filter')
        upd = np.arange(1000, 1100)
        ann.update([Doc(id=str(i), embedding=xf[i] + 0.5,
                        tags={'price': float(prices[i])}) for i in upd])
        gone = [str(i) for i in range(2000, 2100)]
        ann.delete(gone)
        _, ids = ann.search_numpy(xf[2000:2100], limit=10)
        if set(gone) & {i for row in ids for i in row}:
            fail(f'facade_pq {kind}: a deleted doc was returned')
        _, ids = ann.search_numpy(xf[upd[:16]] + 0.5, limit=1)
        if [row[0] for row in ids] != [str(i) for i in upd[:16]]:
            fail(f'facade_pq {kind}: updated docs do not find themselves')
        enc = ann.encode(xf[:1000])
        dec = ann.decode(enc)
        rel = float(np.mean((dec - xf[:1000]) ** 2) / np.var(xf[:1000]))
        if enc.shape != (1000, 64) or dec.shape != (1000, df) or not rel < 0.5:
            fail(f'facade_pq {kind}: encode/decode ({enc.shape}, {dec.shape}, '
                 f'relative error {rel})')
        d_np, ids_np = ann.search_numpy(qf_np, limit=10)
        search_ms = host_ms(lambda: ann.search_numpy(qf_np, limit=10), reps=10)
        ann.dump()
        ann.close()
        ann = AnnLite(**cfg)
        d_re, ids_re = ann.search_numpy(qf_np, limit=10)
        if ids_re != ids_np or not all(np.array_equal(a, b) for a, b in zip(d_re, d_np)):
            fail(f'facade_pq {kind}: results differ after dump and reopen')
        ann.close()
        shutil.rmtree(data_dir, ignore_errors=True)
        return {'train_s': train_s, 'ingest_docs_per_s': nf / ingest,
                'search_numpy_ms_batch64': search_ms, 'decode_rel_mse': rel}

    facade_pq = {}
    for kind, kw, expected in (
            ('pq_scan', dict(n_subvectors=64, rerank=100), ['adc_block_top2', 'lane8_merge']),
            ('ivf_pq', dict(n_cells=64, n_subvectors=64, n_probe=8, rerank=100),
             ['ivf_block_top2', 'lane8_merge'])):
        out, counts = drive(f'facade_pq {kind}', expected, lambda: facade_pq_path(
            kind, ROOT / 'build' / f'chip_smoke_{kind}', kw))
        facade_pq[kind] = dict(out, launches=counts)
    emit({'phase': 'facade_pq', 'docs': nf, 'dim': df, 'metric': 'euclidean',
          'self_hits_16': 16, 'filtered_ok': True, 'deleted_never_returned': True,
          'reopen_equal': True, **facade_pq})

    # ---------------- result ----------------
    src = {'block_top2': 'annlite_torch/csrc/fused_scan.cu',
           'lane8_merge': 'annlite_torch/csrc/fused_scan.cu',
           'gather_rerank': 'annlite_torch/csrc/gather.cu'}
    replaces = {'block_top2': 'annlite_tpu/ops/fused_scan.py:99',
                'lane8_merge': 'annlite_tpu/ops/fused_scan.py:121',
                'gather_rerank': 'annlite_tpu/ops/gather.py:31',
                'adc_scores': 'annlite_tpu/ops/adc.py:67',
                'adc_block_top2': 'annlite_tpu/ops/adc.py:169',
                'ivf_scores': 'annlite_tpu/ops/ivf.py:31',
                'ivf_block_top2': 'annlite_tpu/ops/ivf.py:78'}
    emit({'kernels': [
        {'name': k, 'route': 'cuda',
         'source': src.get(k, 'annlite_torch/csrc/adc.cu'), 'replaces': replaces[k],
         'launches': main_launches[k], 'max_abs_err': err[k],
         'ms': times[k][0], 'plain_ms': times[k][1],
         'bound_ms': bounds[k][0], 'bound_by': bounds[k][1],
         'library_ms': library_ms.get(k)}
        for k in kernels]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': device_name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
