#!/usr/bin/env python3
"""Drive annlite_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from ``annlite_torch/csrc`` (``nvcc``, one process
per source, all at once), then runs fifteen phases, each printing one JSON
line:

1. ``build``: build time, the card's name and ``nvidia-smi``'s name and power
   limit;
2. ``kernels_vs_plain``: every kernel against its plain PyTorch version on the
   card at the main paths' shapes, and CUDA-event times (L2 flushed, the
   start event behind a device spin that outlasts the host's enqueue, so
   a window holds device time only).  The scan kernels
   at D = 768 (N = 16384 and 2^20, 1, 64 and 100 queries; at 2^20 also 65
   and 128, the query tiles' edges) and at the facade's D = 128 (N = 131072,
   8 and 100 queries); the ADC kernels at
   M = 64, K = 256, u8 codes, N = 2^20 with 1, 64 and 100 queries, masked
   and unmasked, at the lookup core's query-tile edges (15, 16, 17, 33
   queries), at the facade's 131,072 rows, K5 at N = 12,293, once at
   K = 1024 with u16 codes (the m-tiled table), and the IVF kernels on 1024
   blocks of 1024 slots with probe sets of 1, 8 and 32 cells padded with -1,
   then at their plans' edges: S in {1, 2, 15, 16, 17, 139, 140, 300}, Q in
   {1, 2, 7, 8, 9, 16, 17, 33}, u8 codes at K = 256 and u16 at K = 1024,
   ties (repeated code columns and blocks, a table of three values), masked
   slots and a -1 pad, K6 in both its bodies (the core's plan, kernels per
   call, registers and
   spills printed under ``adc_geometry``; the IVF kernels' in the ``ivf_pq``
   phase); ``lut_pq_scores`` (K8) at N = 131,072, Q = 64
   and 1, C = 256 and 512, M = 64/K = 256 u8 and K = 1024 u16 at M = 16 and
   64 (m-tiled), with ids -1, N and NO_ID; ``beam_pq`` (K8 with its loop)
   against the eager loop with the plain scorer over the whole list, ids and
   distances bit-equal: a random degree-32 graph of 131,072 rows, PQ64 u8
   codes, ef 128, B 8, Q = 64 and 1, an invalid entry and a query with no
   valid entry, a budget of 3 iterations, u16 codes at K = 1024 (the
   table read from global memory), and ef 1024 and 2048 at Q = 8 (2,048 and
   4,096 sort slots); beyond the sort ceiling (ef 4096) the
   search must take the eager loop around K8; ``adc_scores_i8`` (K9) at the ADC
   shapes and at its plan's edges (Q in {1, 3, 4, 5, 8, 9, 64, 100}; M = 258
   u8 and u16 codes at K = 1024 over N = 2^17 + 5), masked and unmasked, also
   within 1% of K5, its plans, registers and spills printed, and once through
   its entry point; ``gather_rerank`` (K3) at the flat path's and the
   facade's shapes (R = 40, ids out of range), at R in {1, 128, 1000} and Q
   in {1, 65}, with scalar loads (D = 100, an unaligned base) and at D =
   ``MAX_GATHER_DIM``, timed at Q in {64, 1} and R in {40, 128} beside its
   bound and the two calls ``index_select`` + ``torch.bmm``, its plans,
   registers and spills printed; the
   int4 and bf16 block passes (``block_top2_int4``, ``block_top2_bf16``) and
   ``lane8_merge`` over their candidates at N = 2^20, D = 768, Q = 64, 1, 5,
   65 and 128, cosine, L2 and a 5% mask, bf16 also on dyadic rows, and at
   65,536 x 256 and x 3072, Q = 17; ``lane8_merge`` on tie-heavy candidates
   at 1, 3, 128 and 256 blocks, Q = 64 and 1, timed at 128 and 256.  Rows
   equal and scores bit-equal for the
   scan (bf16: on dyadic rows; within a stated tolerance on unit rows, rows
   equal but for near-ties), ADC and table kernels, the stated tolerance for
   the rerank kernel.  Each block pass's time at Q = 64, 32 and 1, its geometry
   (query tiles, group splits, grid, shared memory per CTA, registers per
   thread), and as a ceiling for the product alone ``torch._int_mm`` and a
   bf16 ``torch.matmul`` over the same [64, 768] x [768, 2^20];
3. ``flat``: ``scan_topk`` at N = 16384 (the block2 select), then a
   2^20 x 768 cosine ``FlatIndex``: recall@10 against a float32 brute force,
   batch 1 against row 0 of batch 64, batch-64 and batch-1 latency, masked
   search at 5% and 80% selectivity;
4. ``flat_int4`` and 5. ``flat_bf16``: the same rows and queries through
   ``FlatIndex(scan_mode='int4'/'bf16')``: recall@10 >= 0.98 / 0.995, the
   same checks and latencies, peak device memory;
6. ``facade_scan_modes``: ``AnnLite(256, scan_mode='int4'/'bf16')`` over
   65,536 docs: self-hits, ``serving_searcher`` against ``search_numpy``,
   dump and reopen;
7. ``facade``: ``AnnLite`` with 100,000 docs of 128 dimensions (euclidean,
   a ``price`` tag): self-hits, a filtered search, updates and deletes,
   ``serving_searcher`` against ``search_numpy``, dump and reopen;
8. ``pq_scan``: the JAX package's ``bench.py`` PQ recipe, 2^20 x 128
   clustered rows, a PQ64 codec trained on the card, ``PQScanIndex`` at
   batch 64 with rerank 0 and 100 (recall@10 >= 0.99 against a float32 brute
   force), ``exact_topk``, a 5% mask, batch 1 against row 0 of batch 64;
   K4 and K5 on the trained codes, checked and timed;
9. ``ivf_pq``: the same corpus in 1024 VQ cells fitted on the card,
   ``IVFPQIndex(rerank=100)`` at batch 8 / n_probe 8 (recall@10 >= 0.98)
   and batch 1 / n_probe 1; K6 and K7 at these shapes, checked and timed,
   their plans, launches per call, grids, registers and spills
   (``adc_geometry``), K7's latency floor (an empty launch's time and two
   dependent DRAM reads), and K6's, K7's and ``embedding_bag``'s times
   under the earlier timer as well;
10. ``facade_pq``: ``AnnLite`` over phase 7's docs with ``n_subvectors=64``,
   then with ``n_cells=64`` as well: train, index, self-hits, a filtered
   search, updates and deletes, encode/decode, dump and reopen;
11. ``graph``: the JAX package's ``bench.py`` graph recipe, 131,072 x 128
   clustered rows, the device Vamana build (R 32, l_build 64, W 48, beam
   width 16): its seconds, rows/s, stages and peak device bytes, integrity
   with >= 99.9% of rows reachable, degree <= W and no self-loops (the host
   build of 20,000 of the rows timed beside it); ef 128, beam width 8 over
   the W-wide graph: recall@10 >= 0.95 with vector traversal, >= 0.90 with
   PQ64 table traversal (``beam_pq``) and rerank 100 (rerank
   0, int8 and packed traversal printed), 50% and 5% masks (the 5% one
   the masked brute force's rows, rank by rank within float32 rounding),
   soft deletes, ``device_searcher`` against ``search``, latency of each traversal, the kernels one PQ search
   launches, ``beam_pq`` on this graph against the eager loop and timed at
   Q = 64 and 1 (its bound from the rows the eager loop reads), a profile
   of the PQ searches at batch 64 and 1 (kernel launches, the device's idle
   share), and a streaming append of 16,384 rows to the synced PQ index:
   timed, the new rows' codes patched in without a re-encode, and a
   ``device_searcher`` built before it returning the same ids and distances
   after it; then ``beam_vec`` at the graph cell's shape (262,144 integer
   rows of 128 dims, the device build, ef 50, beam width 16, 8 sampled
   entries) against its plain twin and the eager loop at Q = 64 and 1, and
   timed beside that loop (line ``beam_vec``); then ``beam_vec`` with a
   predicate at the filtered graph cell's shape (262,144 integer rows of 96
   dims, ef 50, k 10) at 30, 50 and 80% of rows passing, bit-equal to its
   plain twin and the eager loop, and timed beside the search without it
   (line ``beam_vec_filtered``, :func:`beam_vec_filtered`); then the masked
   exact scan at that cell's shape (64 queries, k 10) at 5, 15 and 20% of
   rows passing, both metrics: ``masked_scan`` and its merge, one launch
   each a call, bit-equal to the plain twin (the product over every row and
   a stable sort) on integer rows and within 2e-6 on unit rows, timed beside
   the twin on the card and the bound (line ``masked_scan``,
   :func:`masked_scan_phase`);
12. ``facade_graph``: ``AnnLite(index_type='graph')`` over the first 20,000
   of phase 7's docs, without a codec and with ``n_subvectors=64,
   rerank=0`` (``beam_pq`` through the facade): self-hits, a filtered search,
   in-place updates, deletes, ``check_integrity``, ``serving_searcher``
   against ``search_numpy``, dump and reopen;
13. ``facade_codecs``: ``AnnLite(n_subvectors=64, use_opq=True, rerank=100)``
   over phase 7's docs, the PQ scan (recall@10 >= 0.99) and a device-built
   graph traversed with the OPQ tables (``beam_pq``, recall@10 >= 0.90),
   OPQ's train seconds, ``fit_trace`` and reconstruction error, which must be
   below plain PQ's; ``AnnLite(n_components=128)`` flat int8 over phase 6's
   65,536 x 256 cosine docs (recall@10 >= 0.995 against a float32 brute
   force in the projected space; against the unprojected one printed; the
   fitted components and variance ratios held to a float64 numpy PCA of the
   training rows); search latency at batch 64 and 1 for each;
14. ``serving``: the serving executor ``AnnLiteIndexer`` with the settings of
   ``deploy/config.yml`` (128 dimensions, cosine, ``index_type='auto'`` = flat
   int8, rerank 0, shard 0 of 1) and a ``price`` column over phase 7's
   100,000 docs: its warm-up builds the kernels on the main thread;
   ingest in requests of 1,000 through the write buffer (docs/s); a search
   of 64 queries equal to ``AnnLite.search_numpy``, 16 self-hits, recall@10
   >= 0.995 against a float32 cosine brute force, a filtered search, its
   latency at batch 64 and 1, the kernels one search launches and their
   device time (``torch.profiler``, batch 64); 64
   single-query requests at once through ``QueryBatcher`` (fewer than 64
   dispatches, each result its row of the batch; wall time beside 64
   requests one by one); updates, deletes and ``fill_embedding`` (bit for
   bit); a backup to an ``ArtifactServer`` on loopback, uploaded whole and in
   16 MB parts, each restored into a fresh executor on the card (the same doc
   count, bit-equal ids and distances; seconds and archive bytes printed);
   then, where ``aiohttp`` and ``grpc`` are installed, 64 concurrent searches
   and a status call through the HTTP and gRPC front ends (a line says so
   where one is absent);
15. ``sharded``: the sharded indexes of ``annlite_torch/parallel`` on
   ``make_mesh(4, 'cuda')``, 4 shards on the one card, each search running
   the port's kernels once per shard: ``ShardedFlatIndex`` over phase 3's
   2^20 x 768 rows (262,144 a shard: K1's lane8 select and K3; recall@10 >=
   0.995, each distance within K3's tolerance of its row's, a 5% mask, batch
   1 against row 0 of batch 64, latency beside phase 3's ``FlatIndex``);
   ``ShardedPQIndex`` over phase 8's rows and codec (ids and distances
   bit-equal to K5 over the whole corpus on one device and a stable top-k);
   ``ShardedIVFPQIndex(rerank=100)`` over phase 9's cells (probe 8 at batch
   8: K6, recall@10 >= 0.98; probe 1 at batch 1: K7; both held to a
   single-device ``IVFPQIndex`` of the same rows searched once per shard
   with that shard's rows as the mask, the four answers merged); ``ShardedGraphIndex`` over
   phase 11's rows, built on the device per shard (integrity on every shard;
   vector traversal recall@10 >= 0.95, PQ64 at rerank 0 through ``beam_pq``
   >= 0.5, each shard's ``beam_pq`` bit-equal to the eager loop on its
   sub-graph and the search to the merge of those loops; a 5% filter, which
   takes the exact scan on the card, against the brute force over the
   passing rows); ``sharded_lloyd_step`` against the single-device
   step; the multi-host path in an NCCL process group of one
   (``make_hybrid_mesh((1, 4))``: the hierarchical search bit-equal to the
   sharded PQ search); and ``AnnLite(index_type='sharded_flat')`` and
   ``'sharded_pq'`` over phase 7's docs on the default mesh (one shard a
   card): self-hits, a filtered search, a delete, dump and reopen.

Bounds are the largest of bytes at the memory rate, operations at the
peak rate for their type and, for the table-lookup kernels (K4-K9), the
shared-memory lookups: each reads its table entry (4 bytes of a float32
table, 1 byte of K9's int8 table, where one bank word can serve four
queries) at 128 bytes per clock per SM at the card's maximum SM clock
(``nvidia-smi``'s ``clocks.max.sm``, printed).  A lookup is a load
operation, so ``bound_by`` is then ``operations``; the ``bounds`` line
names each kernel's floor (``memory bytes``, ``arithmetic``,
``shared-memory lookups``).

Each main-path run reads the kernels' launch counters (the tracer's
``launch.<kernel>``, `annlite_torch/profile.py`) just before it and just
after; a kernel of the path that was never launched fails the run.  The ``kernels`` line and the ``nvidia-smi`` line come last but one and
two; the last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that line.  Needs one card; imports nothing of JAX.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): memory rate, dense int8 and bf16
# tensor-core rates, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12

SEED = 0
# the device spin before a timed run's start event: longer than any kernel
# wrapper's host work (~10-100 us; a plain version's many ops may outlast it)
SPIN_US = 200
T0 = time.perf_counter()


def emit(obj):
    if 'phase' in obj:  # where the script's time goes
        obj['script_s'] = time.perf_counter() - T0
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


# shared memory serves 128 bytes per clock on each SM (32 banks of 4 bytes);
# the SM count and the clock are read from the card in main()
SMEM_BYTES_PER_CLOCK_PER_SM = 128
SMEM_BYTES_PER_S = [0.0]


def bound(nbytes: float, ops: float, ops_per_s: float, lookups: float = 0.0,
          lookup_bytes: int = 4):
    """(bound_ms, bound_by, bound_of): the largest of bytes over the memory
    rate, operations over the peak rate for their type, and, for the
    table-lookup kernels (K4-K9), ``lookups`` shared-memory reads of a
    ``lookup_bytes`` table entry over the card's shared-memory rate."""
    times = {'memory bytes': nbytes / HBM_BYTES_PER_S * 1e3,
             'arithmetic': ops / ops_per_s * 1e3}
    if lookups:
        times['shared-memory lookups'] = lookups * lookup_bytes / SMEM_BYTES_PER_S[0] * 1e3
    of = max(times, key=times.get)
    return times[of], 'bytes' if of == 'memory bytes' else 'operations', of


def beam_vec_filtered(bm, GraphIndex, sample_entries, cuda_ms, drive, nq: int = 64):
    """``beam_vec`` with a predicate at the shape of the benchmark's filtered
    graph cell: 262,144 clustered integer rows of 96 dims in 0..255, the
    device build (R 32, l_build 200), ef 50, beam width 16, the 8 nearest of
    4,096 sampled entries a query, ``nq`` queries, k = 10 passing rows.  At
    30, 50 and 80% of rows passing, in the squared-L2 and the inner-product
    branch (the cosine cell's), the kernel is held bit-equal to its plain
    twin (ids, distances, iterations) and to the eager loop on the card, each
    returned row passing and each list full; then timed beside the same
    search without a predicate (k = ef, as the graph index asks).  Integer
    rows keep every sum exact in float32 in any order."""
    import numpy as np
    import torch

    dev = torch.device('cuda')
    n, dim, ef, b, k = 262_144, 96, 50, 16, 10
    rng = np.random.default_rng(SEED + 21)
    cent = rng.integers(0, 200, (1024, dim))
    x = np.clip(cent[rng.integers(0, 1024, n)] + rng.integers(-24, 25, (n, dim)),
                0, 255).astype(np.float32)
    q = np.clip(x[rng.integers(0, n, nq)] + rng.integers(-6, 7, (nq, dim)),
                0, 255).astype(np.float32)
    idx = GraphIndex(dim, metric='euclidean', max_degree=32, l_build=200, ef_search=ef,
                     beam_width=b, build_mode='device')
    idx.add_with_ids(x, np.arange(n))
    s = idx._sync_device()
    qt = torch.from_numpy(q).to(dev)
    ent = sample_entries(s.entry_vecs, s.entry_ids, qt, True, 8)
    iters = bm._resolve_iters(None, ef, b)
    masks = {sel: torch.from_numpy(rng.random(n) < sel).to(dev) for sel in (0.3, 0.5, 0.8)}

    def run(euclid, passes=None):
        kk = ef if passes is None else k
        return bm.beam_vec_kernel(s.adj, ent, s.vectors, qt, euclid, kk, ef, b, iters, passes)

    checks, its_of = [], {}
    for euclid in (True, False):
        _, _, its0 = run(euclid)
        for sel, m in masks.items():
            name = f'beam_vec filtered {sel:.0%} {"l2" if euclid else "ip"}'
            (d, ids, its), counts = drive(name, ['beam_vec'], lambda: run(euclid, m))
            if counts['beam_vec'] != 1:
                fail(f'{name}: {counts["beam_vec"]} launches')
            twin = bm._beam_vec_ref(s.adj.cpu(), ent.cpu(), s.vectors.cpu(), qt.cpu(), euclid,
                                    ef, b, iters, k, m.cpu())
            if not all(map(torch.equal, (d.cpu(), ids.cpu(), its.cpu()), twin)):
                fail(f'{name}: ids, distances or iterations differ from the plain twin')
            eager = bm._beam_loop(s.adj, ent, ef, b, iters, k,
                                  bm.make_vector_scorer(s.vectors, qt, euclid), passes=m)
            if not all(map(torch.equal, (d, ids), eager)):
                fail(f'{name}: ids or distances differ from the eager loop')
            if not torch.equal(its, its0):
                fail(f'{name}: the walk differs from the one without the predicate')
            if not bool((d < bm.BIG).all()) or not bool(m[ids.long()].all()):
                fail(f'{name}: a short list or a row outside the mask')
            checks.append(f'{name}: bit-equal to the plain twin and the eager loop, '
                          f'every list full and passing')
        its_of['l2' if euclid else 'ip'] = {'max': int(its0.max()),
                                            'mean': float(its0.float().mean())}
    ms = {'none': cuda_ms(lambda: run(True))}
    for sel, m in masks.items():
        ms[f'{sel:.0%}'] = cuda_ms(lambda: run(True, m))
    emit({'phase': 'beam_vec_filtered', 'n': n, 'dim': dim, 'ef': ef, 'beam_width': b,
          'w': s.adj.shape[1], 'k': k, 'entry_width': 8, 'iters_budget': iters,
          'plan': bm.beam_vec_plan(ef, b, s.adj.shape[1], dim, k)._asdict(),
          'checks': checks, 'iterations_q64': its_of, 'ms_l2_q64': ms,
          'launches_per_search': 1})
    del idx, s, qt, ent, masks
    torch.cuda.empty_cache()


def masked_scan_phase(msc, tracer, cuda_ms, drive, nq: int = 64):
    """The graph filter's masked exact scan (``masked_scan`` and its merge)
    at the shape of the benchmark's filtered graph cell: 262,144 rows of 96
    dims, ``nq`` queries, k = 10, 5, 15 and 20% of rows passing, in the
    squared-L2 and the inner-product branch (the cosine cell's).  On
    clustered integer rows in 0..255 (every sum exact in float32 in any
    order) the kernel is held bit-equal to its plain twin on the card (the
    float32 product over every row and a stable sort); on unit rows (the
    cell's) its distances within 2e-6 of the twin's, rank by rank, and its
    rows' float64 distances within 2e-6 of the twin's rows'.  Each call
    launches the scan and the merge once.  Both timed on the unit rows,
    beside the bound from the passing rows' bytes and the float32 FMA rate.
    Returns ``(ms, plain_ms)``, the bound and the largest distance gap of
    the inner product at 20%, for the kernels' table."""
    import numpy as np
    import torch

    dev = torch.device('cuda')
    n, dim, k = 262_144, 96, 10
    rng = np.random.default_rng(SEED + 24)
    cent = rng.integers(0, 200, (1024, dim))
    xi = np.clip(cent[rng.integers(0, 1024, n)] + rng.integers(-24, 25, (n, dim)),
                 0, 255).astype(np.float32)
    qi = np.clip(xi[rng.integers(0, n, nq)] + rng.integers(-6, 7, (nq, dim)),
                 0, 255).astype(np.float32)
    xu = rng.standard_normal((n, dim)).astype(np.float32)
    xu /= np.linalg.norm(xu, axis=1, keepdims=True)
    qu = xu[rng.integers(0, n, nq)] + 0.1 * rng.standard_normal((nq, dim)).astype(np.float32)
    qu /= np.linalg.norm(qu, axis=1, keepdims=True)
    data = {kind: (torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev))
            for kind, (x, q) in (('integer', (xi, qi)), ('unit', (xu, qu)))}
    sels = (0.05, 0.15, 0.2)
    masks = {s: torch.from_numpy(rng.random(n) < s).to(dev) for s in sels}

    def launches():
        c = tracer.snapshot()['counters']
        return c.get('launch.masked_scan', 0), c.get('launch.masked_scan_merge', 0)

    def exact(x, q, ids, euclid):  # float64 distances of the returned rows
        v, qd = x[ids.long()].double(), q.double()[:, None, :]
        return ((qd - v) ** 2).sum(-1) if euclid else 1.0 - (qd * v).sum(-1)

    checks, gap, ids_equal = [], {}, {}
    for euclid in (True, False):
        for s, m in masks.items():
            for kind, (x, q) in data.items():
                name = f'masked_scan {s:.0%} {"l2" if euclid else "ip"} {kind}'
                before = launches()
                (d, ids), _ = drive(name, ['masked_scan'],
                                    lambda: msc.masked_scan(x, q, m, euclid, k))
                got = tuple(a - b for a, b in zip(launches(), before))
                if got != (1, 1):
                    fail(f'{name}: {got} launches of the scan and the merge, not one each')
                td, ti = msc._masked_scan_ref(x, q, m, euclid, k)
                if not bool(m[ids.long()].all()):
                    fail(f'{name}: a returned row lies outside the mask')
                if kind == 'integer':
                    if not (torch.equal(d, td) and torch.equal(ids, ti)):
                        fail(f'{name}: ids or distances differ from the plain twin')
                    checks.append(f'{name}: bit-equal to the plain twin')
                    continue
                g = (d - td).abs().max().item()
                g_rows = (exact(x, q, ids, euclid) - exact(x, q, ti, euclid)).abs().max().item()
                gap[name] = {'distances': g, 'rows_float64': g_rows}
                ids_equal[name] = float((ids == ti).float().mean())
                if g > 2e-6 or g_rows > 2e-6:
                    fail(f'{name}: distances {g} or rows {g_rows} beyond 2e-6 of the twin')
                checks.append(f'{name}: within 2e-6 of the plain twin, rank by rank')
    x, q = data['unit']
    ms, plain_ms, bound_ms = {}, {}, {}
    for euclid in (True, False):
        for s, m in masks.items():
            key = f'{s:.0%} {"l2" if euclid else "ip"}'
            ms[key] = cuda_ms(lambda: msc.masked_scan(x, q, m, euclid, k))
            plain_ms[key] = cuda_ms(lambda: msc._masked_scan_ref(x, q, m, euclid, k), 5)
            p = int(m.sum())
            bound_ms[key] = bound(n + p * dim * 4 + nq * dim * 4 + nq * k * 8,
                                  2.0 * nq * p * dim, FP32_OPS_PER_S)
    emit({'phase': 'masked_scan', 'n': n, 'dim': dim, 'nq': nq, 'k': k,
          'plan': msc.masked_scan_plan(n, nq, k)._asdict(), 'checks': checks,
          'max_gap_unit_rows': gap, 'ids_equal_unit_rows': ids_equal,
          'passing_rows': {f'{s:.0%}': int(m.sum()) for s, m in masks.items()},
          'ms': ms, 'plain_ms': plain_ms,
          'bound_ms': {key: b[0] for key, b in bound_ms.items()},
          'bound_by': {key: b[1] for key, b in bound_ms.items()}, 'launches_per_search': 2})
    top = '20% ip'
    del data, masks
    torch.cuda.empty_cache()
    return (ms[top], plain_ms[top]), bound_ms[top], gap['masked_scan 20% ip unit']['distances']


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
    from annlite_torch.index.graph import GraphIndex, _sample_entries
    from annlite_torch.index.ivf_pq import IVFPQIndex
    from annlite_torch.index.pq_scan import PQScanIndex
    from annlite_torch import profile as tracer
    from annlite_torch.math import cdist, l2_normalize, top_k
    from annlite_torch.ops import _ext
    from annlite_torch.ops import adc as ad
    from annlite_torch.ops import adc_i8 as ai
    from annlite_torch.ops import beam as bm
    from annlite_torch.ops import fused_scan as fs
    from annlite_torch.ops import gather as ga
    from annlite_torch.ops import ivf as iv
    from annlite_torch.ops import masked_scan as msc
    from annlite_torch.ops.scan import (quantize_rows_int4_device,
                                        quantize_rows_int8_device, scan_topk)

    # the port's kernels, each counted in the tracer's ``launch.<name>``
    kernels = ('block_top2', 'lane8_merge', 'block_top2_int4', 'block_top2_bf16',
               'gather_rerank', 'adc_scores', 'adc_block_top2', 'ivf_scores',
               'ivf_block_top2', 'lut_pq_scores', 'adc_scores_i8', 'beam_pq', 'beam_vec',
               'masked_scan')
    main_launches = {k: 0 for k in kernels}

    def launch_counts():
        """Launches of each kernel so far."""
        c = tracer.snapshot()['counters']
        return {k: c.get(f'launch.{k}', 0) for k in kernels}

    def drive(path_name: str, expected, fn):
        """Run one main path; fail if a kernel it must go through was never
        launched."""
        before = launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: n - before[k] for k, n in launch_counts().items()}
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
    # the lookup floor's rate: 128 B per clock per SM at the card's maximum SM clock
    sm_mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,nounits'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    SMEM_BYTES_PER_S[0] = SMEM_BYTES_PER_CLOCK_PER_SM * n_sms * sm_mhz * 1e6
    emit({'phase': 'build', 'build_s': build_s, 'device': device_name,
          'nvidia_smi': smi, 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'sm_clock_max_mhz': sm_mhz, 'sms': n_sms,
          'smem_bytes_per_s_for_lookup_floor': SMEM_BYTES_PER_S[0]})

    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    spin_cycles = int(SPIN_US * sm_mhz)

    def cuda_ms(fn, reps: int = 20, spin: bool = True):
        """Median CUDA-event time of ``fn`` over ``reps`` runs after two
        warm-up runs, with L2 flushed before each run (a caller finds the
        corpus and the shortlist rows cold).  The start event is recorded
        behind a device spin of ``SPIN_US`` after the flush, so the host has
        queued ``fn``'s launches before it fires and the window holds device
        time only; ``spin=False`` is the earlier timer, whose window also
        held any host time of ``fn`` beyond the flush's."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            if spin:
                torch.cuda._sleep(spin_cycles)
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
    # the main path's batch sizes 64, 1 and 100, and the edges of the query
    # tiles: 65 (one past a 64-query tile) and 128 (the geometry's limit)
    q100 = torch.randn((100, d), device=dev, generator=g)
    q128 = torch.randn((128, d), device=dev, generator=g)
    q8e, qsce = quantize_rows_int8_device(q128)
    qsets = {64: (q8, qsc), 1: (q8[:1], qsc[:1]),
             100: quantize_rows_int8_device(q100),
             65: (q8e[:65], qsce[:65]), 128: (q8e, qsce)}
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
    # K3 at the edges of its plan and of its load paths: R in {1, 128, 1000}
    # (128: the int4 shortlist), Q in {1, 65}; scalar loads at D = 100 and on
    # an unaligned base (the corpus seen from 4 bytes in); the loop over the
    # row at D = MAX_GATHER_DIM
    qe = torch.randn((65, d), device=dev, generator=g)
    for nq_, r_ in ((1, 1), (1, 40), (1, 128), (65, 128), (65, 1000), (64, 1)):
        cand_e = torch.randint(-5, n + 5, (nq_, r_), device=dev, generator=g,
                               dtype=torch.int32)
        check_gather('n=2^20 d=768', l2_normalize(qe[:nq_]), x, cand_e, Metric.COSINE)
        check_gather('n=2^20 d=768', qe[:nq_], x, cand_e, Metric.EUCLIDEAN)
    x_off = x.view(-1)[1:1 + (n - 1) * d].view(n - 1, d)
    if ga._vec4(qf, x_off):
        fail('gather_rerank: the offset view should take the scalar loads')
    for nq_ in (64, 1):
        for metric in (Metric.EUCLIDEAN, Metric.COSINE):
            check_gather('n=2^20-1 d=768 unaligned base', qf[:nq_], x_off, cand[:nq_] - 1,
                         metric)
    for de, ne in ((100, 65536), (ga.MAX_GATHER_DIM, 4096)):
        xe = torch.randn((ne, de), device=dev, generator=g)
        qe_ = torch.randn((64, de), device=dev, generator=g)
        for nq_, r_ in ((64, 40), (1, 128)):
            cand_e = torch.randint(-5, ne + 5, (nq_, r_), device=dev, generator=g,
                                   dtype=torch.int32)
            for metric in (Metric.EUCLIDEAN, Metric.COSINE):
                check_gather(f'n={ne} d={de}', qe_[:nq_], xe, cand_e, metric)
    del qe, cand_e, x_off, xe, qe_

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

    # The int4 and bf16 block passes at the flat path's shape (2^20 x 768,
    # the unit rows above with their duplicated rows), Q = 64, 1 and 5, the
    # cosine, L2 and 5%-mask biases; lane8_merge over each one's own
    # candidates must equal its plain version, and the block pass and the
    # merge must equal the plain block pass and plain merge: bit for bit for
    # int4 (exact integer sums) and for bf16 on dyadic rows (k/8, |k| <= 16:
    # every partial sum exact); within ``tol`` for bf16 on unit rows, where
    # the tensor cores sum in their own order and the plain product in another.
    def bf16_tol(coef, dim=d):
        """Each order's float32 sum of D exact products lies within
        D * 2^-24 * sum|q_d x_d| (<= 1.01 for unit rows rounded to bf16) of
        the exact sum, times |coef|, plus half an ulp of 4 for the bias.  The
        tensor cores' float32 accumulation need not round to nearest: the
        largest error met, as a share of this bound, is printed
        (``block_top2_bf16_unit_rows_err_over_tol``)."""
        return 2 * (abs(coef) * dim * 2.0**-24 * 1.01 + 2.0**-22)

    def check_variant(tag, qs, qsc_, xv, rs, bias, coef, packed, tol=0.0):
        """Scores within ``tol`` (0: bit-equal) and rows equal, but where
        two rows tie within ``2 * tol``: their exact scores (float64, from
        the same bf16 values) must then lie within ``2 * tol``."""
        name = 'block_top2_int4' if packed else 'block_top2_bf16'
        tag = f'{name} {tag} q={qs.shape[0]}'
        s, r = fs.block_top2(qs, qsc_, xv, rs, bias, br, coef, packed_int4=packed)
        s_ref, r_ref = fs._fused_scan_ref(qs, qsc_, xv, rs, bias, br, coef, packed)
        s8, r8 = fs.lane8_merge(s, r)
        if not all(map(torch.equal, (s8, r8), fs._lane8_merge_ref(s, r))):
            fail(f'lane8_merge over {tag}: rows or scores differ from the plain version')
        s8_ref, r8_ref = fs._lane8_merge_ref(s_ref, r_ref)
        for sel, a, ra, b, rb in (('block2', s, r, s_ref, r_ref),
                                  ('lane8', s8, r8, s8_ref, r8_ref)):
            e = maxerr(a, b)
            if tol == 0.0 and not (torch.equal(ra, rb) and e == 0.0):
                fail(f'{tag} {sel}: rows or scores differ from the plain version')
            if not e <= tol:
                fail(f'{tag} {sel}: scores differ by {e} > {tol}')
            differ = ra != rb
            rows_differing[name] += int(differ.sum())
            if bool(differ.any()):
                qf = qs.double()[differ.nonzero()[:, 0]]

                def exact(rows):
                    rows = rows.long()
                    return bias.double()[rows] + coef * (qf * xv[rows].double()).sum(-1)

                gap = (exact(ra[differ]) - exact(rb[differ])).abs().max().item()
                if not gap <= 2 * tol:
                    fail(f'{tag} {sel}: rows differ where their scores are {gap} apart')
            err[name] = max(err[name], e)
            if tol:
                bf16_err_share[0] = max(bf16_err_share[0], e / tol)
        checks.append(f'{tag}: block pass and lane8_merge ' + (
            'rows equal, scores bit-equal' if tol == 0.0
            else f'scores within {tol:.3g}, rows equal but for ties within {2 * tol:.3g}'))

    rows_differing = {'block_top2_int4': 0, 'block_top2_bf16': 0}
    bf16_err_share = [0.0]  # the largest unit-row error as a share of its tolerance
    x4, xs4 = quantize_rows_int4_device(x)
    xb = x.to(torch.bfloat16)
    # unit queries, as the cosine flat path gives them: bf16_tol's bound holds
    qb = l2_normalize(q).to(torch.bfloat16)
    qbe = l2_normalize(q128).to(torch.bfloat16)
    ones_n = torch.ones(n, device=dev)
    ones_q = torch.ones(128, device=dev)
    for tag, bias, coef in cases:
        for qs8, qsc8, qsb in ((q8, qsc, qb), (q8e, qsce, qbe)):
            for nq_ in ((64, 1, 5) if qs8 is q8 else (65, 128)):
                check_variant(f'n=2^20 d=768 {tag}', qs8[:nq_], qsc8[:nq_], x4, xs4, bias,
                              coef, True)
                check_variant(f'n=2^20 d=768 unit rows {tag}', qsb[:nq_], ones_q[:nq_], xb,
                              ones_n, bias, coef, False, bf16_tol(coef))
    # dyadic rows and queries, with the same duplicated rows
    xd = torch.randint(-16, 17, (n, d), device=dev, generator=g, dtype=torch.int8)
    xd[128:256] = xd[0:128]
    xd[br:br + 2048] = xd[0:2048]
    xd = xd.to(torch.bfloat16) / 8
    qd = (torch.randint(-16, 17, (128, d), device=dev, generator=g,
                        dtype=torch.int8).to(torch.bfloat16) / 8)
    bias_d = torch.sum(xd.float() ** 2, dim=1) + torch.where(keep5, 0.0, 3.4e38).float()
    for tag, bias, coef in (('ip', torch.zeros(n, device=dev), -1.0),
                            ('l2 mask5%', bias_d, -2.0)):
        for nq_ in (64, 1, 5, 65, 128):
            check_variant(f'n=2^20 d=768 dyadic {tag}', qd[:nq_], ones_q[:nq_], xd,
                          ones_n, bias, coef, False)
    del xd, qd, bias_d
    # the edges of the geometry on 65,536 rows, 17 queries (a partial tile)
    # and a 50% mask: D = 256, the narrowest packed int4 row the fused path
    # takes (the facade phase's width), and D = 3072, the widest, where the
    # bf16 query tile needs 192 KB of shared memory (opted in above 48 KB)
    ne = 1 << 16
    keep_e = torch.where(torch.rand(ne, device=dev, generator=g) < 0.5, 0.0, 3.4e38).float()
    for de in (256, 3072):
        xe = torch.randn((ne, de), device=dev, generator=g)
        xe[128:256] = xe[0:128]
        xe = l2_normalize(xe)
        qe = l2_normalize(torch.randn((17, de), device=dev, generator=g))
        qe8, qesc = quantize_rows_int8_device(qe)
        xe4, xes4 = quantize_rows_int4_device(xe)
        ones_e, ones_qe = torch.ones(ne, device=dev), torch.ones(17, device=dev)
        check_variant(f'n=65536 d={de} mask50%', qe8, qesc, xe4, xes4, keep_e, -1.0, True)
        check_variant(f'n=65536 d={de} unit rows mask50%', qe.to(torch.bfloat16), ones_qe,
                      xe.to(torch.bfloat16), ones_e, keep_e, -1.0, False,
                      bf16_tol(-1.0, de))
        xed = (torch.randint(-16, 17, (ne, de), device=dev, generator=g,
                             dtype=torch.int8).to(torch.bfloat16) / 8)
        qed = (torch.randint(-16, 17, (17, de), device=dev, generator=g,
                             dtype=torch.int8).to(torch.bfloat16) / 8)
        check_variant(f'n=65536 d={de} dyadic mask50%', qed, ones_qe, xed, ones_e, keep_e,
                      -1.0, False)
        xe8, xes8 = quantize_rows_int8_device(xe)
        check_scan(f'n=65536 d={de} cosine mask50%', qe8, qesc, xe8, xes8, keep_e, -1.0, True)
    del xe, qe, qe8, qesc, xe4, xes4, xed, qed, xe8, xes8, keep_e

    # lane8_merge on tie-heavy candidates at nb = 1, 3, 128 and 256 blocks,
    # Q = 64 and 1: scores of 0..3, block 1 a copy of block 0, blocks 4 and
    # the last +inf (nb >= 128), rows all distinct.  From nb = 4 on against
    # the stable sort (8 finite candidates per lane class), below against
    # the sequential walk's (+inf, 0) fillers (the CPU twin with one range).
    # Timed at nb = 128 and 256 (the flat and the PQ paths' blocks).
    lane8_ms, lane8_bounds = {}, {}
    for nq_ in (64, 1):
        for nb_ in (1, 3, 128, 256):
            s_t = torch.randint(0, 4, (nq_, nb_ * 256), device=dev, generator=g).float()
            if nb_ >= 128:
                s_t[:, 256:512] = s_t[:, 0:256]
                s_t[:, 1024:1280] = float('inf')
                s_t[:, -256:] = float('inf')
            r_t = torch.randperm(nq_ * nb_ * 256, device=dev, generator=g,
                                 dtype=torch.int32).reshape(nq_, -1)
            s8, r8 = fs.lane8_merge(s_t, r_t)
            want = (fs._lane8_merge_ref(s_t, r_t) if nb_ >= 4
                    else fs._lane8_merge_split(s_t, r_t, 1))
            if not (torch.equal(r8, want[1]) and torch.equal(s8, want[0])):
                fail(f'lane8_merge tie-heavy nb={nb_} q={nq_}: differs from the plain version')
            err['lane8_merge'] = max(err['lane8_merge'], maxerr(s8, want[0]))
            checks.append(f'lane8_merge tie-heavy nb={nb_} q={nq_} '
                          f'({fs.lane8_merge_plan(nq_, nb_)} ranges): rows and scores bit-equal')
            if nb_ >= 128:
                lane8_ms[f'nb{nb_}_q{nq_}'] = cuda_ms(lambda: fs.lane8_merge(s_t, r_t))
                lane8_bounds[f'nb{nb_}_q{nq_}'] = merge_bound(nq_, nb_)[0]
    del s_t, r_t, s8, r8, want
    # times at Q = 64 (cosine, unmasked), 32 and 1; the bounds count the
    # corpus, row scales, biases and queries read once and the candidates
    # written once.  Each block pass's geometry (query tiles, splits, grid,
    # shared memory per CTA, registers per thread) at Q = 64, 32 and 1.
    zeros_n = cases[0][1]
    nb_v = n // br
    variant_args = {
        'block_top2': (q8, qsc, x8, xs, False, 'int8'),
        'block_top2_int4': (q8, qsc, x4, xs4, True, 'int4'),
        'block_top2_bf16': (qb, ones_q[:nq], xb, ones_n, False, 'bf16'),
    }
    variant_times, variant_q1_ms, variant_q32_ms, variant_k1_ms = {}, {}, {}, {}
    block_pass_geometry = {}
    for name, (qs, qsc_, xv, rs, packed, variant) in variant_args.items():
        if name != 'block_top2':  # int8's Q = 64 times are taken with K3's below
            variant_times[name] = (
                cuda_ms(lambda: fs.block_top2(qs, qsc_, xv, rs, zeros_n, br, -1.0,
                                              packed_int4=packed)),
                cuda_ms(lambda: fs._fused_scan_ref(qs, qsc_, xv, rs, zeros_n, br, -1.0, packed)))
            variant_k1_ms[name] = cuda_ms(lambda: fs.lane8_merge(*fs.block_top2(
                qs, qsc_, xv, rs, zeros_n, br, -1.0, packed_int4=packed)))
        variant_q1_ms[name] = cuda_ms(lambda: fs.block_top2(
            qs[:1], qsc_[:1], xv, rs, zeros_n, br, -1.0, packed_int4=packed))
        # one query tile of 32 (int4 and bf16 take two at Q = 64)
        variant_q32_ms[name] = cuda_ms(lambda: fs.block_top2(
            qs[:32], qsc_[:32], xv, rs, zeros_n, br, -1.0, packed_int4=packed))
        block_pass_geometry[name] = {f'q{k}': fs.block_pass_info(variant, k, n, d)
                                     for k in (64, 32, 1)}
    # a ceiling for the product alone over the same [64, 768] x [768, 2^20]
    # (no PyTorch call computes the bucketed top-2; the port calls neither):
    # torch._int_mm (int8, exact int32: checked against int8_dot on a slice)
    # and torch.matmul in bf16
    product_only_ms = {}
    try:
        if not torch.equal(torch._int_mm(q8, x8[:8192].t()), fs.int8_dot(q8, x8[:8192])):
            fail('torch._int_mm does not compute the int8 products')
        product_only_ms['int8_torch_int_mm'] = cuda_ms(lambda: torch._int_mm(q8, x8.t()))
    except RuntimeError as e:  # a yardstick the installed PyTorch may not offer
        product_only_ms['int8_torch_int_mm'] = f'not measured: {e}'[:200]
    product_only_ms['bf16_torch_matmul'] = cuda_ms(lambda: torch.matmul(qb, xb.t()))
    cand_bytes = nq * nb_v * 256 * 8
    variant_bounds = {
        'block_top2_int4': bound(n * d // 2 + 8 * n + nq * d + 4 * nq + cand_bytes,
                                 2.0 * nq * n * d, INT8_OPS_PER_S),
        'block_top2_bf16': bound(n * d * 2 + 8 * n + nq * d * 2 + 4 * nq + cand_bytes,
                                 2.0 * nq * n * d, BF16_OPS_PER_S),
    }
    del x4, xs4, xb, qb, qbe, ones_n, ones_q, variant_args, qs, qsc_, xv, rs, bias
    del q128, q8e, qsce

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
        """K5, and where N is a multiple of ``block_n`` K4 + lane8_merge."""
        tag = f'{tag} q={dt.shape[0]}'
        s = ad.adc_scores_kernel(dt, codes, mask)
        ref = ad._adc_scores_ref(dt, codes, mask)
        if not torch.equal(s, ref):
            fail(f'adc_scores {tag}: scores differ from the plain version')
        err['adc_scores'] = max(err['adc_scores'], maxerr(s, ref))
        if codes.shape[1] % block_n:
            checks.append(f'adc_scores {tag}: scores bit-equal')
            return
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
    # the lookup core's query-tile edges: QT - 1, QT, QT + 1 and 2 QT + 1 of
    # the tile of 16 and of the wide tile (32), whose codes the core stages
    # through its table ring
    qt16, qt32 = ad.STAGED_TILE, ad.WIDE_TILE
    for nq_ in sorted({qt16 - 1, qt16, qt16 + 1, 2 * qt16 + 1, qt32 - 1, qt32, qt32 + 1,
                       2 * qt32 + 1}):
        check_adc('n=2^20 m=64 k=256 u8 mask 50%', dt_all[:nq_].contiguous(), codes_pq,
                  keep_pq, 4096)
    # the facade's PQ index (131,072 rows: 32 blocks), and K5 at an N that is
    # not a multiple of 4 (its codes padded in the wrapper)
    check_adc('n=131072 m=64 k=256 u8 mask 50%', dt_all[:64].contiguous(),
              codes_pq[:, :131072].contiguous(), keep_pq[:131072].contiguous(), 4096)
    for nq_ in (7, 33, 64):  # a tile of 8, of 16 and the wide tile
        check_adc('n=12293 m=64 k=256 u8 mask 50%', dt_all[:nq_].contiguous(),
                  codes_pq[:, :12293].contiguous(), keep_pq[:12293].contiguous(), 4096)
    # K = 1024 (u16): one query's table is 256 KB, so the kernel tiles it
    # over subspaces; the deep select's blocks shrink to 1024 rows
    dt_u, codes_u = adc_inputs(64, 1 << 17, 1024, torch.uint16)
    keep_u = (torch.rand(1 << 17, device=dev, generator=g) < 0.5).to(torch.int8)
    for nq_ in (17, 33, 64):  # the wide tile does not fit K = 1024: tiles of 16
        check_adc('n=2^17 m=64 k=1024 u16 mask 50%', dt_u[:nq_].contiguous(), codes_u, keep_u,
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

    def check_ivf(tag, ids, dt, cb, mb, record=True):
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
        if record:
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
    # the IVF plans' edges: K7's body (S < 16, Q <= 2) and the core above it,
    # K6's query tiles and CTA ranges; u8 codes at K = 256 and u16 at
    # K = 1024 (K6 then reads its tables through L2); group 1 of every block
    # repeats group 0 (codes and slot mask) and blocks 0 and 1 are equal, the
    # last selection is a -1 pad, and at K = 256 also a table of three values
    # (ties everywhere)
    cb_ivf[:, :, 128:256] = cb_ivf[:, :, :128]
    mb_ivf[:, 128:256] = mb_ivf[:, :128]
    cb16 = torch.randint(0, 1024, (nblk, pm, 1024), device=dev, generator=g, dtype=torch.int32)
    cb16[1] = cb16[0]
    cb16[:, :, 128:256] = cb16[:, :, :128]
    cb16 = cb16.to(torch.uint16)
    ivf_edges = 0
    for n_sel in (1, 2, 15, 16, 17, 139, 140, 300):
        ids = torch.randperm(nblk, device=dev, generator=g)[:n_sel].to(torch.int32)
        if n_sel > 2:
            ids[:2] = torch.tensor([0, 1], device=dev)
            ids[-1] = -1
        for nq_ in (1, 2, 7, 8, 9, 16, 17, 33):
            for kk, cbk, ties in ((pk, cb_ivf, False), (pk, cb_ivf, True), (1024, cb16, False)):
                dt_e = (torch.randint(0, 3, (nq_, pm, kk), device=dev, generator=g).float()
                        if ties else torch.rand((nq_, pm, kk), device=dev, generator=g) * 10)
                tag = f'1024 blocks x 1024 k={kk}{" ties" if ties else ""}'
                check_ivf(tag, ids, dt_e, cbk, mb_ivf, record=False)
                # K6's other body at this shape (its plan picks one by time)
                picked = iv.ivf_plan('ivf_block_top2', nq_, n_sel, 1024, pm, kk, n_sms)
                other = (iv._core_plan(nq_, n_sel, 1024, pm, kk) if picked.kernel == 'top2'
                         else iv._top2_plan(nq_, n_sel, 1024, pm, kk, n_sms))
                if not all(map(torch.equal, iv.ivf_block_top2(ids, dt_e, cbk, mb_ivf, other),
                               iv._ivf_block_top2_ref(ids, dt_e, cbk, mb_ivf))):
                    fail(f'ivf_block_top2 {tag} S={n_sel} q={nq_} ({other.kernel}): rows or '
                         'scores differ from the plain version')
                ivf_edges += 1
    checks.append(f'ivf_scores, ivf_block_top2 (both bodies) + lane8_merge at {ivf_edges} '
                  'plan edges (S 1-300, Q 1-33, k 256 u8 and 1024 u16, ties): rows equal, '
                  'scores bit-equal')
    del cb_ivf, mb_ivf, cb16

    # K8 at the graph path's shapes: N = 131,072 rows of row-major codes, a
    # beam of C = B*R = 256 (B 8, R 32) and 512 (B 16) candidates, Q = 64
    # and 1; M = 64, K = 256 u8, then K = 1024 u16 at M = 16 and at M = 64
    # (a 256 KB table, tiled over subspaces).  Ids -1, N and NO_ID score BIG.
    ng = 131072

    def check_lut(tag, ids, codes, dt):
        tag = f'{tag} q={ids.shape[0]} c={ids.shape[1]}'
        out = ad.lut_pq_kernel(ids, codes, dt)
        ref = ad._lut_pq_scores_ref(ids, codes, dt)
        if not (torch.equal(out, ref) and bool((out[:, :3] == 3.4e38).all())):
            fail(f'lut_pq_scores {tag}: scores differ from the plain version')
        err['lut_pq_scores'] = max(err['lut_pq_scores'], maxerr(out, ref))
        checks.append(f'lut_pq_scores {tag}: scores bit-equal, invalid ids BIG')

    for lm, lk, ldt in ((64, 256, torch.uint8), (16, 1024, torch.uint16),
                        (64, 1024, torch.uint16)):
        codes_l = torch.randint(0, lk, (ng, lm), device=dev, generator=g,
                                dtype=torch.int32).to(ldt)
        for nq_ in (64, 1):
            for c_ in (256, 512):
                ids = torch.randint(0, ng, (nq_, c_), device=dev, generator=g,
                                    dtype=torch.int32)
                ids[:, :3] = torch.tensor([-1, ng, bm.NO_ID], dtype=torch.int32, device=dev)
                dt = torch.rand((nq_, lm, lk), device=dev, generator=g) * 10
                check_lut(f'n=131072 m={lm} k={lk} {str(ldt)[6:]}', ids, codes_l, dt)
        if lk == 256:
            codes_g = codes_l
    del codes_l
    # K8's time at Q = 64, C = 256, M = 64, K = 256; the library yardstick is
    # one embedding_bag over the gathered codes offset by (q*M + m)*K
    ids_g = torch.randint(0, ng, (64, 256), device=dev, generator=g, dtype=torch.int32)
    dt_g = torch.rand((64, pm, pk), device=dev, generator=g) * 10
    lbag_idx = (codes_g[ids_g.long()].long() + torch.arange(pm, device=dev) * pk
                + (torch.arange(64, device=dev) * pm * pk)[:, None, None]).reshape(64 * 256, pm)
    lbag_w = dt_g.reshape(-1, 1)
    lbag = torch.nn.functional.embedding_bag(lbag_idx, lbag_w, mode='sum').reshape(64, 256)
    if not torch.allclose(lbag, ad._lut_pq_scores_ref(ids_g, codes_g, dt_g), rtol=1e-5):
        fail('embedding_bag does not compute the per-query ADC scores')
    lut_times = (cuda_ms(lambda: ad.lut_pq_kernel(ids_g, codes_g, dt_g)),
                 cuda_ms(lambda: ad._lut_pq_scores_ref(ids_g, codes_g, dt_g)))
    lut_library_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        lbag_idx, lbag_w, mode='sum'))
    lut_bound = bound(64 * pm * pk * 4 + 64 * 256 * 4 + 64 * 256 * pm + 64 * 256 * 4,
                      64.0 * 256 * pm, FP32_OPS_PER_S, 64.0 * 256 * pm)
    del ids_g, dt_g, lbag_idx, lbag_w, lbag

    # beam_pq (K8 with its loop) at the graph phase's width: 131,072 rows, a
    # random degree-32 adjacency with 10% -1 pads, PQ64 u8 codes, ef 128,
    # B 8, 8 entries per query (a -1 in query 0, a duplicate in query 2,
    # only -1s in query 1); Q = 64 and 1, a budget of 3 iterations, and u16
    # codes at K = 1024, whose 256 KB table is read from global memory.
    # Held to the eager loop with the plain scorer over the whole list
    # (k = L): ids and distances bit-equal.
    adj_b = torch.randint(0, ng, (ng, 32), device=dev, generator=g, dtype=torch.int32)
    adj_b[torch.rand((ng, 32), device=dev, generator=g) < 0.1] = -1
    ent_b = torch.randint(0, ng, (64, 8), device=dev, generator=g, dtype=torch.int32)
    ent_b[0, 0] = -1
    ent_b[1, :] = -1
    ent_b[2, 1] = ent_b[2, 0]
    codes_b16 = torch.randint(0, 1024, (ng, pm), device=dev, generator=g,
                              dtype=torch.int32).to(torch.uint16)
    dt_b = torch.rand((64, pm, pk), device=dev, generator=g) * 10
    dt_b16 = torch.rand((64, pm, 1024), device=dev, generator=g) * 10

    def check_beam(tag, adj, entry, codes, dt, L, B, iters):
        d, ids, its = bm.beam_pq_kernel(adj, entry, codes, dt, L, L, B, iters)
        d_ref, ids_ref = bm._beam_loop(adj, entry, L, B, iters, L,
                                       lambda c: ad._lut_pq_scores_ref(c, codes, dt))
        tag = f'{tag} q={entry.shape[0]} ef={L} B={B} iters={iters}'
        if not (torch.equal(ids, ids_ref) and torch.equal(d, d_ref)):
            fail(f'beam_pq {tag}: ids or distances differ from the eager loop')
        err['beam_pq'] = max(err['beam_pq'], maxerr(d, d_ref))
        checks.append(f'beam_pq {tag}: ids and distances bit-equal to the eager loop, '
                      f'{int(its.max())} iterations at most')
        return its

    plan_b = bm.beam_pq_plan(128, 8, 32, pm, pk)
    plan_b16 = bm.beam_pq_plan(128, 8, 32, pm, 1024)
    if not plan_b.table_in_smem or plan_b16.table_in_smem:
        fail('beam_pq: the plans do not take both table variants')
    beam_its = check_beam('n=131072 m=64 k=256 u8', adj_b, ent_b, codes_g, dt_b, 128, 8, 32)
    if int(beam_its[1]) != 0 or int(beam_its.max()) < 3:
        fail(f'beam_pq: iterations {beam_its.tolist()} (query 1 has no valid entry)')
    check_beam('n=131072 m=64 k=256 u8', adj_b, ent_b[:1].contiguous(), codes_g,
               dt_b[:1].contiguous(), 128, 8, 32)
    check_beam('n=131072 m=64 k=256 u8', adj_b, ent_b, codes_g, dt_b, 128, 8, 3)
    check_beam('n=131072 m=64 k=1024 u16 (table in L2)', adj_b, ent_b, codes_b16, dt_b16,
               128, 8, 32)
    # 2,048 and 4,096 sort slots: four and eight keys a thread
    for ef_, b_, it_ in ((1024, 8, 12), (2048, 64, 8)):
        check_beam('n=131072 m=64 k=256 u8', adj_b, ent_b[:8].contiguous(), codes_g,
                   dt_b[:8].contiguous(), ef_, b_, it_)
    # beyond the sort ceiling (ef 4096: 8,192 slots) the search keeps the
    # eager loop around K8, as a user's call takes it
    (d_c, ids_c), ceiling_counts = drive(
        'beam_search_pq beyond the sort ceiling', ['lut_pq_scores'],
        lambda: bm.beam_search_pq(adj_b, ent_b[:8].contiguous(), codes_g,
                                  dt_b[:8].contiguous(), k=4096, L=4096, B=8, iters=3))
    d_cr, ids_cr = bm._beam_loop(adj_b, ent_b[:8].contiguous(), 4096, 8, 3, 4096,
                                 lambda c: ad._lut_pq_scores_ref(c, codes_g, dt_b[:8]))
    if (bm.beam_pq_plan(4096, 8, 32, pm, pk) is not None or ceiling_counts['beam_pq']
            or not (torch.equal(ids_c, ids_cr) and torch.equal(d_c, d_cr))):
        fail('beam_search_pq beyond the ceiling: not the eager loop around K8, or it differs')
    checks.append('beam_search_pq ef=4096 (8,192 slots): the eager loop around '
                  'lut_pq_scores, equal to the plain scorer\'s')
    beam_plans = {'ef128 u8 k256': plan_b._asdict(), 'ef128 u16 k1024': plan_b16._asdict()}
    del codes_g, adj_b, ent_b, codes_b16, dt_b, dt_b16, d_c, ids_c, d_cr, ids_cr

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
    k4_q1_ms = cuda_ms(lambda: ad.adc_block_top2(dt_all[:1].contiguous(), codes_pq, ones_pq,
                                                 4096))
    # K4's and K5's cores by batch, about the wide tile's edges (tiles of 16
    # at 16, 33 and 100; the wide tile at 17, 32 and 64)
    adc_batch_ms = {
        f'{name} q{q_}': cuda_ms(lambda: fn(dt_all[:q_].contiguous()))
        for name, fn in (('adc_block_top2', lambda d: ad.adc_block_top2(d, codes_pq, ones_pq,
                                                                         4096)),
                         ('adc_scores', lambda d: ad.adc_scores_kernel(d, codes_pq, ones_pq)))
        for q_ in (16, 17, 32, 33, 64, 100)}
    nb_pq = npq // 4096
    adc_bounds = {
        'adc_scores': bound(npq * pm + 64 * pm * pk * 4 + npq + 64 * npq * 4,
                            64.0 * npq * pm, FP32_OPS_PER_S, 64.0 * npq * pm),
        'adc_block_top2': bound(npq * pm + 64 * pm * pk * 4 + npq + 64 * nb_pq * 256 * 8,
                                64.0 * npq * pm, FP32_OPS_PER_S, 64.0 * npq * pm),
    }
    # the core's plans at the shapes of this run, with the kernels one call
    # launches, registers and spills
    adc_geometry = {
        'adc_block_top2 q64 n=2^20': ad.adc_info('adc_block_top2', 64, nb_pq, 4096, pm, pk),
        'adc_block_top2 q1 n=2^20': ad.adc_info('adc_block_top2', 1, nb_pq, 4096, pm, pk),
        'adc_scores q64 n=2^20': ad.adc_info('adc_scores', 64, nb_pq, 4096, pm, pk),
        'adc_block_top2 q100 n=2^20': ad.adc_info('adc_block_top2', 100, nb_pq, 4096, pm, pk),
        'adc_block_top2 q64 n=131072': ad.adc_info('adc_block_top2', 64, 32, 4096, pm, pk),
        'adc_block_top2 q64 n=2^17 k=1024 u16': ad.adc_info('adc_block_top2', 64, 128, 1024,
                                                             pm, 1024, 2),
        'adc_block_top2 q16 n=2^20': ad.adc_info('adc_block_top2', 16, nb_pq, 4096, pm, pk),
        'adc_block_top2 q17 n=2^20': ad.adc_info('adc_block_top2', 17, nb_pq, 4096, pm, pk),
        'adc_block_top2 q33 n=2^20': ad.adc_info('adc_block_top2', 33, nb_pq, 4096, pm, pk),
    }
    k4_merge_bound = merge_bound(64, nb_pq)

    # K9 at the ADC shapes (N = 2^20, M = 64, K = 256, u8) and at its plan's
    # edges: Q in {1, 3, 4, 5, 8, 9, 64, 100} (tiles of 1, 4 and 8, Q not a
    # multiple of the tile), M = 258 (the 16-bit lanes folded past 256
    # subspaces, the table in chunks), u16 codes at K = 1024, N % 4 != 0;
    # masked and unmasked: bit-equal to its plain version, and within 1% of
    # K5's largest score (the int8 table's rounding)
    i8_rel = [0.0]

    def check_i8(tag, dt, codes, mk):
        t8, sc8, off8 = ai.quantize_dtable(dt)
        sc8, off8 = sc8[:, 0].contiguous(), off8[:, 0].contiguous()
        tag = f'{tag} q={dt.shape[0]}'
        out = ai.adc_i8_kernel(t8, codes, mk, sc8, off8)
        if not torch.equal(out, ai._adc_scores_i8_ref(t8, codes, mk, sc8, off8)):
            fail(f'adc_scores_i8 {tag}: scores differ from the plain version')
        k5 = ad.adc_scores_kernel(dt, codes, mk)
        keep = mk > 0
        rel = ((out - k5)[:, keep].abs().max() / k5[:, keep].abs().max()).item()
        if not rel < 0.01 or not torch.equal(out[:, ~keep], k5[:, ~keep]):
            fail(f'adc_scores_i8 {tag}: {rel} of K5\'s largest score')
        i8_rel[0] = max(i8_rel[0], rel)
        checks.append(f'adc_scores_i8 {tag}: scores bit-equal, within 1% of K5')

    i8_qs = (1, 3, 4, 5, 8, 9, 64, 100)
    for nq_ in i8_qs:
        for mtag, mk in (('unmasked', ones_pq), ('mask 50%', keep_pq)):
            check_i8(f'n=2^20 m=64 k=256 u8 {mtag}', dt_all[:nq_].contiguous(), codes_pq, mk)
    ne9 = (1 << 17) + 5
    keep9 = (torch.rand(ne9, device=dev, generator=g) < 0.5).to(torch.int8)
    for m9, k9, dt9 in ((258, 256, torch.uint8), (64, 1024, torch.uint16)):
        codes9 = torch.randint(0, k9, (m9, ne9), device=dev, generator=g,
                               dtype=torch.int32).to(dt9)
        tab9 = torch.rand((100, m9, k9), device=dev, generator=g) * 10
        for nq_ in i8_qs:
            for mtag, mk in (('unmasked', torch.ones_like(keep9)), ('mask 50%', keep9)):
                check_i8(f'n=2^17+5 m={m9} k={k9} {str(dt9)[6:]} {mtag}',
                         tab9[:nq_].contiguous(), codes9, mk)
    del codes9, tab9, keep9
    i8_geometry = {f'q{q_} n={ntag} m={m_} k={k_} cb{cb}': ai.adc_i8_info(q_, n_, m_, k_, cb)
                   for q_, ntag, n_, m_, k_, cb in (
                       (64, '2^20', npq, pm, pk, 1), (1, '2^20', npq, pm, pk, 1),
                       (3, '2^20', npq, pm, pk, 1), (100, '2^20', npq, pm, pk, 1),
                       (64, '2^17+5', ne9, 258, 256, 1), (64, '2^17+5', ne9, 64, 1024, 2))}
    t8, sc8, off8 = ai.quantize_dtable(dt64)
    sc8, off8 = sc8[:, 0].contiguous(), off8[:, 0].contiguous()
    # library yardstick: K5's embedding_bag over the int8 table widened to
    # float32 (exact integer sums: |acc| <= 127 * M < 2^24)
    bag_w8 = t8.float().permute(1, 2, 0).reshape(pm * pk, 64).contiguous()
    bag8 = torch.nn.functional.embedding_bag(bag_idx, bag_w8, mode='sum')
    if not torch.equal(bag8.T * sc8[:, None] + off8[:, None],
                       ai._adc_scores_i8_ref(t8, codes_pq, ones_pq, sc8, off8)):
        fail('embedding_bag does not compute the int8-table scores')
    i8_times = (cuda_ms(lambda: ai.adc_i8_kernel(t8, codes_pq, ones_pq, sc8, off8)),
                cuda_ms(lambda: ai._adc_scores_i8_ref(t8, codes_pq, ones_pq, sc8, off8), 5))
    i8_library_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        bag_idx, bag_w8, mode='sum'))
    i8_bound = bound(npq * pm + 64 * pm * pk + npq + 64 * npq * 4 + 64 * 8,
                     64.0 * npq * pm, FP32_OPS_PER_S, 64.0 * npq * pm, lookup_bytes=1)
    # K9's own entry point, adc_scores_i8, as a user calls it
    s_i8, i8_counts = drive('adc_scores_i8 q=64 n=2^20', ['adc_scores_i8'],
                            lambda: ai.adc_scores_i8(dt64, codes_pq, keep_pq))
    if s_i8.shape != (64, npq) or not bool(torch.isfinite(s_i8).all()):
        fail('adc_scores_i8: result of the wrong shape or not finite')
    del t8, sc8, off8, bag_w8, bag8, s_i8
    del dt_all, codes_pq, keep_pq, ones_pq, bag_idx, bag_w, bag, dt64

    # K3 at Q = 64 and 1, R = 40 (the int8 and bf16 shortlists) and 128 (int4's),
    # each beside its bound and the two-call yardstick index_select +
    # torch.bmm in float32 (no one PyTorch call computes the rerank)
    gather_times, gather_geometry = {}, {}
    for nq_, r_ in ((64, 40), (64, 128), (1, 40), (1, 128)):
        qg = l2_normalize(qf[:nq_])
        cg = torch.randint(0, n, (nq_, r_), device=dev, generator=g, dtype=torch.int32)
        cl = cg.long().view(-1)
        qcol = qg.view(nq_, d, 1)
        gather_times[f'q{nq_} r{r_}'] = {
            'ms': cuda_ms(lambda: ga.gather_rerank(qg, x, cg, int(Metric.COSINE))),
            'plain_ms': cuda_ms(lambda: ga._gather_rerank_ref(qg, x, cg, int(Metric.COSINE))),
            'index_select_plus_bmm_ms_two_calls': cuda_ms(
                lambda: torch.bmm(x.index_select(0, cl).view(nq_, r_, d), qcol)),
            'bound_ms': bound(nq_ * d * 4 + nq_ * r_ * d * 4 + nq_ * r_ * 8,
                              2.0 * nq_ * r_ * d, FP32_OPS_PER_S)[0]}
        gather_geometry[f'q{nq_} r{r_} d{d}'] = {**ga.gather_plan(nq_, r_)._asdict(),
                                                 **ga.gather_info(d)}
    gather_geometry['d100 scalar'] = ga.gather_info(100, vec4=False)
    gather_geometry[f'd{ga.MAX_GATHER_DIM}'] = ga.gather_info(ga.MAX_GATHER_DIM)
    del qg, cg, cl, qcol

    cos_bias = cases[0][1]
    times = {
        'block_top2': (cuda_ms(lambda: fs.block_top2(q8, qsc, x8, xs, cos_bias, br, -1.0)),
                       cuda_ms(lambda: fs._fused_scan_ref(q8, qsc, x8, xs, cos_bias, br, -1.0))),
        'lane8_merge': (cuda_ms(lambda: fs.lane8_merge(s_blk, r_blk)),
                        cuda_ms(lambda: fs._lane8_merge_ref(s_blk, r_blk))),
        'gather_rerank': (gather_times['q64 r40']['ms'], gather_times['q64 r40']['plain_ms']),
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
    times.update(variant_times)
    bounds.update(variant_bounds)
    times['lut_pq_scores'], bounds['lut_pq_scores'] = lut_times, lut_bound
    times['adc_scores_i8'], bounds['adc_scores_i8'] = i8_times, i8_bound
    library_ms['lut_pq_scores'] = lut_library_ms
    library_ms['adc_scores_i8'] = i8_library_ms
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
          'k4_adc_block_top2_q1_ms': k4_q1_ms,
          'adc_core_by_batch_ms': adc_batch_ms,
          'adc_geometry': adc_geometry,
          'adc_scores_i8_max_rel_err_vs_adc_scores': i8_rel[0],
          'adc_scores_i8_geometry': i8_geometry,
          'gather_rerank_times': gather_times,
          'gather_rerank_geometry': gather_geometry,
          'adc_scores_i8_entry_point_launches': i8_counts,
          'block_top2_variants_ms_q1': variant_q1_ms,
          'block_top2_variants_ms_q32': variant_q32_ms,
          'block_top2_variants_rows_differing_from_plain': rows_differing,
          'block_top2_bf16_unit_rows_err_over_tol': bf16_err_share[0],
          'k1_variants_block_pass_plus_lane8_merge_ms': variant_k1_ms,
          'block_pass_geometry': block_pass_geometry,
          'product_only_ms': product_only_ms,
          'lane8_merge_tie_heavy_ms': lane8_ms, 'lane8_merge_tie_heavy_bound_ms': lane8_bounds,
          'lane8_merge_ranges': {f'nb{b}_q{q_}': fs.lane8_merge_plan(q_, b)
                                 for b in (128, 256) for q_ in (64, 1)},
          'beam_pq_plans': beam_plans,
          'shapes': 'Q=64 D=768; block_top2(_int4, _bf16)/lane8_merge N=2^20; gather R=40; '
                    'adc_* Q=64 N=2^20 M=64 K=256 u8; lut_pq_scores Q=64 C=256 '
                    'N=131072 M=64 K=256 u8'})
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

    # the flat phase's rows, queries and masks serve its int4 and bf16
    # phases too; the float32 brute force is computed once
    rng = np.random.default_rng(SEED)
    xn = rng.standard_normal((n, d), dtype=np.float32)
    queries = torch.from_numpy(rng.standard_normal((nq, d), dtype=np.float32)).to(dev)
    masks = {sel: rng.random(n) < sel for sel in (0.05, 0.80)}
    exact_top10 = []
    kept = {}

    def flat_phase(mode, block_kernel, min_recall):
        """A 2^20 x 768 cosine ``FlatIndex`` in ``mode`` over ``xn``: recall@10
        against the float32 brute force, batch 1 against row 0 of batch 64,
        masked rows inside their masks, latencies, peak device memory."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = FlatIndex(d, metric='cosine', scan_mode=mode)
        index.add_with_ids(xn, np.arange(n))
        ingest_s = time.perf_counter() - t0

        def flat_path():
            run = index.device_searcher(limit=10)
            out = {'b64': run(queries), 'b1': run(queries[:1])}
            for sel, m in masks.items():
                out[sel] = index.device_searcher(limit=10, mask=m)(queries)
            return run, out

        (run, res), counts = drive(f'flat {mode} 2^20x768',
                                   [block_kernel, 'lane8_merge', 'gather_rerank'], flat_path)
        if mode == 'int8':
            kept['flat'] = index  # phase 15 times it beside the sharded index
        if counts['gather_rerank'] != 4:
            fail(f'flat {mode}: {counts["gather_rerank"]} gather_rerank launches in 4 searches')
        if not exact_top10:
            xdev = index._buf.device_view()
            exact = torch.sort(1.0 - l2_normalize(queries) @ xdev.T, dim=1, stable=True)
            exact_top10.extend(exact.indices[:, :10].tolist())
            del exact, xdev
        recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(
            res['b64'][1].tolist(), exact_top10)]))
        if recall < min_recall:
            fail(f'flat {mode} recall@10 {recall} < {min_recall}')
        (d1, i1), (d64, i64) = res['b1'], res['b64']
        if not (torch.equal(i1[0], i64[0])
                and torch.allclose(d1[0], d64[0], rtol=1e-6, atol=0.0)):
            fail(f'flat {mode} batch 1: result differs from row 0 of batch 64')
        lat = {'batch64_ms': host_ms(lambda: run(queries)),
               'batch1_ms': host_ms(lambda: run(queries[:1]))}
        for sel, m in masks.items():
            rows = res[sel][1].cpu().numpy()
            if not m[rows].all():
                fail(f'flat {mode} mask {sel}: a returned row lies outside the mask')
            mrun = index.device_searcher(limit=10, mask=m)
            lat[f'mask{int(sel * 100)}pct_batch64_ms'] = host_ms(lambda: mrun(queries))
        return {'phase': 'flat' if mode == 'int8' else f'flat_{mode}', 'n': n, 'dim': d,
                'metric': 'cosine', 'scan_mode': mode, 'host_ingest_s': ingest_s,
                'recall_at_10_vs_fp32': recall, 'qps_batch64': nq / lat['batch64_ms'] * 1e3,
                'latency_ms': lat, 'masked_rows_in_mask': True,
                'batch1_equals_batch64_row0': True, 'launches': counts,
                'peak_device_bytes': torch.cuda.max_memory_allocated()}

    emit({**flat_phase('int8', 'block_top2', 0.995),
          'scan_topk_n16384_recall_at_10': recall_s,
          'scan_topk_n16384_launches': k2_counts})
    emit(flat_phase('int4', 'block_top2_int4', 0.98))
    emit(flat_phase('bf16', 'block_top2_bf16', 0.995))
    torch.cuda.empty_cache()  # xn, the masks and exact_top10 stay for phase 15

    # ---------------- 6. the facade in the int4 and bf16 scan modes ----------------
    # 65,536 random normal docs of 256 dimensions (int4 then stores 128
    # bytes a row, which the fused kernel takes), cosine
    nsm, dsm = 1 << 16, 256
    xsm = np.random.default_rng(SEED).standard_normal((nsm, dsm), dtype=np.float32)

    def facade_mode_path(mode, data_dir):
        shutil.rmtree(data_dir, ignore_errors=True)
        cfg = dict(n_dim=dsm, metric='cosine', scan_mode=mode, data_path=data_dir)
        ann = AnnLite(**cfg)
        t = time.perf_counter()
        for lo in range(0, nsm, 16384):
            ann.index([Doc(id=str(i), embedding=xsm[i]) for i in range(lo, lo + 16384)])
        ingest = time.perf_counter() - t
        d_np, ids_np = ann.search_numpy(xsm[:nq], limit=10)
        if [row[0] for row in ids_np] != [str(i) for i in range(nq)]:
            fail(f'facade_scan_modes {mode}: a doc does not find itself first')
        serve = ann.serving_searcher(limit=10)
        _, ids_sv = serve(xsm[:nq])
        if ids_sv != ids_np:
            fail(f'facade_scan_modes {mode}: serving_searcher ids differ from search_numpy')
        serve_ms = host_ms(lambda: serve(xsm[:nq]), reps=10)
        ann.dump()
        ann.close()
        ann = AnnLite(**cfg)
        d_re, ids_re = ann.search_numpy(xsm[:nq], limit=10)
        if ids_re != ids_np or not all(np.array_equal(a, b) for a, b in zip(d_re, d_np)):
            fail(f'facade_scan_modes {mode}: results differ after dump and reopen')
        ann.close()
        shutil.rmtree(data_dir, ignore_errors=True)
        return {'ingest_docs_per_s': nsm / ingest, 'serving_ms_batch64': serve_ms}

    facade_modes = {}
    for mode in ('int4', 'bf16'):
        out, counts = drive(f'facade_scan_modes {mode}',
                            [f'block_top2_{mode}', 'lane8_merge', 'gather_rerank'],
                            lambda: facade_mode_path(mode, ROOT / 'build' / f'chip_smoke_{mode}'))
        facade_modes[mode] = dict(out, launches=counts)
    emit({'phase': 'facade_scan_modes', 'docs': nsm, 'dim': dsm, 'metric': 'cosine',
          'self_hits_64': 64, 'serving_equals_search_numpy': True, 'reopen_equal': True,
          **facade_modes})
    del xsm

    # ---------------- 7. the facade ----------------
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

    # ---------------- 8. PQ scan (bench.py ph_pqivf) ----------------
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
    # K4 and K5 on this phase's trained PQ64 codes (skewed, unlike the random
    # codes of kernels_vs_plain: bank conflicts depend on the codes), the
    # queries' own tables; checked against the plain versions, then timed
    codes_tr = torch.from_numpy(np.ascontiguousarray(codes.T)).to(dev)
    dt_tr = pq.dist_mat(qv).to(dev).float().contiguous()
    ones_tr = torch.ones(n2, dtype=torch.int8, device=dev)
    s_tr, r_tr = ad.adc_block_top2(dt_tr, codes_tr, ones_tr, 4096)
    s_tr_ref, r_tr_ref = ad._adc_block_top2_ref(dt_tr, codes_tr, ones_tr, 4096)
    if not (torch.equal(r_tr, r_tr_ref) and torch.equal(s_tr, s_tr_ref)
            and torch.equal(ad.adc_scores_kernel(dt_tr, codes_tr, ones_tr),
                            ad._adc_scores_ref(dt_tr, codes_tr, ones_tr))):
        fail('adc_block_top2 / adc_scores on the trained codes differ from the plain versions')
    trained_codes_ms = {
        'adc_block_top2': cuda_ms(lambda: ad.adc_block_top2(dt_tr, codes_tr, ones_tr, 4096)),
        'adc_scores': cuda_ms(lambda: ad.adc_scores_kernel(dt_tr, codes_tr, ones_tr)),
        'adc_block_top2_q1': cuda_ms(lambda: ad.adc_block_top2(
            dt_tr[:1].contiguous(), codes_tr, ones_tr, 4096))}
    del codes_tr, dt_tr, ones_tr, s_tr, r_tr, s_tr_ref, r_tr_ref
    emit({'phase': 'pq_scan', 'n': n2, 'dim': d2, 'm': 64, 'k': 256,
          'train_encode_s': pq_train_encode_s, 'host_ingest_s_two_indexes': pq_ingest_s,
          'recall_at_10_vs_fp32': pq_recall, 'latency_ms': pq_lat,
          'qps_rerank100_batch64': nq / pq_lat['rerank100_batch64_ms'] * 1e3,
          'masked_rows_in_mask': True, 'batch1_equals_batch64_row0': True,
          'trained_codes_kernel_ms_q64': trained_codes_ms,
          'random_codes_kernel_ms_q64': {k: adc_times[k][0] for k in adc_times},
          'launches': pq_counts})
    del pq_idx, idx100, res

    # ---------------- 9. IVF-PQ (bench.py _ivf_substeps) ----------------
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
    # K7's latency floor: one launch (an empty one's event time) plus two
    # dependent reads from DRAM (the codes, then the table entries they name)
    empty = torch.zeros(1, device=dev)
    k7_floor = {'empty_launch_ms': cuda_ms(lambda: empty.zero_()), 'dependent_dram_reads': 2}
    # the earlier timer (no spin before the start event), for the readings
    # taken with it
    old_timer_ms = {
        'ivf_block_top2': cuda_ms(lambda: iv.ivf_block_top2(s8_ids, dt8, cb, mb), spin=False),
        'ivf_scores': cuda_ms(lambda: iv.ivf_scores(s1_ids, dt1, cb), spin=False)}
    n8, n1 = len(sel8[0]) * 1024, len(sel1) * 1024
    bounds['ivf_block_top2'] = bound(n8 * 64 + 8 * 64 * 256 * 4 + len(sel8[0]) * 4 + n8
                                     + 8 * len(sel8[0]) * 256 * 8, 8.0 * n8 * 64,
                                     FP32_OPS_PER_S, 8.0 * n8 * 64)
    bounds['ivf_scores'] = bound(n1 * 64 + 64 * 256 * 4 + len(sel1) * 4 + n1 * 4,
                                 1.0 * n1 * 64, FP32_OPS_PER_S, 1.0 * n1 * 64)
    # K7's library yardstick: one embedding_bag over the probed blocks' codes
    # offset by m * K (the port never calls it)
    bag7_idx = (cb[s1_ids.long().clamp_min(0)].long().permute(0, 2, 1)
                + torch.arange(64, device=dev) * 256).reshape(-1, 64).contiguous()
    bag7_w = dt1.reshape(1, 64 * 256).T.contiguous()
    bag7 = torch.nn.functional.embedding_bag(bag7_idx, bag7_w, mode='sum')
    if not torch.allclose(bag7.reshape(len(sel1), 1024, 1).permute(0, 2, 1),
                          iv._ivf_scores_ref(s1_ids, dt1, cb), rtol=1e-5):
        fail('embedding_bag does not compute the IVF scores')
    library_ms['ivf_scores'] = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        bag7_idx, bag7_w, mode='sum'))
    old_timer_ms['ivf_scores_embedding_bag'] = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        bag7_idx, bag7_w, mode='sum'), spin=False)
    del bag7_idx, bag7_w, bag7
    ivf_geometry = {
        f'ivf_block_top2 q8 S={len(sel8[0])}': iv.ivf_info('ivf_block_top2', 8, len(sel8[0]),
                                                            1024, 64, 256),
        f'ivf_scores q1 S={len(sel1)}': iv.ivf_info('ivf_scores', 1, len(sel1), 1024, 64, 256)}
    emit({'phase': 'ivf_pq', 'n': n2, 'cells': 1024, 'block': 1024,
          'build_s': ivf_build_s, 'recall_at_10_vs_fp32_probe8': ivf_recall,
          'scanned_fraction_probe8': {'mean': float(np.mean([len(s) for s in sel8])) * 1024 / n2,
                                      'max': max(len(s) for s in sel8) * 1024 / n2},
          'blocks_probe8': [len(s) for s in sel8], 'blocks_probe1': len(sel1),
          'latency_ms': ivf_lat, 'qps_probe8_batch8': 8 / ivf_lat['probe8_batch8_ms'] * 1e3,
          'k6_ivf_block_top2_plus_lane8_merge_ms': k6_ms,
          'k6_lane8_merge_bound_ms': merge_bound(8, len(sel8[0])),
          'k6_ms': times['ivf_block_top2'][0], 'k6_bound_ms': bounds['ivf_block_top2'][0],
          'k7_ms': times['ivf_scores'][0], 'k7_embedding_bag_ms': library_ms['ivf_scores'],
          'k7_bound_ms': bounds['ivf_scores'][0], 'k7_latency_floor': k7_floor,
          'old_timer_ms': old_timer_ms, 'adc_geometry': ivf_geometry,
          'launches': ivf_counts, 'kernel_shapes': {
              'ivf_block_top2': f'Q=8 S={len(sel8[0])}', 'ivf_scores': f'Q=1 S={len(sel1)}'}})
    del ivf, cb, mb, xs_dev, xs_sq  # xs, codes, cells stay for phase 15
    torch.cuda.empty_cache()

    # ---------------- 10. the facade with PQ codecs ----------------
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

    # ---------------- 11. graph search (bench.py ph_graph) ----------------
    # bench.py's _graph_corpus: 131,072 x 128 euclidean rows, 1024 centres x
    # 2.0 plus unit noise (numpy seed 1234); the device Vamana build of
    # ph_graph (R 32, l_build 64; the builder's defaults otherwise: batch
    # 16,384, build beam width 16, slack 16, so W = 48); ph_graph's queries
    # (seed 77: 64 corpus rows plus 0.1 noise); ef 128, beam width 8, 4096
    # sampled entries of which 8 seed each query.  A GraphIndex hands its
    # beam width to the builder, so the index that builds takes the builder's
    # 16 and the searching ones, each traversal, load its W-wide graph.
    gn = 131072
    grng = np.random.default_rng(1234)
    gcent = (grng.standard_normal((1024, d2)) * 2.0).astype(np.float32)
    gx = (gcent[grng.integers(0, 1024, gn)] + grng.standard_normal((gn, d2))).astype(np.float32)
    rq = np.random.default_rng(77)
    gq = (gx[rq.integers(0, gn, nq)] + 0.1 * rq.standard_normal((nq, d2))).astype(np.float32)
    gkw = dict(metric='euclidean', max_degree=32, l_build=64, ef_search=128, beam_width=8,
               n_entry_samples=4096, entry_width=8, build_mode='device')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    build_spans0 = {k: v['total_ns'] * 1e-9 for k, v in tracer.snapshot()['spans'].items()}
    t0 = time.perf_counter()
    gbuilt = GraphIndex(d2, **dict(gkw, beam_width=16))
    gbuilt.add_with_ids(gx, np.arange(gn))
    torch.cuda.synchronize()
    graph_build_s = time.perf_counter() - t0
    graph_build_peak = torch.cuda.max_memory_allocated() - mem0
    graph_build_stats = {k[len('annlite.build.'):]: v['total_ns'] * 1e-9 - build_spans0.get(k, 0.0)
                         for k, v in tracer.snapshot()['spans'].items()
                         if k.startswith('annlite.build.')}
    graph_w = gbuilt._graph.w
    graph_integrity = gbuilt.check_integrity()
    if not graph_integrity['ok'] or graph_integrity['reachable_fraction'] < 0.999:
        fail(f'graph: the device build fails its integrity check or reaches under '
             f'99.9% of rows {graph_integrity}')
    if graph_integrity['degree_max'] > graph_w or graph_integrity['self_loops']:
        fail(f'graph: a degree above W = {graph_w} or a self-loop {graph_integrity}')
    gstate = gbuilt.state_arrays()
    del gbuilt
    if gstate['adjacency'].shape != (gn, graph_w):
        fail(f'graph: the snapshot adjacency is {gstate["adjacency"].shape}, not W-wide')
    gbase = GraphIndex(d2, **gkw)
    gbase.load_state_arrays(gstate)
    # the host build on the first 20,000 rows, for its rows/s beside the
    # device build's (every host thread), after a build of 64 rows that
    # compiles the native builder at its first use
    hkw = dict(gkw, build_mode='host')
    GraphIndex(d2, **hkw).add_with_ids(gx[:64], np.arange(64))
    t0 = time.perf_counter()
    GraphIndex(d2, **hkw).add_with_ids(gx[:20000], np.arange(20000))
    host_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpq = PQCodec(d2, n_subvectors=64, n_clusters=256, metric='euclidean', n_init=1)
    gpq.fit(gx[:20000], iter=15)
    gpq_train_s = time.perf_counter() - t0
    gidx = {'vectors': gbase}
    for name, kw in (('pq_rerank0', dict(pq_codec=gpq, rerank=0, traverse='pq')),
                     ('pq_rerank100', dict(pq_codec=gpq, rerank=100, traverse='pq')),
                     ('int8', dict(traverse='int8')), ('packed', dict(traverse='packed'))):
        gidx[name] = GraphIndex(d2, **gkw, **kw)
        gidx[name].load_state_arrays(gstate)
    gxd = torch.from_numpy(gx).to(dev)
    gsq = torch.sum(gxd * gxd, dim=1)

    def gbrute(qv, mask=None, k=10, dists=False):
        """Exact float32 L2 top-k rows of the graph corpus (under a mask),
        in the operations of the graph's exact-scan fallback; with
        ``dists`` also their distances and the whole [Q, N] matrix."""
        qd = torch.from_numpy(qv).to(dev)
        dd = torch.sum(qd * qd, dim=1)[:, None] + gsq[None, :] - 2.0 * (qd @ gxd.T)
        if mask is not None:
            dd = torch.where(torch.from_numpy(mask).to(dev)[None, :], dd, 3.4e38)
        srt = torch.sort(dd, dim=1, stable=True)
        ids = srt.indices[:, :k].cpu().numpy()
        return (srt.values[:, :k].cpu().numpy(), ids, dd.cpu().numpy()) if dists else ids

    ggt = gbrute(gq)
    mrng = np.random.default_rng(SEED + 2)
    gmasks = {sel: mrng.random(gn) < sel for sel in (0.5, 0.05)}
    gq_t = torch.from_numpy(gq).to(dev)

    def graph_path():
        out = {name: idx.search(gq, 10) for name, idx in gidx.items()}
        for sel, m in gmasks.items():
            out[sel] = gbase.search(gq, 10, mask=m)
        out['searcher'] = {name: idx.device_searcher(limit=10)(gq_t)
                           for name, idx in gidx.items()}
        return out

    gres, graph_counts = drive('graph 131072 x 128', ['beam_pq', 'beam_vec'], graph_path)
    graph_recall = {name: recall_at_10(gres[name][1], ggt) for name in gidx}
    for name in gidx:
        dd, ii = gres[name]
        if dd.shape != (nq, 10) or not np.isfinite(dd).all():
            fail(f'graph {name}: result of shape {dd.shape} or not finite')
        if not np.array_equal(gres['searcher'][name][1].cpu().numpy(), ii):
            fail(f'graph {name}: device_searcher ids differ from search')
    if graph_recall['vectors'] < 0.95 or graph_recall['pq_rerank100'] < 0.90:
        fail(f'graph recall@10 {graph_recall} below 0.95 (vectors) or 0.90 (PQ, rerank 100)')
    for sel, m in gmasks.items():
        dd, ii = gres[sel]
        if not m[ii[dd < 1e37]].all():
            fail(f'graph mask {sel}: a returned row lies outside the mask')
    # below filter_fallback_selectivity the search is the exact masked scan
    # (csrc/masked_scan.cu): the brute force's rows at their distances, rank
    # by rank, but for float32 rounding (K3's stated tolerance, 1e-5 of |q|^2
    # + |x|^2): the kernel sums in another order than the product
    bd, _, bmat = gbrute(gq, gmasks[0.05], dists=True)
    fd, fi = gres[0.05]
    ftol = 1e-5 * (np.sum(gq * gq, axis=1)[:, None] + gsq.cpu().numpy()[fi])
    if not (np.abs(fd - bd) <= ftol).all() or not (
            np.abs(np.take_along_axis(bmat, fi, axis=1) - bd) <= ftol).all():
        fail('graph mask 0.05: the exact-scan fallback differs from a masked brute force')
    # soft deletes: each query's own best row is deleted and never returned
    gdel = GraphIndex(d2, **gkw)
    gdel.load_state_arrays(gstate)
    dead = np.unique(gres['vectors'][1][:, 0])
    gdel.delete_rows(dead)
    _, ids_del = gdel.search(gq, 10)
    _, ids_del_sv = gdel.device_searcher(limit=10)(gq_t)
    if np.isin(ids_del, dead).any() or np.isin(ids_del_sv.cpu().numpy(), dead).any():
        fail('graph: a deleted row was returned')
    del gdel
    # latency of each traversal (device_searcher, host clock), and the
    # port's kernels launched by one PQ search
    graph_lat, pq_launches = {}, {}
    for name, idx in gidx.items():
        run = idx.device_searcher(limit=10)
        graph_lat[f'{name}_batch64_ms'] = host_ms(lambda: run(gq_t), reps=10)
        graph_lat[f'{name}_batch1_ms'] = host_ms(lambda: run(gq_t[:1]), reps=10)
        if name.startswith('pq'):
            before = launch_counts()
            run(gq_t)
            pq_launches[name] = {k: n - before[k] for k, n in launch_counts().items()
                                 if n != before[k]}
    # beam_pq on this graph, as the PQ searches call it (entry: the medoid,
    # ef 128, B 8, 32 iterations at most): held to the eager loop with the
    # plain scorer, then timed at Q = 64 and 1 beside that loop; its bound
    # counts the tables, the adjacency rows (W wide) of the nodes expanded and
    # the code rows of the ids scored (seeds and the valid neighbours: the
    # kernel reads no code row for a -1 slot), with M table lookups each,
    # all read off a counting run of the eager loop
    sv = gidx['pq_rerank0']._sync_device()
    dt_g = gpq.dist_mat(gq_t).to(dev).float().contiguous()
    ent_g = torch.full((nq, 1), sv.medoid, dtype=torch.int32, device=dev)
    iters_g = bm._resolve_iters(None, 128, 8)

    def graph_beam(nq_):
        return bm.beam_pq_kernel(sv.adj, ent_g[:nq_], sv.codes, dt_g[:nq_].contiguous(),
                                 128, 128, 8, iters_g)

    def graph_beam_plain(nq_):
        dt_ = dt_g[:nq_].contiguous()
        return bm._beam_loop(sv.adj, ent_g[:nq_], 128, 8, iters_g, 128,
                             lambda c: ad._lut_pq_scores_ref(c, sv.codes, dt_))

    n_g = sv.codes.shape[0]
    read = {'adj_rows': 0, 'code_rows': 0}

    def score_counted(ids, dt_):
        read['code_rows'] += int(((ids >= 0) & (ids < n_g)).sum())
        return ad._lut_pq_scores_ref(ids, sv.codes, dt_)

    def expand_counted(safe_sel, sel_valid, dt_):
        read['adj_rows'] += int(sel_valid.sum())
        nbrs = torch.where(sel_valid[:, :, None], sv.adj[safe_sel], -1)
        nbrs = nbrs.reshape(nbrs.shape[0], -1)
        return nbrs, score_counted(nbrs, dt_)

    gb_d, gb_ids, gb_its = graph_beam(nq)
    dt_c = dt_g[:nq].contiguous()
    counted = bm._beam_loop(sv.adj, ent_g[:nq], 128, 8, iters_g, 128,
                            lambda c: score_counted(c, dt_c),
                            lambda s_, v_: expand_counted(s_, v_, dt_c))
    if not all(map(torch.equal, (gb_d, gb_ids), graph_beam_plain(nq))) or \
            not all(map(torch.equal, (gb_d, gb_ids), counted)):
        fail('beam_pq on the graph: ids or distances differ from the eager loop')
    checks_graph = [f'beam_pq on the 131,072-row graph q={nq}: ids and distances bit-equal '
                    'to the eager loop']
    gm = sv.codes.shape[1]
    w_g = sv.adj.shape[1]
    beam_read = {**read, 'slots_of_expanded_rows': read['adj_rows'] * w_g}
    times['beam_pq'] = (cuda_ms(lambda: graph_beam(nq)), cuda_ms(lambda: graph_beam_plain(nq), 5))
    bounds['beam_pq'] = bound(nq * gm * 256 * 4 + read['code_rows'] * gm
                              + read['adj_rows'] * w_g * 4 + nq * 4 + nq * 128 * 8,
                              read['code_rows'] * gm, FP32_OPS_PER_S, read['code_rows'] * gm)
    beam_q1_ms = cuda_ms(lambda: graph_beam(1))
    beam_q1_plain_ms = cuda_ms(lambda: graph_beam_plain(1), 5)
    del dt_g, dt_c, gb_d, gb_ids, counted
    # where a PQ search's device time goes, by operator, at batch 64 and 1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def device_events(prof):
        """The profile's kernels and copies on the card, each once (an aten
        op's own device time repeats its kernels')."""
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]

    def profile(run, qv):
        run(qv)
        torch.cuda.synchronize()
        try:  # a measurement aid: a profiler that cannot trace fails no check
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                run(qv)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            ka = prof.key_averages()
            kern = device_events(prof)
            ops = sorted((e for e in ka if e.key.startswith('aten::')
                          and e.device_time_total > 0), key=lambda e: -e.device_time_total)
            busy = sum(e.self_device_time_total for e in kern) / 1e3
            return {
                'wall_ms_profiled': wall_ms, 'device_busy_ms': busy,
                'device_idle_share': 1.0 - busy / wall_ms,
                'kernel_launches': sum(e.count for e in kern),
                'beam_pq_ms': sum(e.self_device_time_total for e in kern
                                  if 'beam_pq' in e.key) / 1e3,
                'top_aten_ops_device_ms': [(e.key, e.count, e.device_time_total / 1e3)
                                           for e in ops[:8]]}
        except Exception as e:  # noqa: BLE001
            return {'error': repr(e)}

    graph_profile = {}
    for name in ('pq_rerank0', 'pq_rerank100'):
        run = gidx[name].device_searcher(limit=10)
        graph_profile[f'{name}_batch64'] = profile(run, gq_t)
        graph_profile[f'{name}_batch1'] = profile(run, gq_t[:1])
    # a streaming append of 16,384 rows to a synced device-built index with
    # PQ64: it patches its serving state (encodes only the new rows), and a
    # searcher built before the append returns what it returned before (the
    # builder never writes a buffer it handed out)
    gapp = gidx['pq_rerank100']
    run = gapp.device_searcher(limit=10)
    before = [t.clone() for t in run(gq_t)]
    xa = (gcent[np.random.default_rng(4321).integers(0, 1024, 16384)]
          + np.random.default_rng(4322).standard_normal((16384, d2))).astype(np.float32)
    t0 = time.perf_counter()
    gapp.add_with_ids(xa, np.arange(gn, gn + 16384))
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    after = run(gq_t)
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        fail('graph: a device_searcher built before an append changed its results')
    sva = gapp._serving
    if gapp._dirty or sva.codes.shape[0] != gn + 16384 or not np.array_equal(
            sva.codes[gn:].cpu().numpy(), gpq.encode(xa)):
        fail('graph: the append did not patch the serving codes with the new rows only')
    app_integrity = gapp.check_integrity()
    if not app_integrity['ok']:
        fail(f'graph: integrity after the append {app_integrity}')
    emit({'phase': 'graph', 'n': gn, 'dim': d2, 'max_degree': 32, 'l_build': 64,
          'ef': 128, 'beam_width': 8, 'entry_samples': 4096, 'entry_width': 8,
          'build_mode': 'device', 'build_beam_width': 16, 'build_s': graph_build_s,
          'build_rows_per_s': gn / graph_build_s,
          'build_stage_s': graph_build_stats, 'build_peak_device_bytes': graph_build_peak,
          'build_w': graph_w, 'host_build_rows_20000_s': host_build_s,
          'host_build_rows_per_s': 20000 / host_build_s, 'host_build_threads': os.cpu_count(),
          'integrity': graph_integrity, 'pq_train_s': gpq_train_s,
          'append_16384_s': append_s, 'append_searcher_unchanged': True,
          'append_codes_patched': True, 'append_integrity': app_integrity,

          'recall_at_10_vs_fp32': graph_recall,
          'recall_at_10_mask50pct_vs_masked_fp32': recall_at_10(
              gres[0.5][1], gbrute(gq, gmasks[0.5])),
          'masked_rows_in_mask': True, 'mask5pct_equals_exact_scan': True,
          'deleted_never_returned': True, 'searcher_equals_search': True,
          'latency_ms': graph_lat,
          'qps_batch64': {k[:-len('_batch64_ms')]: nq / v * 1e3
                          for k, v in graph_lat.items() if k.endswith('_batch64_ms')},
          'pq_search_kernel_launches': pq_launches, 'profile_pq_search': graph_profile,
          'beam_pq_checks': checks_graph,
          'beam_pq_rows_read_q64': beam_read,
          'beam_pq_ms': {'q64': times['beam_pq'][0], 'q1': beam_q1_ms},
          'beam_pq_eager_plain_ms': {'q64': times['beam_pq'][1], 'q1': beam_q1_plain_ms},
          'beam_pq_iterations_q64': {'max': int(gb_its.max()),
                                     'mean': float(gb_its.float().mean())},
          'beam_pq_dependent_global_reads': 1 + 2 * int(gb_its.max()),
          'beam_pq_bound_ms_q64': bounds['beam_pq'][0],
          'launches': graph_counts})
    del gidx, gbase, gstate, gres, gxd, gsq, run, sv, ent_g, gb_its, gapp, sva, before, after
    torch.cuda.empty_cache()

    # beam_vec (the vector traversal in one launch) at the graph cell's shape:
    # 262,144 clustered integer rows of 128 dims in 0..255 (SIFT's shape),
    # the device build (R 32, W 48), ef 50, beam width 16, the 8 nearest of
    # 4,096 sampled entries a query, as the facade's search calls
    # beam_search_vectors.  Held bit-equal (ids, distances, iterations) to
    # its plain twin at Q = 64 and 1 and to the eager loop on the card;
    # timed at both beside that loop.  Its bound counts the query rows, the
    # adjacency rows (W wide) of the nodes expanded and each distinct valid
    # row a query scores once, read off a counting run of the eager loop;
    # operations 3 a coordinate (a difference and a fused multiply-add).
    vn, vdim, v_ef, v_b = 262_144, 128, 50, 16
    vrng = np.random.default_rng(SEED + 18)
    vcent = vrng.integers(0, 200, (1024, vdim))
    vx = np.clip(vcent[vrng.integers(0, 1024, vn)] + vrng.integers(-24, 25, (vn, vdim)),
                 0, 255).astype(np.float32)
    vq = np.clip(vx[vrng.integers(0, vn, nq)] + vrng.integers(-6, 7, (nq, vdim)),
                 0, 255).astype(np.float32)
    vidx = GraphIndex(vdim, metric='euclidean', max_degree=32, ef_search=v_ef,
                      beam_width=v_b, build_mode='device')
    vidx.add_with_ids(vx, np.arange(vn))
    vs = vidx._sync_device()
    vq_t = torch.from_numpy(vq).to(dev)
    vent = _sample_entries(vs.entry_vecs, vs.entry_ids, vq_t, True, 8)
    v_iters = bm._resolve_iters(None, v_ef, v_b)

    def vec_beam(nq_):
        return bm.beam_vec_kernel(vs.adj, vent[:nq_], vs.vectors, vq_t[:nq_], True, v_ef, v_ef,
                                  v_b, v_iters)

    def vec_beam_plain(nq_):
        return bm._beam_loop(vs.adj, vent[:nq_], v_ef, v_b, v_iters, v_ef,
                             bm.make_vector_scorer(vs.vectors, vq_t[:nq_], True))

    v_read = {}

    def vec_score_counted(ids, score):
        ok = (ids >= 0) & (ids < vn)
        q_of = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
        v_read['seen'][q_of[ok], ids[ok].long()] = True
        return score(ids)

    def vec_expand_counted(safe_sel, sel_valid, score):
        v_read['adj_rows'] += int(sel_valid.sum())
        nbrs = torch.where(sel_valid[:, :, None], vs.adj[safe_sel], -1)
        nbrs = nbrs.reshape(nbrs.shape[0], -1)
        return nbrs, vec_score_counted(nbrs, score)

    vec_checks = []
    for nq_ in (nq, 1):
        (vd_k, vi_k, vits), vcounts = drive(f'beam_vec q={nq_}', ['beam_vec'],
                                            lambda: vec_beam(nq_))
        if vcounts['beam_vec'] != 1:
            fail(f'beam_vec q={nq_}: {vcounts["beam_vec"]} launches')
        twin = bm._beam_vec_ref(vs.adj.cpu(), vent[:nq_].cpu(), vs.vectors.cpu(),
                                vq_t[:nq_].cpu(), True, v_ef, v_b, v_iters, v_ef)
        if not all(map(torch.equal, (vd_k.cpu(), vi_k.cpu(), vits.cpu()), twin)):
            fail(f'beam_vec q={nq_}: ids, distances or iterations differ from the plain twin')
        vscore = bm.make_vector_scorer(vs.vectors, vq_t[:nq_], True)
        v_read.update(adj_rows=0, seen=torch.zeros(nq_, vn, dtype=torch.bool, device=dev))
        counted = bm._beam_loop(vs.adj, vent[:nq_], v_ef, v_b, v_iters, v_ef,
                                lambda c: vec_score_counted(c, vscore),
                                lambda s_, v_: vec_expand_counted(s_, v_, vscore))
        if not all(map(torch.equal, (vd_k, vi_k), vec_beam_plain(nq_))) or \
                not all(map(torch.equal, (vd_k, vi_k), counted)):
            fail(f'beam_vec q={nq_}: ids or distances differ from the eager loop')
        err['beam_vec'] = max(err['beam_vec'], maxerr(vd_k, counted[0]))
        vec_checks.append(f'beam_vec on the {vn:,}-row graph q={nq_}: ids, distances and '
                          f'iterations bit-equal to the plain twin, ids and distances to the '
                          f'eager loop; {int(vits.max())} iterations at most')
        if nq_ == nq:
            rows = int(v_read.pop('seen').sum())
            vec_read = {**v_read, 'rows': rows,
                        'slots_of_expanded_rows': v_read['adj_rows'] * vs.adj.shape[1]}
            vec_its = {'max': int(vits.max()), 'mean': float(vits.float().mean())}
            bounds['beam_vec'] = bound(nq * vdim * 4 + rows * vdim * 4
                                       + v_read['adj_rows'] * vs.adj.shape[1] * 4
                                       + nq * v_ef * 8, 3.0 * rows * vdim,
                                       FP32_OPS_PER_S)
    times['beam_vec'] = (cuda_ms(lambda: vec_beam(nq)), cuda_ms(lambda: vec_beam_plain(nq), 5))
    vec_q1_ms = cuda_ms(lambda: vec_beam(1))
    vec_q1_plain_ms = cuda_ms(lambda: vec_beam_plain(1), 5)
    emit({'phase': 'beam_vec', 'n': vn, 'dim': vdim, 'ef': v_ef, 'beam_width': v_b,
          'w': vs.adj.shape[1], 'entry_width': 8, 'iters_budget': v_iters,
          'plan': bm.beam_vec_plan(v_ef, v_b, vs.adj.shape[1], vdim)._asdict(),
          'checks': vec_checks, 'rows_read_q64': vec_read, 'iterations_q64': vec_its,
          'dependent_global_reads': 1 + 2 * vec_its['max'],
          'ms': {'q64': times['beam_vec'][0], 'q1': vec_q1_ms},
          'eager_plain_ms': {'q64': times['beam_vec'][1], 'q1': vec_q1_plain_ms},
          'bound_ms_q64': bounds['beam_vec'][0], 'launches_per_search': 1})
    del vidx, vs, vq_t, vent, vx, vd_k, vi_k, vits, counted
    torch.cuda.empty_cache()
    beam_vec_filtered(bm, GraphIndex, _sample_entries, cuda_ms, drive, nq)
    times['masked_scan'], bounds['masked_scan'], err['masked_scan'] = masked_scan_phase(
        msc, tracer, cuda_ms, drive, nq)

    # ---------------- 12. the facade with the graph index ----------------
    # the first 20,000 of phase 7's docs, without a codec and with PQ64 at
    # rerank 0 (table traversal through the facade: K8)
    nfg = 20_000

    def facade_graph_path(kind, data_dir, kw):
        shutil.rmtree(data_dir, ignore_errors=True)
        cfg = dict(n_dim=df, metric='euclidean', index_type='graph',
                   columns=[('price', float)], data_path=data_dir, **kw)
        ann = AnnLite(**cfg)
        if ann._requires_training:
            ann.train(xf[:10240])
        t = time.perf_counter()
        ann.index([Doc(id=str(i), embedding=xf[i], tags={'price': float(prices[i])})
                   for i in range(nfg)])
        ingest = time.perf_counter() - t
        _, ids = ann.search_numpy(qf_np[:16], limit=10)
        hits1 = sum(ids[i][0] == str(i) for i in range(16))
        hits10 = sum(str(i) in ids[i] for i in range(16))
        if kind == 'vectors' and hits1 != 16:
            fail(f'facade_graph {kind}: self-hits {hits1}/16')
        flt = {'price': {'$lt': 50.0}}
        for matches in ann.search_by_vectors(qf_np[:8], filter=flt, limit=10,
                                             include_metadata=True):
            if not matches or any(m.tags['price'] >= 50.0 for m in matches):
                fail(f'facade_graph {kind}: filtered search returned a doc outside the filter')
        upd = np.arange(1000, 1100)
        ann.update([Doc(id=str(i), embedding=xf[i] + 0.5,
                        tags={'price': float(prices[i])}) for i in upd])
        _, ids = ann.search_numpy(xf[upd[:16]] + 0.5, limit=1)
        upd_hits = sum(row[0] == str(i) for row, i in zip(ids, upd[:16]))
        if kind == 'vectors' and upd_hits != 16:
            fail(f'facade_graph {kind}: updated docs do not find themselves')
        gone = [str(i) for i in range(2000, 2100)]
        ann.delete(gone)
        _, ids = ann.search_numpy(xf[2000:2100], limit=10)
        serve = ann.serving_searcher(limit=10)
        _, sids = serve(xf[2000:2064])
        if set(gone) & {i for row in ids + sids for i in row}:
            fail(f'facade_graph {kind}: a deleted doc was returned')
        integrity = ann.check_integrity()
        if not integrity['ok']:
            fail(f'facade_graph {kind}: check_integrity {integrity}')
        d_np, ids_np = ann.search_numpy(qf_np, limit=10)
        _, ids_sv = serve(qf_np)
        if ids_sv != ids_np:
            fail(f'facade_graph {kind}: serving_searcher ids differ from search_numpy')
        search_ms = host_ms(lambda: ann.search_numpy(qf_np, limit=10), reps=10)
        serve_ms = host_ms(lambda: serve(qf_np), reps=10)
        ann.dump()
        ann.close()
        ann = AnnLite(**cfg)
        d_re, ids_re = ann.search_numpy(qf_np, limit=10)
        if ids_re != ids_np or not all(np.array_equal(a, b) for a, b in zip(d_re, d_np)):
            fail(f'facade_graph {kind}: results differ after dump and reopen')
        ann.close()
        shutil.rmtree(data_dir, ignore_errors=True)
        return {'ingest_docs_per_s': nfg / ingest, 'self_hits_at_1_of_16': hits1,
                'self_hits_at_10_of_16': hits10, 'updated_found_of_16': upd_hits,
                'reachable_fraction': integrity['reachable_fraction'],
                'search_numpy_ms_batch64': search_ms, 'serving_ms_batch64': serve_ms}

    facade_graph = {}
    for kind, kw, expected in (('vectors', {}, ['beam_vec']),
                               ('pq_rerank0', dict(n_subvectors=64, rerank=0),
                                ['beam_pq'])):
        out, counts = drive(f'facade_graph {kind}', expected, lambda: facade_graph_path(
            kind, ROOT / 'build' / f'chip_smoke_graph_{kind}', kw))
        facade_graph[kind] = dict(out, launches=counts)
    emit({'phase': 'facade_graph', 'docs': nfg, 'dim': df, 'metric': 'euclidean',
          'filtered_ok': True, 'deleted_never_returned': True, 'integrity_ok': True,
          'serving_equals_search_numpy': True, 'reopen_equal': True, **facade_graph})

    # ---------------- 13. the facade with the OPQ and projector codecs ----------------
    # (a) phase 7's 100,000 x 128 euclidean docs with PQ64 and a learned OPQ
    # rotation (trained once on 10,240 docs): the PQ scan (K4 + lane8_merge),
    # then a device-built graph traversed with the rotated queries' tables
    # (beam_pq), rerank 100 both; (b) phase 6's 65,536 x 256 cosine docs
    # projected to 128 dimensions by PCA, flat int8 (K1 + lane8_merge + K3:
    # the projected rows have D = 128, which the fused scan takes)
    def doc_rows(ids):
        return np.array([[int(i) for i in row] for row in ids])

    def facade_codecs_path(kind, data_dir, cfg, nd, xd, queries, gt, model_from=None):
        shutil.rmtree(data_dir, ignore_errors=True)
        if model_from is not None:  # reuse the trained codecs of an earlier run
            shutil.copytree(model_from, data_dir / model_from.name)
        ann = AnnLite(data_path=data_dir, **cfg)
        train_s = None
        if not ann.is_trained:
            t = time.perf_counter()
            ann.train(xd[:10240])
            train_s = time.perf_counter() - t
        if kind == 'opq_graph':
            # the facade exposes no traversal knob: score with the OPQ tables
            ann._container.index.traverse = 'pq'
        t = time.perf_counter()
        for lo in range(0, nd, 16384):
            ann.index([Doc(id=str(i), embedding=xd[i]) for i in range(lo, min(lo + 16384, nd))])
        ingest = time.perf_counter() - t
        _, ids = ann.search_numpy(queries, limit=10)
        rec = None if gt is None else recall_at_10(doc_rows(ids), gt)
        lat = {f'search_numpy_ms_batch{b}': host_ms(
            lambda: ann.search_numpy(queries[:b], limit=10), reps=10) for b in (nq, 1)}
        out = {'train_s': train_s, 'ingest_docs_per_s': nd / ingest, 'recall_at_10': rec,
               **lat}
        if kind == 'opq_graph':
            out['integrity'] = ann.check_integrity()
            out['traverse'] = ann._container.index.traverse
        if kind == 'projector_flat':
            serve = ann.serving_searcher(limit=10)
            if serve(queries)[1] != ids:
                fail('facade_codecs projector: serving_searcher ids differ from search_numpy')
        codecs = (ann.model_path, ann._projector_codec, ann._pq_codec)
        ann.close()
        return out, ids, codecs

    xfd = torch.from_numpy(xf).to(dev)
    qfd = torch.from_numpy(qf_np).to(dev)
    fgt = torch.sort(torch.sum(xfd * xfd, dim=1)[None, :] - 2.0 * (qfd @ xfd.T), dim=1,
                     stable=True).indices[:, :10].cpu().numpy()
    del xfd, qfd
    codec_cfg = dict(n_dim=df, metric='euclidean', n_subvectors=64, use_opq=True, rerank=100)
    codecs_out = {}
    (sout, _, (opq_model, _, opq_codec)), scounts = drive(
        'facade_codecs opq_scan', ['adc_block_top2', 'lane8_merge'], lambda: facade_codecs_path(
            'opq_scan', ROOT / 'build' / 'chip_smoke_opq_scan', codec_cfg, nf, xf, qf_np, fgt))
    codecs_out['opq_scan'] = dict(sout, launches=scounts)
    opq_trace = list(opq_codec.fit_trace)
    (gout, _, _), gcounts = drive(
        'facade_codecs opq_graph', ['beam_pq'], lambda: facade_codecs_path(
            'opq_graph', ROOT / 'build' / 'chip_smoke_opq_graph',
            dict(codec_cfg, index_type='graph', graph_build_mode='device'), nf, xf, qf_np, fgt,
            model_from=opq_model))
    codecs_out['opq_graph'] = dict(gout, launches=gcounts)
    # the rotation against plain PQ on the same training sample
    plain = PQCodec(df, n_subvectors=64, n_clusters=256, metric='euclidean')
    plain.fit(xf[:10240])
    opq_mse = float(np.mean((opq_codec.decode(opq_codec.encode(xf[:10240])) - xf[:10240]) ** 2))
    pq_mse = float(np.mean((plain.decode(plain.encode(xf[:10240])) - xf[:10240]) ** 2))
    del plain
    rec_scan = codecs_out['opq_scan']['recall_at_10']
    rec_graph = codecs_out['opq_graph']['recall_at_10']
    if rec_scan < 0.99 or rec_graph < 0.90:
        fail(f'facade_codecs: OPQ recall@10 {rec_scan} (scan, >= 0.99) or {rec_graph} '
             '(graph, >= 0.90)')
    if not opq_mse < pq_mse:
        fail(f'facade_codecs: OPQ training MSE {opq_mse} is not below plain PQ\'s {pq_mse}')
    # (b): ground truth by float32 brute force in the projected space (the
    # flat index's cosine over projected rows), and in the input space
    xsm = np.random.default_rng(SEED).standard_normal((nsm, dsm), dtype=np.float32)
    proj_cfg = dict(n_dim=dsm, metric='cosine', n_components=128)
    (pout, pids, (_, proj, _)), pcounts = drive(
        'facade_codecs projector_flat', ['block_top2', 'lane8_merge', 'gather_rerank'],
        lambda: facade_codecs_path('projector_flat', ROOT / 'build' / 'chip_smoke_projector',
                                   proj_cfg, nsm, xsm, xsm[:nq], None))

    def cos_gt(rows, queries):
        r = l2_normalize(torch.from_numpy(rows).to(dev))
        q = l2_normalize(torch.from_numpy(queries).to(dev))
        return torch.sort(-(q @ r.T), dim=1, stable=True).indices[:, :10].cpu().numpy()

    got = doc_rows(pids)
    pout['recall_at_10'] = recall_at_10(got, cos_gt(proj.encode(xsm), proj.encode(xsm[:nq])))
    pout['recall_at_10_vs_unprojected'] = recall_at_10(got, cos_gt(xsm, xsm[:nq]))
    pout['explained_variance_ratio'] = float(np.sum(proj.explained_variance_ratio))
    # the card's fit (float32 moments, CUDA eigh, sign rule) against a float64
    # numpy PCA of the same 10,240 training rows: the 16 leading components
    # to |cosine| > 0.999, every component's variance ratio to 1e-4
    xs64 = xsm[:10240].astype(np.float64)
    ref_val, ref_vec = np.linalg.eigh(np.cov(xs64, rowvar=False))
    ref_ratio = ref_val[::-1][:128] / np.sum(np.clip(ref_val, 0.0, None))
    ref_comp = ref_vec[:, ::-1][:, :16].T
    cos16 = np.abs(np.sum(proj.components[:16].astype(np.float64) * ref_comp, axis=1)) / (
        np.linalg.norm(proj.components[:16], axis=1) * np.linalg.norm(ref_comp, axis=1))
    ratio_err = float(np.max(np.abs(proj.explained_variance_ratio - ref_ratio)))
    pout['vs_float64_pca'] = {'min_abs_cos_16_leading': float(cos16.min()),
                              'max_variance_ratio_err': ratio_err}
    del xs64
    codecs_out['projector_flat'] = dict(pout, launches=pcounts)
    if pout['recall_at_10'] < 0.995:
        fail(f'facade_codecs: projector flat recall@10 {pout["recall_at_10"]} against the '
             'projected brute force is below 0.995')
    if cos16.min() <= 0.999 or ratio_err > 1e-4:
        fail(f'facade_codecs: the projector differs from a float64 PCA of its training rows: '
             f'min |cos| {cos16.min()} of the 16 leading components (> 0.999), variance '
             f'ratio error {ratio_err} (<= 1e-4)')
    for name in ('opq_scan', 'opq_graph', 'projector'):
        shutil.rmtree(ROOT / 'build' / f'chip_smoke_{name}', ignore_errors=True)
    emit({'phase': 'facade_codecs', 'opq': {'docs': nf, 'dim': df, 'metric': 'euclidean',
                                            'n_subvectors': 64, 'fit_trace': opq_trace,
                                            'train_mse': opq_mse, 'plain_pq_train_mse': pq_mse},
          'projector': {'docs': nsm, 'dim': dsm, 'n_components': 128, 'metric': 'cosine'},
          **codecs_out})
    del xsm, proj, opq_codec

    # ---------------- 14. the serving layer ----------------
    # deploy/config.yml's executor (n_dim 128, cosine, index_type auto = flat
    # int8, rerank 0, shard 0 of 1, a workspace under build/) with a price
    # column, over phase 7's 100,000 docs: ingest through the write buffer,
    # search, micro-batched search, writes, a backup to an artifact server on
    # loopback restored into fresh executors, then the HTTP and gRPC front
    # ends where their packages are installed (looked up before anything runs)
    import asyncio
    import importlib.util
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from annlite_torch.artifacts import Uploader, make_transport
    from annlite_torch.serving import AnnLiteIndexer
    from annlite_torch.serving.artifact_server import ArtifactServer
    from annlite_torch.serving.batcher import QueryBatcher

    serve_root = ROOT / 'build' / 'chip_smoke_serving'
    shutil.rmtree(serve_root, ignore_errors=True)
    serving_cfg = dict(n_dim=df, metric='cosine', index_type='auto', rerank=0,
                       shard_id=0, shards=1, columns=[('price', float)])
    split_mb = 16  # the archive's docs.db (~60 MB) then goes up in parts
    front_ends = {phase: (pkg, importlib.util.find_spec(pkg) is not None)
                  for phase, pkg in (('serving_http', 'aiohttp'), ('serving_grpc', 'grpc'))}
    for phase, (pkg, found) in front_ends.items():
        if not found:
            emit({'phase': phase, 'run': False, 'reason': f'{pkg} not installed'})

    def qdocs(rows, offset=0.0):
        """Fresh query docs (a search writes its matches into them)."""
        return [Doc(id=f'q{i}', embedding=xf[i] + offset) for i in rows]

    def match_ids(docs):
        return [[m.id for m in d.matches] for d in docs]

    def match_scores(docs):
        return [[m.score for m in d.matches] for d in docs]

    def search_profile(ex):
        """The device time of one executor search at batch 64 (metadata
        included), by ``torch.profiler``: all kernels, and each of the
        three on the path (a measurement aid: a profiler that cannot trace
        fails no check)."""
        docs = qdocs(range(nq))
        ex.search(qdocs(range(nq)), {'limit': 10})
        torch.cuda.synchronize()
        try:
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                ex.search(docs, {'limit': 10})
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            kern = device_events(prof)
            busy = sum(e.self_device_time_total for e in kern) / 1e3
            return {
                'wall_ms_profiled': wall_ms, 'device_busy_ms': busy,
                'device_idle_share': 1.0 - busy / wall_ms,
                'kernel_launches': sum(e.count for e in kern),
                'kernel_device_ms': {
                    sym: sum(e.self_device_time_total for e in kern if sym in e.key) / 1e3
                    for sym in ('block_top2_kernel', 'split_merge_kernel',
                                'lane8_merge_kernel', 'gather_rerank_kernel')},
                'top_device_ms': sorted(((e.key[:80], e.count, e.self_device_time_total / 1e3)
                                         for e in kern), key=lambda r: -r[2])[:8]}
        except Exception as e:  # noqa: BLE001
            return {'error': repr(e)}

    def serving_path():
        out = {}
        ex = AnnLiteIndexer(workspace=str(serve_root / 'ws'), **serving_cfg)
        live = [ex]
        srv = None
        try:
            if ex._index.device.type != 'cuda':
                fail(f'serving: the executor serves from {ex._index.device}')
            # 1. ingest, requests of 1,000 docs through the write buffer
            t = time.perf_counter()
            for lo in range(0, nf, 1000):
                ex.index([Doc(id=str(i), embedding=xf[i], tags={'price': float(prices[i])})
                          for i in range(lo, lo + 1000)])
            ex.flush()
            out['serving_ingest_docs_per_s'] = nf / (time.perf_counter() - t)
            st = ex.status()
            if (st['total_docs'], st['buffer_size'], st['quarantined_docs']) != (nf, 0, 0):
                fail(f'serving: status after ingest {st}')
            # 2. search: 64 queries at limit 10
            before = launch_counts()
            res = ex.search(qdocs(range(nq)), {'limit': 10})
            out['launches_per_search'] = {k: v - before[k] for k, v in launch_counts().items()
                                          if v != before[k]}
            ids64 = match_ids(res)
            if ids64 != ex._index.search_numpy(qf_np, limit=10)[1]:
                fail('serving: executor search ids differ from AnnLite.search_numpy')
            if [r[0] for r in ids64[:16]] != [str(i) for i in range(16)]:
                fail('serving: a doc does not find itself first')
            out['recall_at_10'] = recall_at_10(doc_rows(ids64), cos_gt(xf, qf_np))
            if out['recall_at_10'] < 0.995:
                fail(f'serving: recall@10 {out["recall_at_10"]} is below 0.995')
            fres = ex.search(qdocs(range(16)), {'limit': 10, 'filter': {'price': {'$lt': 50.0}}})
            if any(not d.matches or any(m.tags['price'] >= 50.0 for m in d.matches)
                   for d in fres):
                fail('serving: the filtered search returned a doc outside the filter')
            # the executor's search, then the same without the matches' doc
            # store reads, then the facade's search_numpy under it
            out['search_ms_batch64'] = host_ms(
                lambda: ex.search(qdocs(range(nq)), {'limit': 10}), reps=10)
            out['search_ms_batch64_no_metadata'] = host_ms(
                lambda: ex.search(qdocs(range(nq)), {'limit': 10, 'include_metadata': False}),
                reps=10)
            out['search_numpy_ms_batch64'] = host_ms(
                lambda: ex._index.search_numpy(qf_np, limit=10), reps=10)
            out['search_ms_batch1'] = host_ms(
                lambda: ex.search(qdocs([0]), {'limit': 10}), reps=10)
            out['search_batch64_profile'] = search_profile(ex)

            # 3. micro-batching: 64 single-query requests at once on one loop
            async def batched():
                b = QueryBatcher(ex.search)
                try:
                    t = time.perf_counter()
                    got = await asyncio.gather(*(b.submit(qdocs([i]), {'limit': 10})
                                                 for i in range(nq)))
                    return got, time.perf_counter() - t, b.n_dispatches
                finally:
                    await b.close()

            got, wall, n_disp = asyncio.run(batched())
            if [match_ids(g)[0] for g in got] != ids64:
                fail('serving: a micro-batched result differs from its row of the batch')
            if n_disp >= nq:
                fail(f'serving: {n_disp} dispatches for {nq} requests')
            t = time.perf_counter()
            one = [match_ids(ex.search(qdocs([i]), {'limit': 10}))[0] for i in range(nq)]
            out['microbatch'] = {'n_dispatches': n_disp, 'wall_ms_batched': wall * 1e3,
                                 'wall_ms_one_by_one': (time.perf_counter() - t) * 1e3}
            if one != ids64:
                fail('serving: a single-query search differs from its row of the batch')
            # 4. writes
            upd = range(1000, 1100)
            ex.update([Doc(id=str(i), embedding=xf[i] + 0.5, tags={'price': float(prices[i])})
                       for i in upd])
            if [r[0] for r in match_ids(ex.search(qdocs(upd, 0.5), {'limit': 10}))] != [
                    str(i) for i in upd]:
                fail('serving: an updated doc does not find itself first')
            gone = [str(i) for i in range(2000, 2100)]
            ex.delete({'ids': gone})
            found = match_ids(ex.search(qdocs(range(2000, 2100)), {'limit': 10}))
            if set(gone) & {i for row in found for i in row}:
                fail('serving: a search returned a deleted doc')
            filled = ex.fill_embedding([Doc(id='5'), Doc(id='1000')])
            if (filled[0].embedding.tobytes() != xf[5].tobytes()
                    or filled[1].embedding.tobytes() != (xf[1000] + 0.5).tobytes()):
                fail('serving: fill_embedding differs from the stored vectors')
            res_w = ex.search(qdocs(range(nq)), {'limit': 10})
            # 5. backup to an artifact server and restore into fresh executors
            srv = ArtifactServer(serve_root / 'artifacts', port=0).start()
            t = time.perf_counter()
            path = Path(ex.backup({'target_name': 'serving', 'remote': srv.url}))
            out['backup_s'] = time.perf_counter() - t
            transport = make_transport(srv.url)
            t = time.perf_counter()
            Uploader(transport, size_limit_mb=split_mb).upload_directory(
                'serving_split_shard_0', path)
            out['split_upload_s'] = time.perf_counter() - t
            parts = [a['part'] for a in transport.list('serving_split_shard_0')
                     if a['file_name'] == 'docs.db']
            if len(parts) < 2 or None in parts:
                fail(f'serving: docs.db was not split at {split_mb} MB: {parts}')
            out['archive_bytes'] = {
                name: sum(f.stat().st_size for f in (serve_root / 'artifacts' / name).iterdir()
                          if not f.name.endswith('.meta.json'))
                for name in ('serving_shard_0', 'serving_split_shard_0')}
            out['docs_db_parts'] = len(parts)
            restored = {}
            for name in ('serving', 'serving_split'):
                rx = AnnLiteIndexer(workspace=str(serve_root / f'ws_{name}'), **serving_cfg)
                live.append(rx)
                t = time.perf_counter()
                rx.restore({'source_name': name, 'remote': srv.url})
                out[f'restore_s_{name}'] = time.perf_counter() - t
                if rx.status()['total_docs'] != ex.status()['total_docs']:
                    fail(f'serving: restore {name}: {rx.status()["total_docs"]} docs')
                if rx._index._container.index.device.type != 'cuda':
                    fail(f'serving: restore {name} left the index off the card')
                rr = rx.search(qdocs(range(nq)), {'limit': 10})
                if match_ids(rr) != match_ids(res_w) or match_scores(rr) != match_scores(res_w):
                    fail(f'serving: restore {name}: top-10 ids or distances differ')
                restored[name] = rx
            # 6. the front ends, each over a restored executor (stopping a
            # server closes its executor)
            ref = match_ids(res_w)

            def same_ids(replies, what):
                for i, rep in enumerate(replies):
                    if [m['id'] for m in rep['results'][0]['matches']] != ref[i]:
                        fail(f'serving: {what} request {i} differs from its row of the batch')

            if front_ends['serving_http'][1]:
                from annlite_torch.serving import Server

                rx = restored['serving']
                live.remove(rx)
                server = Server(rx, port=0).start()
                try:
                    base = f'http://127.0.0.1:{server.port}'

                    def post(i):
                        body = json.dumps({'docs': [{'id': f'q{i}', 'embedding': xf[i].tolist()}],
                                           'parameters': {'limit': 10}}).encode()
                        req = urllib.request.Request(
                            base + '/search', data=body,
                            headers={'Content-Type': 'application/json'})
                        with urllib.request.urlopen(req, timeout=60) as r:
                            return json.loads(r.read())

                    t = time.perf_counter()
                    with ThreadPoolExecutor(nq) as pool:
                        replies = list(pool.map(post, range(nq)))
                    wall = time.perf_counter() - t
                    same_ids(replies, 'HTTP')
                    with urllib.request.urlopen(base + '/status', timeout=60) as r:
                        st = json.loads(r.read())
                    if st['total_docs'] != nf - len(gone):
                        fail(f'serving: HTTP /status reports {st["total_docs"]} docs')
                    out['http'] = {'wall_ms_64_concurrent': wall * 1e3, 'batcher': st['batcher']}
                finally:
                    server.stop()
            if front_ends['serving_grpc'][1]:
                from annlite_torch.serving import GrpcClient, GrpcServer

                rx = restored['serving_split']
                live.remove(rx)
                server = GrpcServer(rx, port=0).start()
                client = GrpcClient(server.address)
                try:
                    t = time.perf_counter()
                    with ThreadPoolExecutor(nq) as pool:
                        replies = list(pool.map(
                            lambda i: client.search(qdocs([i]), {'limit': 10}), range(nq)))
                    wall = time.perf_counter() - t
                    same_ids(replies, 'gRPC')
                    if client.status()['total_docs'] != nf - len(gone):
                        fail('serving: gRPC Status reports the wrong doc count')
                    out['grpc'] = {'wall_ms_64_concurrent': wall * 1e3}
                finally:
                    client.close()
                    server.stop()
        finally:
            if srv is not None:
                srv.stop()
            for e in live:
                e.close()
        return out

    t_serving = time.perf_counter()
    sout, serving_counts = drive(
        'serving', ['block_top2', 'lane8_merge', 'gather_rerank'], serving_path)
    shutil.rmtree(serve_root, ignore_errors=True)
    emit({'phase': 'serving', 'docs': nf, 'dim': df, 'metric': 'cosine', 'index_type': 'auto',
          'rerank': 0, 'front_ends_found': {p: f for p, (_, f) in front_ends.items()},
          'split_limit_mb': split_mb, 'phase_s': time.perf_counter() - t_serving, **sout,
          'launches': serving_counts})

    # ---------------- 15. the sharded indexes ----------------
    # make_mesh(4, 'cuda'): 4 shards on the one card, each running the port's
    # single-device step (its kernels once per shard), merged on the card.
    # The data of earlier phases: the flat phase's 2^20 x 768 cosine rows,
    # the pq_scan phase's 2^20 x 128 rows with its PQ64 codec and IVF cells,
    # the graph phase's 131,072 x 128 rows and PQ64 codec, the facade's docs
    import socket

    import torch.distributed as tdist

    from annlite_torch.codecs.kmeans import _lloyd_step
    from annlite_torch.ops import BIG
    from annlite_torch.ops.topk import topk as stable_topk
    from annlite_torch.parallel import (ShardedFlatIndex, ShardedGraphIndex,
                                        ShardedIVFPQIndex, ShardedPQIndex, make_mesh,
                                        shard_rows, sharded_lloyd_step)
    from annlite_torch.parallel import distributed as pdist

    t_sharded = time.perf_counter()
    n_sh = 4
    mesh4 = make_mesh(n_sh, device='cuda')
    if mesh4.devices != (torch.device('cuda', 0),) * n_sh:
        fail(f'sharded: make_mesh(4, "cuda") gave {mesh4}')
    sh = {'shards': n_sh, 'mesh': [str(dv) for dv in mesh4.devices]}

    def per_search(tag, counts, want):
        """Each kernel of ``want`` launched once per shard and search."""
        for name, n_calls in want.items():
            if counts[name] != n_sh * n_calls:
                fail(f'sharded {tag}: {counts[name]} {name} launches in {n_calls} '
                     f'searches over {n_sh} shards')

    # (a) flat: 262,144 rows a shard, so each shard takes K1's lane8 select
    qnp = queries.cpu().numpy()
    t0 = time.perf_counter()
    sflat = ShardedFlatIndex(d, metric='cosine', mesh=mesh4)
    sflat.add_with_ids(xn, np.arange(n))
    sflat._sync()
    torch.cuda.synchronize()
    sflat_ingest_s = time.perf_counter() - t0
    mask5 = masks[0.05]
    res, counts = drive('sharded flat', ['block_top2', 'lane8_merge', 'gather_rerank'],
                        lambda: {'b64': sflat.search(qnp, 10), 'b1': sflat.search(qnp[:1], 10),
                                 'mask5': sflat.search(qnp, 10, mask=mask5)})
    per_search('flat', counts, {'block_top2': 3, 'lane8_merge': 3, 'gather_rerank': 3})
    (d64, i64), (d1, i1) = res['b64'], res['b1']
    recall = float(np.mean([len(set(a) & set(b)) / 10
                            for a, b in zip(i64.tolist(), exact_top10)]))
    if recall < 0.995:
        fail(f'sharded flat recall@10 {recall} < 0.995')
    # each returned distance against the float32 distance of its row, within
    # K3's stated tolerance (rtol 1e-5, atol 1e-5 * (|q|^2 + |x|^2))
    qn = l2_normalize(queries)
    rows = torch.from_numpy(sflat._vectors[i64]).to(dev)  # normalized at insert
    ref = 1.0 - torch.sum(qn[:, None, :] * rows, dim=-1)
    got = torch.from_numpy(d64).to(dev)
    tol = 1e-5 * ref.abs() + 1e-5 * (torch.sum(qn * qn, dim=1)[:, None]
                                     + torch.sum(rows * rows, dim=-1))
    flat_err = (got - ref).abs().max().item()
    if not bool(((got - ref).abs() <= tol).all()):
        fail(f'sharded flat: a distance outside K3\'s tolerance of its row\'s ({flat_err})')
    if not mask5[res['mask5'][1]].all():
        fail('sharded flat mask 5%: a returned row lies outside the mask')
    if not (np.array_equal(i1[0], i64[0]) and np.allclose(d1[0], d64[0], rtol=1e-6, atol=0)):
        fail('sharded flat batch 1: result differs from row 0 of batch 64')
    fl = kept.pop('flat')
    sh['flat'] = {
        'n': n, 'dim': d, 'rows_per_shard': n // n_sh, 'host_ingest_s': sflat_ingest_s,
        'recall_at_10_vs_fp32': recall, 'max_abs_err_vs_fp32_distance': flat_err,
        'masked_rows_in_mask': True, 'batch1_equals_batch64_row0': True,
        'launches_3_searches': counts,
        'search_ms': {'sharded_batch64': host_ms(lambda: sflat.search(qnp, 10), reps=10),
                      'flat_index_batch64': host_ms(lambda: fl.search(qnp, 10), reps=10),
                      'sharded_batch1': host_ms(lambda: sflat.search(qnp[:1], 10), reps=10),
                      'flat_index_batch1': host_ms(lambda: fl.search(qnp[:1], 10), reps=10)},
        # the device's busy and idle time in one search of each index
        'profile_batch64': {'sharded': profile(lambda qq: sflat.search(qq, 10), qnp),
                            'flat_index': profile(lambda qq: fl.search(qq, 10), qnp)}}
    del sflat, fl, rows, ref, got, tol
    torch.cuda.empty_cache()

    # (b) PQ: bit-equal to K5 over the whole corpus on one device and a
    # stable top-k (a row's ADC sum does not depend on its shard; the
    # shard-ordered stable merge keeps the lower row on ties)
    spq = ShardedPQIndex(d2, pq, mesh=mesh4)
    spq.add_with_ids(xs, np.arange(n2), codes=codes)
    res, counts = drive('sharded pq', ['adc_scores'],
                        lambda: {'b64': spq.search(qv, 10), 'b1': spq.search(qv[:1], 10)})
    per_search('pq', counts, {'adc_scores': 2})
    codes_full = torch.from_numpy(np.ascontiguousarray(codes.T)).to(dev)
    dt_q = pq.dist_mat(qv).to(dev)
    ref_d, ref_i = stable_topk(ad.adc_scores(dt_q, codes_full), 10)
    for tag, (dd, ii) in res.items():
        want_d, want_i = ref_d[: len(dd)].cpu().numpy(), ref_i[: len(dd)].cpu().numpy()
        if not (np.array_equal(dd, want_d) and np.array_equal(ii, want_i)):
            fail(f'sharded pq {tag}: not bit-equal to K5 over the corpus on one device')
    pq_sharded = res['b64']
    sh['pq'] = {'n': n2, 'm': 64, 'k': 256, 'bit_equal_single_device_k5': True,
                'recall_at_10_vs_fp32': recall_at_10(res['b64'][1], gt),
                'launches_2_searches': counts,
                'search_ms': {'batch64': host_ms(lambda: spq.search(qv, 10), reps=10),
                              'batch1': host_ms(lambda: spq.search(qv[:1], 10), reps=10)},
                'profile_batch64': profile(lambda qq: spq.search(qq, 10), qv)}
    del spq, dt_q, ref_d, ref_i
    torch.cuda.empty_cache()

    # (c) IVF-PQ: 1024 cells, rerank 100; batch 8 at probe 8 (each shard's
    # padded list of its probed blocks reaches 16: K6) and batch 1 at probe 1
    # (K7)
    t0 = time.perf_counter()
    sivf = ShardedIVFPQIndex(d2, pq, rerank=100, mesh=mesh4)
    sivf.add_with_ids(xs, np.arange(n2), cells=cells, codes=codes)
    sivf_build_s = time.perf_counter() - t0
    s_max8 = [sivf._sel_local(sivf._store.select_blocks(np.unique(p8[lo:lo + 8]))).shape[1]
              for lo in range(0, nq, 8)]
    s_max1 = sivf._sel_local(sivf._store.select_blocks(np.unique(p1))).shape[1]
    b8, counts8 = drive('sharded ivf_pq probe 8', ['ivf_block_top2', 'lane8_merge'], lambda: [
        sivf.search(qv2[lo:lo + 8], 10, cells=p8[lo:lo + 8]) for lo in range(0, nq, 8)])
    per_search('ivf_pq probe 8', counts8, {'ivf_block_top2': nq // 8, 'lane8_merge': nq // 8})
    b1, counts1 = drive('sharded ivf_pq probe 1', ['ivf_scores'],
                        lambda: sivf.search(qv2[:1], 10, cells=p1))
    per_search('ivf_pq probe 1', counts1, {'ivf_scores': 1})
    # held to a single-device IVFPQIndex(rerank=100) of the same rows, cells,
    # codes and bf16 rerank rows, searched once per shard with that shard's
    # rows as the mask, the four answers merged in shard order by a stable
    # sort: each shard reranks its own 100 best, so the one unmasked search
    # (100 over all shards) is not the same function
    ivf = IVFPQIndex(d2, pq, rerank=100)
    ivf.add_with_ids(xs, np.arange(n2), cells=cells, codes=codes)
    bps = sivf._blocks_per_shard()
    shard_masks = []
    for s_ in range(n_sh):
        rm_s = ivf._store.row_map[s_ * bps:(s_ + 1) * bps]
        m_s = np.zeros(n2, bool)
        m_s[rm_s[rm_s >= 0]] = True
        shard_masks.append(m_s)

    def ivf_by_shard(q_np, probe):
        parts = [ivf.search(q_np, 10, cells=probe, mask=m_s) for m_s in shard_masks]
        d_all = torch.from_numpy(np.concatenate([pd for pd, _ in parts], axis=1))
        i_all = torch.from_numpy(np.concatenate(
            [np.where(pd < BIG / 2, pi, -1) for pd, pi in parts], axis=1))
        d_r, pos = stable_topk(d_all, 10)
        return d_r.numpy(), torch.gather(i_all, 1, pos).numpy()

    ivf_ref_err, ivf_ref_ids_differing = 0.0, 0
    for tag, got, (want_d, want_i) in (
            [(f'probe 8 batch {lo // 8}', b8[lo // 8],
              ivf_by_shard(qv2[lo:lo + 8], p8[lo:lo + 8])) for lo in range(0, nq, 8)]
            + [('probe 1', b1, ivf_by_shard(qv2[:1], p1))]):
        gd, gi = got
        ivf_ref_err = max(ivf_ref_err, float(np.abs(gd - want_d).max()))
        if not np.allclose(gd, want_d, rtol=1e-5, atol=0):
            fail(f'sharded ivf_pq {tag}: distances differ from the single-device index')
        # ids equal wherever the neighbouring distances differ (rtol 1e-5)
        pad = np.concatenate([np.full((len(want_d), 1), -np.inf), want_d,
                              np.full((len(want_d), 1), np.inf)], axis=1)
        gap = 1e-5 * np.abs(pad[:, 1:-1])
        apart = (pad[:, 1:-1] - pad[:, :-2] > gap) & (pad[:, 2:] - pad[:, 1:-1] > gap)
        if (gi[apart] != want_i[apart]).any():
            fail(f'sharded ivf_pq {tag}: ids differ from the single-device index')
        ivf_ref_ids_differing += int((gi != want_i).sum())
    i8 = np.concatenate([b[1] for b in b8])
    ivf_recall = recall_at_10(i8, gt2)
    if ivf_recall < 0.98:
        fail(f'sharded ivf_pq probe-8 recall@10 {ivf_recall} < 0.98')
    if not np.isin(cells[b1[1][0]], p1[0]).all():
        fail('sharded ivf_pq probe 1: a returned row lies outside the probed cell')
    sh['ivf_pq'] = {
        'cells': 1024, 'rerank': 100, 'build_s': sivf_build_s,
        'blocks_per_shard': sivf._blocks_per_shard(),
        'probe8_selections_per_shard': s_max8, 'probe1_selections_per_shard': s_max1,
        'recall_at_10_vs_fp32_probe8': ivf_recall,
        'vs_single_device_per_shard_masks': {
            'max_abs_err': ivf_ref_err, 'ids_differing_inside_ties': ivf_ref_ids_differing,
            'tolerance': 'distances rtol 1e-5; ids equal where neighbours differ by more'},
        'launches_per_search_per_shard': {
            'probe8_batch8': {k: v / (nq // 8) / n_sh for k, v in counts8.items() if v},
            'probe1_batch1': {k: v / n_sh for k, v in counts1.items() if v}},
        'search_ms': {
            'probe8_batch8': host_ms(lambda: sivf.search(qv2[:8], 10, cells=p8[:8]), reps=10),
            'probe1_batch1': host_ms(lambda: sivf.search(qv2[:1], 10, cells=p1), reps=10)},
        'profile_probe8_batch8': profile(lambda qq: sivf.search(qq, 10, cells=p8[:8]), qv2[:8])}
    del sivf, b8, b1, ivf
    torch.cuda.empty_cache()

    # (d) graph: 32,768 rows a shard, the device Vamana build per shard at
    # the graph phase's settings, then searching indexes of beam width 8
    # loading its W-wide sub-graphs: vector traversal, and PQ64 at rerank 0
    # (beam_pq once per shard)
    skw = dict(metric='euclidean', mesh=mesh4, max_degree=32, l_build=64, ef_search=128,
               n_entry_samples=4096, entry_width=8, build_mode='device')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sgb = ShardedGraphIndex(d2, beam_width=16, **skw)
    sgb.add_with_ids(gx, np.arange(gn))
    torch.cuda.synchronize()
    sg_build_s = time.perf_counter() - t0
    sg_integrity = sgb.check_integrity()
    if not sg_integrity['ok'] or len(sg_integrity['shards']) != n_sh:
        fail(f'sharded graph: integrity {sg_integrity}')
    sg_state = sgb.state_arrays()
    del sgb
    sgi = {'vectors': ShardedGraphIndex(d2, beam_width=8, **skw),
           'pq_rerank0': ShardedGraphIndex(d2, beam_width=8, pq_codec=gpq, rerank=0, **skw)}
    for gi in sgi.values():
        gi.load_state_arrays(sg_state)
    gres_v, counts_v = drive('sharded graph vectors', ['beam_vec'],
                             lambda: {'b64': sgi['vectors'].search(gq, 10),
                                      'b1': sgi['vectors'].search(gq[:1], 10)})
    gres_p, counts_p = drive('sharded graph pq', ['beam_pq'],
                             lambda: {'b64': sgi['pq_rerank0'].search(gq, 10),
                                      'b1': sgi['pq_rerank0'].search(gq[:1], 10)})
    per_search('graph vectors', counts_v, {'beam_vec': 2})
    per_search('graph pq', counts_p, {'beam_pq': 2})
    sg_recall = {'vectors': recall_at_10(gres_v['b64'][1], ggt),
                 'pq_rerank0': recall_at_10(gres_p['b64'][1], ggt)}
    if sg_recall['vectors'] < 0.95 or sg_recall['pq_rerank0'] < 0.5:
        fail(f'sharded graph recall@10 {sg_recall} below 0.95 (vectors) or 0.5 (PQ)')
    for tag, rr in (('vectors', gres_v), ('pq_rerank0', gres_p)):
        if not np.array_equal(rr['b1'][1][0], rr['b64'][1][0]):
            fail(f'sharded graph {tag} batch 1: ids differ from row 0 of batch 64')
    # each shard's beam_pq, as the search calls it (its medoid, ef 128, B 8),
    # bit-equal to the eager loop with the plain scorer on that shard's
    # sub-graph; the search's answer bit-equal to those loops' answers
    # masked, cut to 10, given global ids local * 4 + shard and merged
    gpl = sgi['pq_rerank0']._sync_placed()
    dt_sg = gpq.dist_mat(gq).to(dev).float().contiguous()
    iters_sg = bm._resolve_iters(None, 128, 8)
    ref_d, ref_g = [], []
    for s_ in range(n_sh):
        adj_s, codes_s = gpl['adj'][s_].contiguous(), gpl['codes'][s_].contiguous()
        ent_s = gpl['medoids'][s_].reshape(1, 1).to(torch.int32).expand(nq, 1).contiguous()
        kd, ki, _ = bm.beam_pq_kernel(adj_s, ent_s, codes_s, dt_sg, 128, 128, 8, iters_sg)
        pd_, pi_ = bm._beam_loop(adj_s, ent_s, 128, 8, iters_sg, 128,
                                 lambda c: ad._lut_pq_scores_ref(c, codes_s, dt_sg))
        if not (torch.equal(kd, pd_) and torch.equal(ki, pi_)):
            fail(f'sharded graph pq: shard {s_}\'s beam_pq differs from the eager loop')
        ok_ = (pi_ >= 0) & (pi_ < adj_s.shape[0])
        ok_ &= gpl['alive'][s_][torch.where(ok_, pi_, 0).long()] > 0
        sd_, pos_ = stable_topk(torch.where(ok_, pd_, BIG), 10)
        ref_d.append(sd_)
        ref_g.append(torch.where(sd_ < BIG / 2, torch.gather(pi_, 1, pos_).long() * n_sh + s_, -1))
    rd_, pos_ = stable_topk(torch.cat(ref_d, dim=1), 10)
    rg_ = torch.gather(torch.cat(ref_g, dim=1), 1, pos_)
    if not (np.array_equal(gres_p['b64'][0], rd_.cpu().numpy())
            and np.array_equal(gres_p['b64'][1], rg_.cpu().numpy())):
        fail('sharded graph pq: the search differs from the merge of the eager loops')
    # a 5% filter: below the fallback selectivity, the exact scan over the
    # passing rows, each shard on its placed float32 rows on the card (never
    # the host copies), against the float64 brute force over those rows
    fmask = np.random.default_rng(SEED + 15).random(gn) < 0.05
    gv = sgi['vectors']
    gv._gather_rows = lambda rows: fail('sharded graph filter: the scan read the host copies')
    (fd, fi), _ = drive('sharded graph filter 5%', [], lambda: gv.search(gq, 10, mask=fmask))
    del gv._gather_rows
    if fi.shape != (nq, 10) or not ((fi >= 0).all() and fmask[fi].all()):
        fail('sharded graph filter: a returned row lies outside the mask')
    prow = np.flatnonzero(fmask)
    xp = torch.from_numpy(gx[prow]).to(dev).double()
    qg = torch.from_numpy(gq).to(dev).double()
    d_pass = ((qg * qg).sum(1)[:, None] + (xp * xp).sum(1)[None, :] - 2.0 * qg @ xp.T)
    ref_fd = torch.sort(d_pass, dim=1).values[:, :10]
    fi_pos = torch.from_numpy(np.searchsorted(prow, fi)).to(dev)
    got_fd = torch.from_numpy(fd).to(dev).double()
    # K3's stated tolerance: rtol 1e-5, atol 1e-5 * (|q|^2 + |x|^2)
    ftol = 1e-5 * ref_fd.abs() + 1e-5 * ((qg * qg).sum(1)[:, None]
                                         + (xp[fi_pos] * xp[fi_pos]).sum(-1))
    own_fd = torch.gather(d_pass, 1, fi_pos)
    filter_err = max((got_fd - own_fd).abs().max().item(), (got_fd - ref_fd).abs().max().item())
    if not (bool(((got_fd - own_fd).abs() <= ftol).all())
            and bool(((got_fd - ref_fd).abs() <= ftol).all())):
        fail(f'sharded graph filter: a distance off its row\'s or the brute force\'s ({filter_err})')
    filter_ms = host_ms(lambda: gv.search(gq, 10, mask=fmask), reps=5)
    del xp, qg, d_pass, dt_sg, gpl
    sh['graph'] = {
        'n': gn, 'rows_per_shard': gn // n_sh, 'build_mode': 'device', 'build_beam_width': 16,
        'build_s': sg_build_s, 'integrity_ok_every_shard': True,
        'reachable_fraction': [r['reachable_fraction'] for r in sg_integrity['shards']],
        'ef': 128, 'beam_width': 8, 'recall_at_10_vs_fp32': sg_recall,
        'pq_rerank0_per_shard_beam_pq_bit_equal_eager_loop': True,
        'pq_rerank0_search_bit_equal_merged_eager_loops': True,
        'filter_5pct': {'passing_rows': int(prow.size), 'exact_scan_on_card': True,
                        'max_abs_err_vs_fp64_brute_force': filter_err,
                        'search_ms_batch64': filter_ms},
        'launches_2_searches': {'vectors': counts_v, 'pq_rerank0': counts_p},
        'search_ms': {f'{tag}_{b}': host_ms(lambda: gi.search(gq if b == 'batch64'
                                                                else gq[:1], 10), reps=5)
                      for tag, gi in sgi.items() for b in ('batch64', 'batch1')},
        'profile_pq_rerank0_batch64': profile(lambda qq: sgi['pq_rerank0'].search(qq, 10), gq)}
    del sgi, sg_state
    torch.cuda.empty_cache()

    # (e) the data-parallel Lloyd step over the pq_scan rows against the
    # single-device step, from 256 of the rows as centroids
    c0 = torch.from_numpy(xs[:256].copy()).to(dev)
    x_sharded = shard_rows(mesh4, xs)
    c_sh, in_sh = sharded_lloyd_step(mesh4, x_sharded, c0)
    c_one, in_one = _lloyd_step(torch.from_numpy(xs).to(dev), c0)
    c_atol = 1e-4 * c_one.abs().max().item()
    lloyd_err = (c_sh - c_one).abs().max().item()
    if not (torch.allclose(c_sh, c_one, rtol=1e-4, atol=c_atol)
            and abs(in_sh.item() - in_one.item()) <= 1e-4 * abs(in_one.item())):
        fail(f'sharded_lloyd_step differs from the single-device step ({lloyd_err})')
    sh['lloyd'] = {'n': n2, 'k': 256, 'centroids_max_abs_err': lloyd_err,
                   'centroid_tolerance': f'rtol 1e-4, atol 1e-4 * max|c| = {c_atol}',
                   'inertia': in_sh.item(), 'inertia_single_device': in_one.item()}

    # (f) the multi-host path in a process group of one (NCCL on loopback),
    # 1 host x 4 shards: the hierarchical search equal to the sharded PQ
    # search above, the 2-D Lloyd step to the one above.  A failure here is
    # not caught.
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        dist_port = sock.getsockname()[1]
    pdist.init_distributed(f'localhost:{dist_port}', num_processes=1, process_id=0)
    backend = tdist.get_backend()
    hmesh = pdist.make_hybrid_mesh((1, n_sh))
    ct2 = pdist.shard_codes_2d(hmesh, codes.T)
    mk2 = pdist.shard_mask_2d(hmesh, np.ones(n2, bool), n2)
    d2d, i2d = pdist.sharded_adc_topk_2d(hmesh, pq.dist_mat(qv), ct2, mk2, 10)
    c2d, in2d = pdist.sharded_lloyd_step_2d(hmesh, pdist.put_sharded(hmesh, xs, 0), c0)
    tdist.destroy_process_group()
    if not (np.array_equal(d2d.cpu().numpy(), pq_sharded[0])
            and np.array_equal(i2d.cpu().numpy(), pq_sharded[1])):
        fail('sharded_adc_topk_2d (NCCL, world size 1) differs from the sharded PQ search')
    if not (torch.allclose(c2d, c_sh, rtol=1e-4, atol=c_atol)
            and abs(in2d.item() - in_sh.item()) <= 1e-4 * abs(in_sh.item())):
        fail('sharded_lloyd_step_2d differs from sharded_lloyd_step')
    sh['distributed'] = {
        'backend': backend, 'world_size': 1, 'mesh_shape': list(hmesh.shape),
        'adc_topk_2d_equals_sharded_pq': True, 'lloyd_2d_equals_sharded': True,
        'multi_card': f'unverified: {torch.cuda.device_count()} card visible, and NCCL '
                      'refuses two ranks on one card'}
    del ct2, mk2, x_sharded, c_sh, c_one, c2d
    torch.cuda.empty_cache()

    # (g) the facade on its default mesh (one shard a card) over phase 7's
    # 100,000 x 128 docs: sharded flat, and sharded PQ64 (no rerank)
    def facade_sharded_path(kind, data_dir, kw):
        shutil.rmtree(data_dir, ignore_errors=True)
        cfg = dict(n_dim=df, metric='euclidean', index_type=kind,
                   columns=[('price', float)], data_path=data_dir, **kw)
        ann = AnnLite(**cfg)
        if kw:
            ann.train(xf[:10240])
        t = time.perf_counter()
        for lo in range(0, nf, 20_000):
            ann.index([Doc(id=str(i), embedding=xf[i], tags={'price': float(prices[i])})
                       for i in range(lo, min(lo + 20_000, nf))])
        ingest = time.perf_counter() - t
        shards = ann._container.index.n_shards
        _, ids = ann.search_numpy(qf_np[:16], limit=10)
        hits = sum(ids[i][0] == str(i) for i in range(16))
        # the JAX package's facade test holds 8 of 10; the PQ search has no rerank
        if hits < (16 if kind == 'sharded_flat' else 13):
            fail(f'facade {kind}: self-hits {hits}/16')
        flt = {'price': {'$lt': 50.0}}
        for matches in ann.search_by_vectors(qf_np[:8], filter=flt, limit=10,
                                             include_metadata=True):
            if not matches or any(m.tags['price'] >= 50.0 for m in matches):
                fail(f'facade {kind}: filtered search returned a doc outside the filter')
        gone = [str(i) for i in range(2000, 2100)]
        ann.delete(gone)
        _, ids = ann.search_numpy(xf[2000:2100], limit=10)
        if set(gone) & {i for row in ids for i in row}:
            fail(f'facade {kind}: a deleted doc was returned')
        d_np, ids_np = ann.search_numpy(qf_np, limit=10)
        search_ms = host_ms(lambda: ann.search_numpy(qf_np, limit=10), reps=10)
        ann.dump()
        ann.close()
        ann = AnnLite(**cfg)
        d_re, ids_re = ann.search_numpy(qf_np, limit=10)
        if ids_re != ids_np or not all(np.array_equal(a, b) for a, b in zip(d_re, d_np)):
            fail(f'facade {kind}: results differ after dump and reopen')
        ann.close()
        shutil.rmtree(data_dir, ignore_errors=True)
        return {'shards': shards, 'self_hits_16': hits, 'ingest_docs_per_s': nf / ingest,
                'search_numpy_ms_batch64': search_ms}

    for kind, kw, expected in (
            ('sharded_flat', {}, ['block_top2', 'lane8_merge', 'gather_rerank']),
            ('sharded_pq', dict(n_subvectors=64), ['adc_scores'])):
        out, counts = drive(f'facade {kind}', expected, lambda: facade_sharded_path(
            kind, ROOT / 'build' / f'chip_smoke_{kind}', kw))
        sh[f'facade_{kind}'] = dict(out, launches=counts)
    emit({'phase': 'sharded', **sh, 'phase_s': time.perf_counter() - t_sharded})
    del xn, xs, codes

    # ---------------- result ----------------
    src = {'block_top2': 'annlite_torch/csrc/fused_scan.cu',
           'ivf_scores': 'annlite_torch/csrc/ivf.cu',
           'ivf_block_top2': 'annlite_torch/csrc/ivf.cu',
           'block_top2_int4': 'annlite_torch/csrc/fused_scan.cu',
           'block_top2_bf16': 'annlite_torch/csrc/fused_scan.cu',
           'lane8_merge': 'annlite_torch/csrc/fused_scan.cu',
           'gather_rerank': 'annlite_torch/csrc/gather.cu',
           'lut_pq_scores': 'annlite_torch/csrc/lut_pq.cu',
           'adc_scores_i8': 'annlite_torch/csrc/adc_i8.cu',
           'beam_pq': 'annlite_torch/csrc/beam_pq.cu',
           'beam_vec': 'annlite_torch/csrc/beam_vec.cu',
           'masked_scan': 'annlite_torch/csrc/masked_scan.cu'}
    replaces = {'block_top2': 'annlite_tpu/ops/fused_scan.py:99',
                'lane8_merge': 'annlite_tpu/ops/fused_scan.py:121',
                # the int4 and bf16 branches of K1/K2's block scoring
                'block_top2_int4': 'annlite_tpu/ops/fused_scan.py:48',
                'block_top2_bf16': 'annlite_tpu/ops/fused_scan.py:71',
                'gather_rerank': 'annlite_tpu/ops/gather.py:31',
                'adc_scores': 'annlite_tpu/ops/adc.py:67',
                'adc_block_top2': 'annlite_tpu/ops/adc.py:169',
                'ivf_scores': 'annlite_tpu/ops/ivf.py:31',
                'ivf_block_top2': 'annlite_tpu/ops/ivf.py:78',
                'lut_pq_scores': 'annlite_tpu/ops/adc.py:283',
                'adc_scores_i8': 'annlite_tpu/ops/adc_i8.py:56',
                # K8 with the loop around it (annlite_tpu/ops/beam.py:149)
                'beam_pq': 'annlite_tpu/ops/adc.py:283',
                # no Pallas kernel: the vector scorer's loop, an einsum under jit
                'beam_vec': 'annlite_tpu/ops/beam.py:217',
                # no Pallas kernel: an XLA product and lax.top_k
                'masked_scan': 'none: annlite_tpu/index/graph.py:803'}
    emit({'phase': 'bounds', 'bound_of': {k: bounds[k][2] for k in kernels}})
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
