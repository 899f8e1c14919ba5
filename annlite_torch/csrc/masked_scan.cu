// The graph filter's masked exact scan for Hopper (sm_90a): exact float32
// distances of the rows a predicate passes, and each query's k best.
//
// Replaces no Pallas kernel.  The JAX package computes this scan
// (annlite_tpu/index/graph.py _masked_exact_scan, the fallback of a filtered
// graph search under a selective predicate) as an XLA product and
// lax.top_k; the port ran it as a float32 GEMM over every row, a where()
// over the mask and a stable sort of all Q x N scores, a global radix sort
// that took ~1.1 ms of the card a 64-query request over 262,144 rows.  It was
// added because that sort kept k of N columns.
//
// Bound on an H100 SXM at Q = 64, N = 262,144, D = 96 float32, 5-20% of
// rows passing: the mask (256 KiB) and the passing rows (5-20 MB) at 3.35
// TB/s, 1.6-6.1 us; 2 * Q * passing * D float32 operations at 67 TFLOP/s,
// 2.4-9.6 us.  Neither product nor sort touches a failing row or a Q x N
// score.
//
// Design, two launches:
// 1. masked_scan_kernel: a CTA takes `tile` rows of the mask and 64
//    queries.  It reads the tile's mask in 16-byte loads, 4,096 rows a step,
//    and compacts the passing rows' indices into shared memory (popcounts, a
//    warp scan and the warps' totals), in row order.  Chunks of 64 passing
//    rows are then scored against the 64 queries: slices of 32 dimensions of
//    the rows (16-byte loads, float32 or bf16 widened in registers to the
//    values .float() gives) and of the queries go through two sets of
//    registers into a double buffer in shared memory, the loads of the slice
//    after next in flight while the current one is multiplied; each thread
//    sums 4 queries x 4 rows with float32 FMAs, in dimension order (|v|^2
//    and |q|^2 beside them for squared L2 only).  Then each warp keeps 8
//    queries' lists of the k best (distance, row) pairs, as 64-bit keys (the
//    distance's order-preserving bits, then the row), in registers while it
//    merges the chunk: a row enters only if it beats the list's k-th key and
//    the least k-th key any tile has published for the query (an atomicMin
//    in device memory after each chunk), so after the first chunk inserts
//    are rare (a run of 32 rows with more than a few goes in by a bitonic
//    sort and merge).  The CTA writes its lists [Q, tiles, k], and (one CTA
//    a tile) the tile's first k failing rows and their count.
// 2. masked_scan_merge_kernel: a CTA a query merges its tiles' lists and the
//    mask's first k failing rows (each the key (BIG, row)) by bitonic merges
//    of two sorted lists in a warp's registers, the warps' lists then
//    pairwise through shared memory, and writes the first k.
//
// The result is the stable sort's: distances
//   euclidean      (|q|^2 + |v|^2) - 2 q.v,
//   inner product  1 - q.v (cosine: the caller normalised the rows),
// ordered by (distance, row), a failing row scoring BIG, so slots beyond the
// passing count hold (BIG, the lowest failing rows).  -0.0 orders as +0.0
// and comes back as +0.0; a NaN orders last.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

// Phase clocks: a measuring copy (scripts/masked_scan_probe.py) defines
// these to add thread 0's clock64() deltas to a device array; here they are
// nothing.
#ifndef ANNLITE_MARK
#define ANNLITE_MARK_START()
#define ANNLITE_MARK(phase)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 64;                 // queries a CTA
constexpr int kRC = 64;                 // passing rows a chunk
constexpr int kDC = 32;                 // dimensions a slice
constexpr int kStride = kDC + 4;        // floats a row of a slice takes in shared memory
constexpr int kScStride = kRC + 4;      // floats a query's chunk of dot products takes
constexpr int kStep = 16 * kThreads;    // mask rows a compaction step
constexpr int kMaxSmem = 232448;        // 227 KB: a block's shared memory limit
constexpr int kMaxCards = 64;           // cards whose shared memory limits are remembered
// a run of 32 rows with more hits than this is sorted and merged into the
// list, not inserted row by row
constexpr int kFewHits = 4;
constexpr float kBig = 3.4e38f;         // BIG of the Python side, in float32
constexpr unsigned long long kNone = ~0ull;

struct Args {
  const void* rows;         // [>= n, dim] float32 or bf16
  const float* q;           // [nq, dim]
  const unsigned char* mask;  // [n]
  unsigned long long* cand;   // [nq, tiles, k]
  unsigned long long* bound;  // [nq] the least k-th key a tile has published
  int* fail_rows;           // [tiles, k]
  int* fail_cnt;            // [tiles]
  float* d_out;             // [nq, k]
  int* id_out;              // [nq, k]
  int n, dim, nq, k, tile, tiles, euclid, mask_vec;
};

// order-preserving bits of a distance: -0.0 as +0.0, every NaN last
__device__ __forceinline__ unsigned okey(float d) {
  if (d != d) return 0xFFFFFFFFu;
  const unsigned b = d == 0.0f ? 0u : __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float funkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// bit j: byte j of w is not 0
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return ((w & 0xFFu) != 0) | (((w >> 8) & 0xFFu) != 0) << 1 |
         (((w >> 16) & 0xFFu) != 0) << 2 | ((w >> 24) != 0) << 3;
}

// Elements e0 .. e0 + 7 of a row (0 beyond dim, all 0 for a null row).
// kBytes: 4 for float32, 2 for bf16.  kVec: the row is whole 16-byte words
// (dim * kBytes % 16 == 0, an aligned base), else one element a load.
template <int kBytes, bool kVec>
__device__ __forceinline__ void load8(const unsigned char* row, int e0, int dim, float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.0f;
  if (row == nullptr) return;
  if constexpr (kVec && kBytes == 4) {
    const float4* p = reinterpret_cast<const float4*>(row) + (e0 >> 2);
    if (e0 < dim) {
      const float4 x = __ldg(p);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    }
    if (e0 + 4 < dim) {
      const float4 x = __ldg(p + 1);
      v[4] = x.x; v[5] = x.y; v[6] = x.z; v[7] = x.w;
    }
  } else if constexpr (kVec) {
    if (e0 < dim) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row) + (e0 >> 3));
      const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(x[j] << 16);
        v[2 * j + 1] = __uint_as_float(x[j] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (e0 + j < dim) {
        const unsigned short* h = reinterpret_cast<const unsigned short*>(row) + e0 + j;
        v[j] = kBytes == 4 ? __ldg(reinterpret_cast<const float*>(row) + e0 + j)
                           : __uint_as_float((unsigned)__ldg(h) << 16);
      }
    }
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// slot i of a warp's list (slot s * 32 + lane in L[s] of that lane)
template <int KL>
__device__ __forceinline__ unsigned long long slot(const unsigned long long (&L)[KL], int i) {
  unsigned long long v = L[0];
#pragma unroll
  for (int s = 1; s < KL; ++s) {
    if (s == (i >> 5)) v = L[s];
  }
  return __shfl_sync(0xffffffffu, v, i & 31);
}

// insert key x (not in the list) into a warp's sorted list
template <int KL>
__device__ __forceinline__ void insert(unsigned long long (&L)[KL], unsigned long long x,
                                       int lane) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < KL; ++s) pos += __popc(__ballot_sync(0xffffffffu, L[s] < x));
  unsigned long long out[KL];
#pragma unroll
  for (int s = 0; s < KL; ++s) {
    const unsigned long long up = __shfl_up_sync(0xffffffffu, L[s], 1);
    const unsigned long long carry =
        s > 0 ? __shfl_sync(0xffffffffu, L[s > 0 ? s - 1 : 0], 31) : 0ull;
    const int idx = s * 32 + lane;
    out[s] = idx > pos ? (lane == 0 ? carry : up) : (idx == pos ? x : L[s]);
  }
#pragma unroll
  for (int s = 0; s < KL; ++s) L[s] = out[s];
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long kmax(unsigned long long a, unsigned long long b) {
  return a < b ? b : a;
}

// A warp's 32 keys (one a lane) sorted ascending by a bitonic network.
__device__ __forceinline__ unsigned long long sort32(unsigned long long x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, x, st);
      x = (((lane & st) == 0) == ((lane & size) == 0)) ? kmin(x, o) : kmax(x, o);
    }
  }
  return x;
}

// A bitonic sequence of a warp's KL * 32 keys sorted ascending.
template <int KL>
__device__ __forceinline__ void bitonic_merge(unsigned long long (&L)[KL], int lane) {
#pragma unroll
  for (int st = KL / 2; st >= 1; st >>= 1) {  // partners in the lane's own registers
#pragma unroll
    for (int s = 0; s < KL; ++s) {
      if ((s & st) == 0) {
        const unsigned long long x = L[s], y = L[s + st];
        L[s] = kmin(x, y);
        L[s + st] = kmax(x, y);
      }
    }
  }
#pragma unroll
  for (int st = 16; st > 0; st >>= 1) {  // partners in other lanes
#pragma unroll
    for (int s = 0; s < KL; ++s) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, L[s], st);
      L[s] = (lane & st) == 0 ? kmin(L[s], o) : kmax(L[s], o);
    }
  }
}

// The KL * 32 smallest of two sorted lists into L: L[i] min B[last - i] is
// bitonic and holds them.
template <int KL>
__device__ __forceinline__ void merge_lists(unsigned long long (&L)[KL],
                                            const unsigned long long (&B)[KL], int lane) {
#pragma unroll
  for (int s = 0; s < KL; ++s) {
    L[s] = kmin(L[s], __shfl_sync(0xffffffffu, B[KL - 1 - s], 31 - lane));
  }
  bitonic_merge<KL>(L, lane);
}

// The same with a sorted run of 32 keys (one a lane) as B, kNone after it.
template <int KL>
__device__ __forceinline__ void merge_run(unsigned long long (&L)[KL], unsigned long long r,
                                          int lane) {
  L[KL - 1] = kmin(L[KL - 1], __shfl_sync(0xffffffffu, r, 31 - lane));
  bitonic_merge<KL>(L, lane);
}

__host__ __device__ constexpr size_t scan_fixed_bytes() {
  return sizeof(unsigned long long) * kQT +
         sizeof(float) * (2 * kQT * kStride + 2 * kRC * kStride + kQT * kScStride + kQT + kRC) +
         sizeof(int) * (kStep + kRC + kWarps);
}

__host__ __device__ constexpr size_t scan_smem(int kl) {
  return sizeof(unsigned long long) * kQT * 32 * kl + scan_fixed_bytes();
}

__host__ __device__ constexpr size_t merge_smem(int kl, int warps) {
  return sizeof(unsigned long long) * 32 * kl * warps;
}

struct Smem {
  unsigned long long* lists;  // [kQT][32 * KL]
  unsigned long long* gb;     // [kQT] the queries' published bounds, read at a chunk's start
  float* qs;                  // [2][kQT][kStride]
  float* rs;                  // [2][kRC][kStride]
  float* sc;                  // [kQT][kScStride] dot products of a chunk
  float* qn;                  // [kQT] |q|^2
  float* vn;                  // [kRC] |v|^2 of a chunk's rows
  int* rowbuf;                // [kStep + kRC] passing rows not scored yet
  int* wtot;                  // [kWarps] a compaction step's per-warp counts
};

// Score the chunk of `cnt` (<= kRC) passing rows ids[0 .. cnt) against the
// CTA's queries and merge them into the lists.  Starts and ends with the
// block synchronised.
template <int kBytes, bool kVec, int KL>
__device__ __forceinline__ void score_chunk(const Args& a, const Smem& m, const int* ids, int cnt,
                                            int q0) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // loading: thread t brings elements 8 * part .. of a slice of row lr and
  // of query lr
  const int lr = t >> 2, part = t & 3;
  const unsigned char* rp =
      lr < cnt ? static_cast<const unsigned char*>(a.rows) + (size_t)ids[lr] * a.dim * kBytes
               : nullptr;
  const unsigned char* qp =
      q0 + lr < a.nq ? reinterpret_cast<const unsigned char*>(a.q + (size_t)(q0 + lr) * a.dim)
                     : nullptr;
  // multiplying: thread t sums queries 4 tq + j and rows tr + 16 i
  const int tq = t >> 4, tr = t & 15;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }
  float vsq = 0.0f, qsq = 0.0f;  // |v|^2 of row lr, |q|^2 of query lr: squared L2 only
  const bool euclid = a.euclid != 0;
  // the queries' bounds, for the selection after the products
  if (t < kQT && q0 + t < a.nq) m.gb[t] = __ldcg(a.bound + q0 + t);
  const int slices = (a.dim + kDC - 1) / kDC;
  // slice s + 1 waits in one set of registers while slice s + 2 loads into
  // the other, so a load has two slices' products to arrive
  float ra[8], qa[8], rb[8], qb[8];
  auto keep = [&](const float (&r)[8], const float (&qv)[8], int buf) {
    if (euclid) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        vsq = __fadd_rn(vsq, __fmul_rn(r[j], r[j]));
        qsq = __fadd_rn(qsq, __fmul_rn(qv[j], qv[j]));
      }
    }
    store8(m.rs + (buf * kRC + lr) * kStride + 8 * part, r);
    store8(m.qs + (buf * kQT + lr) * kStride + 8 * part, qv);
  };
  auto step = [&](int s, const float (&nr)[8], const float (&nq)[8], float (&fr)[8],
                  float (&fq)[8]) {
    if (s + 2 < slices) {
      load8<kBytes, kVec>(rp, (s + 2) * kDC + 8 * part, a.dim, fr);
      load8<4, kVec>(qp, (s + 2) * kDC + 8 * part, a.dim, fq);
    }
    const float* qs = m.qs + (s & 1) * kQT * kStride;
    const float* rs = m.rs + (s & 1) * kRC * kStride;
#pragma unroll
    for (int c = 0; c < kDC; c += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = *reinterpret_cast<const float4*>(qs + (4 * tq + j) * kStride + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[i] = *reinterpret_cast<const float4*>(rs + (tr + 16 * i) * kStride + c);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[j][i] = fmaf(x[j].x, y[i].x, acc[j][i]);
          acc[j][i] = fmaf(x[j].y, y[i].y, acc[j][i]);
          acc[j][i] = fmaf(x[j].z, y[i].z, acc[j][i]);
          acc[j][i] = fmaf(x[j].w, y[i].w, acc[j][i]);
        }
      }
    }
    if (s + 1 < slices) keep(nr, nq, (s + 1) & 1);
    __syncthreads();
  };
  load8<kBytes, kVec>(rp, 8 * part, a.dim, ra);
  load8<4, kVec>(qp, 8 * part, a.dim, qa);
  if (slices > 1) {
    load8<kBytes, kVec>(rp, kDC + 8 * part, a.dim, rb);
    load8<4, kVec>(qp, kDC + 8 * part, a.dim, qb);
  }
  keep(ra, qa, 0);
  __syncthreads();
  for (int s = 0; s < slices; s += 2) {
    step(s, rb, qb, ra, qa);
    if (s + 1 < slices) step(s + 1, ra, qa, rb, qb);
  }
  ANNLITE_MARK(2);
  // |v|^2 and |q|^2 over the row's and query's four lanes (neighbours in the warp)
  vsq = __fadd_rn(vsq, __shfl_xor_sync(0xffffffffu, vsq, 1));
  vsq = __fadd_rn(vsq, __shfl_xor_sync(0xffffffffu, vsq, 2));
  qsq = __fadd_rn(qsq, __shfl_xor_sync(0xffffffffu, qsq, 1));
  qsq = __fadd_rn(qsq, __shfl_xor_sync(0xffffffffu, qsq, 2));
  if (part == 0) {
    m.vn[lr] = vsq;
    m.qn[lr] = qsq;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) m.sc[(4 * tq + j) * kScStride + tr + 16 * i] = acc[j][i];
  }
  __syncthreads();
  ANNLITE_MARK(3);
  // selection: warp w merges the chunk into the lists of queries w, w + 8, ..
  for (int ql = warp; ql < kQT && q0 + ql < a.nq; ql += kWarps) {
    unsigned long long* lst = m.lists + ql * 32 * KL;
    unsigned long long L[KL];
#pragma unroll
    for (int s = 0; s < KL; ++s) L[s] = lst[s * 32 + lane];
    // a row enters only below the list's k-th key and below the least k-th
    // key any tile has published for the query (the k best are below both)
    const unsigned long long gb = m.gb[ql];
    unsigned long long thr = kmin(slot<KL>(L, a.k - 1), gb);
    const float qq = m.qn[ql];
#pragma unroll
    for (int p = 0; p < kRC; p += 32) {
      const int c = p + lane;
      unsigned long long key = kNone;
      if (c < cnt) {
        const float dot = m.sc[ql * kScStride + c];
        const float d = euclid ? __fsub_rn(__fadd_rn(qq, m.vn[c]), __fmul_rn(2.0f, dot))
                               : __fsub_rn(1.0f, dot);
        key = (unsigned long long)okey(d) << 32 | (unsigned)ids[c];
      }
      unsigned hits = __ballot_sync(0xffffffffu, key < thr);
      if (__popc(hits) > kFewHits) {  // sort the run's hits, merge them in
        merge_run<KL>(L, sort32(key < thr ? key : kNone, lane), lane);
        thr = kmin(slot<KL>(L, a.k - 1), gb);
        continue;
      }
      while (hits) {
        const int src = __ffs(hits) - 1;
        insert<KL>(L, __shfl_sync(0xffffffffu, key, src), lane);
        thr = kmin(slot<KL>(L, a.k - 1), gb);
        hits &= hits - 1;
        hits &= __ballot_sync(0xffffffffu, key < thr);
      }
    }
#pragma unroll
    for (int s = 0; s < KL; ++s) lst[s * 32 + lane] = L[s];
    if (lane == 0 && thr < gb) atomicMin(a.bound + q0 + ql, thr);  // thr < gb: a full list's k-th
  }
  __syncthreads();
  ANNLITE_MARK(4);
}

template <int kBytes, bool kVec, int KL>
__global__ void __launch_bounds__(kThreads) masked_scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem m;
  m.lists = reinterpret_cast<unsigned long long*>(smem);
  m.gb = m.lists + kQT * 32 * KL;
  m.qs = reinterpret_cast<float*>(m.gb + kQT);
  m.rs = m.qs + 2 * kQT * kStride;
  m.sc = m.rs + 2 * kRC * kStride;
  m.qn = m.sc + kQT * kScStride;
  m.vn = m.qn + kQT;
  m.rowbuf = reinterpret_cast<int*>(m.vn + kRC);
  m.wtot = m.rowbuf + kStep + kRC;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * kQT;
  const int r_begin = tile * a.tile;
  const int r_end = min(a.n, r_begin + a.tile);
  const bool record_fails = blockIdx.y == 0;
  ANNLITE_MARK_START();

  for (int i = t; i < kQT * 32 * KL; i += kThreads) m.lists[i] = kNone;
  __syncthreads();
  ANNLITE_MARK(0);

  int rem = 0;    // passing rows in rowbuf not scored yet
  int fails = 0;  // failing rows of the tile so far
  for (int s0 = r_begin; s0 < r_end; s0 += kStep) {
    const int s1 = min(r_end, s0 + kStep);
    const int r0 = s0 + 16 * t;
    unsigned pb = 0, vb = 0;
    if (r0 < s1) {
      if (a.mask_vec && r0 + 16 <= s1) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(a.mask + r0));
        pb = byte_bits(w.x) | byte_bits(w.y) << 4 | byte_bits(w.z) << 8 | byte_bits(w.w) << 12;
        vb = 0xFFFFu;
      } else {
        for (int j = 0; j < 16 && r0 + j < s1; ++j) {
          vb |= 1u << j;
          pb |= (unsigned)(a.mask[r0 + j] != 0) << j;
        }
      }
    }
    const unsigned fb = vb & ~pb;
    // passing count in the low 16 bits, failing in the high: both <= kStep
    const int mine = __popc(pb) | __popc(fb) << 16;
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) m.wtot[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = m.wtot[w];
      if (w < warp) before += x;
      total += x;
    }
    const int excl = before + incl - mine;
    int at = rem + (excl & 0xFFFF);
    for (unsigned b = pb; b; b &= b - 1) m.rowbuf[at++] = r0 + __ffs(b) - 1;
    if (record_fails) {
      int f = fails + (excl >> 16);
      for (unsigned b = fb; b && f < a.k; b &= b - 1) {
        a.fail_rows[(size_t)tile * a.k + f++] = r0 + __ffs(b) - 1;
      }
    }
    rem += total & 0xFFFF;
    fails += total >> 16;
    __syncthreads();
    ANNLITE_MARK(1);
    int done = 0;
    for (; done + kRC <= rem; done += kRC) {
      score_chunk<kBytes, kVec, KL>(a, m, m.rowbuf + done, kRC, q0);
    }
    if (done > 0) {
      const int left = rem - done;  // < kRC <= done: the copy does not overlap
      if (t < left) m.rowbuf[t] = m.rowbuf[done + t];
      rem = left;
      __syncthreads();
    }
  }
  if (rem > 0) score_chunk<kBytes, kVec, KL>(a, m, m.rowbuf, rem, q0);

  for (int ql = warp; ql < kQT && q0 + ql < a.nq; ql += kWarps) {
    unsigned long long* out = a.cand + ((size_t)(q0 + ql) * a.tiles + tile) * a.k;
    for (int j = lane; j < a.k; j += 32) out[j] = m.lists[ql * 32 * KL + j];
  }
  if (record_fails && t == 0) a.fail_cnt[tile] = min(fails, a.k);
  ANNLITE_MARK(5);
}

// One CTA a query, `merge_warps` warps: warp w folds the lists of tiles w,
// w + warps, .. into its own (warp 0 starts from the mask's first k failing
// rows, the keys (BIG, row) in row order), each fold a bitonic merge of two
// sorted lists; then the warps' lists are merged pairwise in shared memory,
// and warp 0 writes the first k.
template <int KL>
__global__ void __launch_bounds__(1024) masked_scan_merge_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* part = reinterpret_cast<unsigned long long*>(smem);  // [warps][32 * KL]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const unsigned long long* c = a.cand + (size_t)blockIdx.x * a.tiles * a.k;
  unsigned long long acc[KL], b[KL], nb[KL];
#pragma unroll
  for (int s = 0; s < KL; ++s) acc[s] = b[s] = nb[s] = kNone;
  if (warp == 0) {
    unsigned long long* fl = part;  // staging: warp 0's own slot of `part`
#pragma unroll
    for (int s = 0; s < KL; ++s) fl[s * 32 + lane] = kNone;
    __syncwarp();
    const unsigned long long big = (unsigned long long)okey(kBig) << 32;
    int have = 0;
    for (int t0 = 0; t0 < a.tiles && have < a.k; t0 += 32) {
      const int tl = t0 + lane;
      const int cnt = tl < a.tiles ? a.fail_cnt[tl] : 0;
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const int at = have + incl - cnt;
      for (int j = 0; j < cnt && at + j < a.k; ++j) {
        fl[at + j] = big | (unsigned)a.fail_rows[(size_t)tl * a.k + j];
      }
      have += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < KL; ++s) acc[s] = fl[s * 32 + lane];
    __syncwarp();
  }
  auto load = [&](int t, unsigned long long (&L)[KL]) {
#pragma unroll
    for (int s = 0; s < KL; ++s) {
      const int j = s * 32 + lane;
      L[s] = j < a.k ? c[(size_t)t * a.k + j] : kNone;
    }
  };
  if (warp < a.tiles) load(warp, b);
  for (int t = warp; t < a.tiles; t += warps) {
    if (t + warps < a.tiles) load(t + warps, nb);  // in flight during the merge
    merge_lists<KL>(acc, b, lane);
#pragma unroll
    for (int s = 0; s < KL; ++s) b[s] = nb[s];
  }
#pragma unroll
  for (int s = 0; s < KL; ++s) part[(warp * KL + s) * 32 + lane] = acc[s];
  for (int half = warps >> 1; half > 0; half >>= 1) {
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int s = 0; s < KL; ++s) b[s] = part[((warp + half) * KL + s) * 32 + lane];
      merge_lists<KL>(acc, b, lane);
#pragma unroll
      for (int s = 0; s < KL; ++s) part[(warp * KL + s) * 32 + lane] = acc[s];
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < KL; ++s) {
      const int j = s * 32 + lane;
      if (j < a.k) {
        a.d_out[(size_t)blockIdx.x * a.k + j] = funkey((unsigned)(acc[s] >> 32));
        a.id_out[(size_t)blockIdx.x * a.k + j] = (int)(unsigned)(acc[s] & 0xFFFFFFFFu);
      }
    }
  }
}

// Lift a kernel's dynamic shared memory limit to `smem` on the current
// card, once a card (`done` is the kernel's own flags; a repeat is harmless).
template <class K>
cudaError_t allow_smem(K kern, size_t smem, bool (&done)[kMaxCards]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card < kMaxCards && done[card]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // the most shared memory an SM can give, so that CTAs share an SM
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess && card < kMaxCards) done[card] = true;
  return e;
}

template <int kBytes, bool kVec, int KL>
int run(const Args& a, cudaStream_t st) {
  static bool done[kMaxCards] = {};
  const size_t smem = scan_smem(KL);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = masked_scan_kernel<kBytes, kVec, KL>;
  const cudaError_t e = allow_smem(kern, smem, done);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.tiles, (a.nq + kQT - 1) / kQT), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int kBytes, bool kVec>
int run_kl(const Args& a, int kl, cudaStream_t st) {
  switch (kl) {
    case 1: return run<kBytes, kVec, 1>(a, st);
    case 2: return run<kBytes, kVec, 2>(a, st);
    case 4: return run<kBytes, kVec, 4>(a, st);
    case 8: return run<kBytes, kVec, 8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int KL>
int merge(const Args& a, int warps, cudaStream_t st) {
  static bool done[kMaxCards] = {};
  auto kern = masked_scan_merge_kernel<KL>;
  const cudaError_t e = allow_smem(kern, merge_smem(KL, 32), done);  // the most warps
  if (e != cudaSuccess) return (int)e;
  kern<<<a.nq, warps * 32, merge_smem(KL, warps), st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The masked exact scan of nq queries [nq, dim] float32 over the rows
// [>= n, dim] (float32 when row_bytes == 4, bf16 when 2) whose byte of
// mask [n] is not 0 -> d_out [nq, k] float32 and id_out [nq, k] int32: the
// k best by (distance, row), a failing row scoring (BIG, row).  euclid:
// squared L2, else 1 - inner product.  Scratch: cand [nq, tiles, k] 8-byte
// keys, bound [nq] 8-byte keys (set to none here first), fail_rows [tiles,
// k] and fail_cnt [tiles] int32.  The plan (tile,
// tiles, list_slots, merge_warps) comes from ops/masked_scan.py
// masked_scan_plan.  Launches the scan and the merge on `stream`; returns
// cudaGetLastError() of the later one (cudaErrorInvalidValue for a geometry
// it does not take).
int annlite_masked_scan(const void* rows, const void* queries, const void* mask, void* cand,
                        void* bound, void* fail_rows, void* fail_cnt, void* d_out, void* id_out,
                        int n, int dim, int nq, int k, int row_bytes, int euclid, int tile, int tiles,
                        int list_slots, int merge_warps, void* stream) {
  const int kl = list_slots / 32;
  if (n < 1 || dim < 1 || nq < 1 || k < 1 || k > n || k > list_slots || list_slots % 32 != 0 ||
      tile < kRC || tile % kRC != 0 || tiles != (int)(((long long)n + tile - 1) / tile) ||
      (long long)tiles * k > (1 << 30) || (nq + kQT - 1) / kQT > 65535 || merge_warps < 1 ||
      merge_warps > 32 || (merge_warps & (merge_warps - 1)) != 0 ||
      (row_bytes != 4 && row_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.rows = rows;
  a.q = static_cast<const float*>(queries);
  a.mask = static_cast<const unsigned char*>(mask);
  a.cand = static_cast<unsigned long long*>(cand);
  a.bound = static_cast<unsigned long long*>(bound);
  a.fail_rows = static_cast<int*>(fail_rows);
  a.fail_cnt = static_cast<int*>(fail_cnt);
  a.d_out = static_cast<float*>(d_out);
  a.id_out = static_cast<int*>(id_out);
  a.n = n;
  a.dim = dim;
  a.nq = nq;
  a.k = k;
  a.tile = tile;
  a.tiles = tiles;
  a.euclid = euclid;
  a.mask_vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const bool vec = ((size_t)dim * row_bytes) % 16 == 0 && dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(bound, 0xFF, sizeof(unsigned long long) * nq, st);  // kNone
  if (err != 0) return err;
  if (row_bytes == 4) {
    err = vec ? run_kl<4, true>(a, kl, st) : run_kl<4, false>(a, kl, st);
  } else {
    err = vec ? run_kl<2, true>(a, kl, st) : run_kl<2, false>(a, kl, st);
  }
  if (err != 0) return err;
  switch (kl) {
    case 1: return merge<1>(a, merge_warps, st);
    case 2: return merge<2>(a, merge_warps, st);
    case 4: return merge<4>(a, merge_warps, st);
    default: return merge<8>(a, merge_warps, st);
  }
}

// Registers, local (spilled) bytes a thread and resident CTAs an SM of the
// scan instance for lists of list_slots keys, row_bytes-byte elements and
// 16-byte loads (vec) or not, at its shared memory; the merge's registers.
int annlite_masked_scan_info(int list_slots, int row_bytes, int vec, int* out) {
  const void* kern = nullptr;
#define ANNLITE_INFO(B, V, K) \
  if (row_bytes == B && (vec != 0) == V && list_slots == 32 * K) \
    kern = (const void*)masked_scan_kernel<B, V, K>;
  ANNLITE_INFO(4, true, 1) ANNLITE_INFO(4, true, 2) ANNLITE_INFO(4, true, 4)
  ANNLITE_INFO(4, true, 8) ANNLITE_INFO(4, false, 1) ANNLITE_INFO(4, false, 2)
  ANNLITE_INFO(4, false, 4) ANNLITE_INFO(4, false, 8) ANNLITE_INFO(2, true, 1)
  ANNLITE_INFO(2, true, 2) ANNLITE_INFO(2, true, 4) ANNLITE_INFO(2, true, 8)
  ANNLITE_INFO(2, false, 1) ANNLITE_INFO(2, false, 2) ANNLITE_INFO(2, false, 4)
  ANNLITE_INFO(2, false, 8)
#undef ANNLITE_INFO
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  bool done[kMaxCards] = {};  // this instance's limit, lifted here whatever run() did
  const size_t smem = scan_smem(list_slots / 32);
  cudaError_t e = allow_smem(kern, smem, done);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  int ctas = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kThreads, smem);
  }
  cudaFuncAttributes fm;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fm, masked_scan_merge_kernel<1>);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = ctas;
  out[3] = fm.numRegs;
  return 0;
}

}  // extern "C"
