// IVF-PQ scans for Hopper (sm_90a): ADC over the probed code blocks of an
// IVF index, named by a device array of block ids (-1 pads a selection),
//   score[q, j, slot] = sum_m dtable[q, m, codes[block_ids[j], m, slot]].
//
// Replaces two Pallas kernels of the JAX package:
//   * annlite_tpu/ops/ivf.py:31 _ivf_kernel (K7) -> ivf_rows_kernel: the
//     [S, Q, BS] scores, the slot mask applied outside.  The dispatch sends
//     it fewer than 16 selections; the IVF-PQ search at probe 1 gives it one
//     or two blocks and one query;
//   * annlite_tpu/ops/ivf.py:78 _ivf_kernel8 (K6) -> ivf_top2_kernel: K7's
//     scores plus the slot-mask bias and BIG for pad selections, the
//     bucketed top-2 per (query, selection, lane) with provenance
//     j * BS + slot, which lane8_merge (csrc/fused_scan.cu) finishes; 16
//     selections and more (118-139 at batch 8, probe 8).
// Above two queries K7 keeps the lookup core of csrc/adc.cu, and K6 takes
// the core where ops/ivf.py ivf_plan expects it faster (many selections,
// whose grid fills the card, and its wider query tiles); the plan names
// those choices and each kernel's launch.
//
// K7, a latency-bound body for few rows.  At Q = 1, S = 1 the work is 65,536
// lookups and 64 KB of codes: a few microseconds of any throughput, so the
// time is the launch, the codes' and the table's first reads from DRAM and
// the 64 dependent additions of each score.  So: one launch, no interleave;
// a warp per CTA and two slots per thread (S * BS / 64 CTAs: 16 warps on 16
// SMs at S = 1 where the core ran 8); each thread loads all of its 64 code
// words before its first lookup, 64 loads in flight; the table is staged by
// bulk copies into shared memory in chunks of mc subspaces, each on its own
// mbarrier, or read through L1/L2 (__ldg).  ops/ivf.py ivf_plan picks: on an
// H100 the staged table in one chunk ran fastest (chunks of 4 to 16
// subspaces, and the L2 reads, were slower; PERF.md); a table that does not
// fit shared memory is read through L2.
//
// K6, filling the card in one launch.  The work is split into units of one
// (query tile, selection, group of 128 slots), one warp's each: 32 threads
// of 4 slots, a query tile of 2 (1 for one query).  Each tile gets cpt =
// SMs / tiles CTAs over equal contiguous ranges of its units (selection-
// major, then group), so 139 selections at Q = 8 keep all 132 SMs busy where
// the core's plan left 62 idle.  A CTA stages its tile's tables in shared
// memory once, interleaved [m][K][QT] as it loads them (one 8-byte read
// serves both queries; 131 KB at K = 256), where the core launched an
// interleave kernel and streamed a 512 KB table through each CTA.  Tables
// that do not fit (u16 codes at K = 1024) are read through L2 by per-query
// 4-byte loads.  Each warp keeps 16 code words in flight, the next unit's
// included.  A round of 16 units ends with the scores (biases applied) in
// shared memory, and 128 * QT threads insert them into running top-2s in unit
// order, that is in ascending group order with strict '<'.  A selection cut
// by a range's end leaves a partial top-2 in scratch; the last CTA to finish
// it (an atomic counter per selection, behind a __threadfence) inserts the
// pieces in ascending piece order with strict '<', adc_merge's rule, and
// resets the counter to 0 for the next call.  No interleave and no merge
// launch remain: one launch before lane8_merge.
//
// Bounds on an H100 SXM at Q = 8, S = 139, M = 64, K = 256 (u8): 9.1 MB of
// codes (0.003 ms at 3.35 TB/s); 72.9 M lookups of 4 bytes at 128 B per clock
// per SM, 0.0087 ms.  The lookups bound K6: a warp's 8-byte reads of random
// entries took ~8 clocks each on the card (one conflict-free pass would take
// 2), so the rounds take ~35 us of its ~50; wider entries (more queries per
// tile) would conflict less but do not fit with the table resident.
//
// Exactness.  Every score is 0 + t_0 + ... + t_{M-1} in float32 with
// __fadd_rn, in that order, then (+ slot bias) + pad bias for K6, as the
// plain versions in annlite_torch/ops/ivf.py compute it: scores and rows are
// bit-equal to them.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookup.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxSmem = 232448;    // 227 KB: a block's shared memory limit
constexpr int kWarp = 32;

// ---------------------------------------------------------------- K7 ----

constexpr int kRowSlots = 2;              // slots per K7 thread
constexpr int kRowCta = kWarp * kRowSlots;  // slots per K7 CTA
constexpr int kRowM = 64;                 // code words a K7 thread holds at once
constexpr int kMaxChunks = 16;            // table chunks (mbarriers) of K7

// Two neighbouring codes of one subspace in one load.
template <typename CodeT>
struct Codes2;

template <>
struct Codes2<uint8_t> {
  static __device__ __forceinline__ uint32_t load(const uint8_t* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ uint32_t at(uint32_t w, int j) {
    return j ? (w >> 8) & 0xFFu : w & 0xFFu;
  }
};

template <>
struct Codes2<uint16_t> {
  static __device__ __forceinline__ uint32_t load(const uint16_t* p) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  static __device__ __forceinline__ uint32_t at(uint32_t w, int j) {
    return j ? w >> 16 : w & 0xFFFFu;
  }
};

struct RowsArgs {
  const int* block_ids;   // [n_sel], -1 = pad (scores block 0, as the reference)
  const float* dtable;    // [nq, m, k]
  const void* codes;      // [blocks, m, bs]
  float* out;             // [n_sel, nq, bs]
  int nq, m, k, bs;
  int mc, nchunks;        // shared table: subspaces per chunk, chunks
};

// blockIdx.x = j * (bs / 64) + slot chunk; thread t holds slots
// chunk * 64 + 2t and 2t + 1 of selection j, for all QN (= nq) queries.
template <typename CodeT, int QN, bool kSmemTab>
__global__ void __launch_bounds__(kWarp) ivf_rows_kernel(const RowsArgs a) {
  extern __shared__ __align__(16) float tab[];  // kSmemTab: [QN][m][k], then the mbarriers
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + (size_t)QN * a.m * a.k);
  const int per_sel = a.bs / kRowCta;
  const int j = blockIdx.x / per_sel;
  const int slot0 = (blockIdx.x % per_sel) * kRowCta + threadIdx.x * kRowSlots;
  if (kSmemTab) {
    if (threadIdx.x == 0) {
      for (int c = 0; c < a.nchunks; ++c) wg::mbar_init(&full[c], 1);
      wg::mbar_init_fence();
    }
    __syncthreads();  // the barriers are initialised before any copy
    if (threadIdx.x == 0) {
      for (int c = 0; c < a.nchunks; ++c) {
        const int m0 = c * a.mc;
        const uint32_t bytes = (uint32_t)(min(a.mc, a.m - m0) * a.k * sizeof(float));
        wg::mbar_expect_tx(&full[c], bytes * QN);
        for (int q = 0; q < QN; ++q) {
          const size_t at = ((size_t)q * a.m + m0) * a.k;
          wg::bulk_load(tab + at, a.dtable + at, bytes, &full[c]);
        }
      }
    }
  }
  const int blk = max(__ldg(a.block_ids + j), 0);
  const CodeT* cp = static_cast<const CodeT*>(a.codes) + (size_t)blk * a.m * a.bs + slot0;
  float acc[QN][kRowSlots];
#pragma unroll
  for (int q = 0; q < QN; ++q) {
#pragma unroll
    for (int r = 0; r < kRowSlots; ++r) acc[q][r] = 0.0f;
  }
  for (int m0 = 0; m0 < a.m; m0 += kRowM) {
    const int mn = min(kRowM, a.m - m0);
    uint32_t w[kRowM];  // every code word before the first lookup
#pragma unroll
    for (int i = 0; i < kRowM; ++i) {
      w[i] = i < mn ? Codes2<CodeT>::load(cp + (size_t)(m0 + i) * a.bs) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kRowM; ++i) {
      if (i < mn) {
        const int mm = m0 + i;
        if (kSmemTab && mm % a.mc == 0) wg::mbar_wait(&full[mm / a.mc], 0u);
#pragma unroll
        for (int r = 0; r < kRowSlots; ++r) {
          const uint32_t c = Codes2<CodeT>::at(w[i], r);
#pragma unroll
          for (int q = 0; q < QN; ++q) {
            const size_t at = ((size_t)q * a.m + mm) * a.k + c;
            acc[q][r] = __fadd_rn(acc[q][r], kSmemTab ? tab[at] : __ldg(a.dtable + at));
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < QN; ++q) {
    *reinterpret_cast<float2*>(a.out + ((size_t)j * a.nq + q) * a.bs + slot0) =
        make_float2(acc[q][0], acc[q][1]);
  }
}

// ---------------------------------------------------------------- K6 ----

constexpr int kTopThreads = 512;
constexpr int kTopWarps = kTopThreads / kWarp;  // units per round
constexpr int kLpt = 4;                         // slots (lanes) per thread: one code load
constexpr int kPre = 16;                        // code words in flight per thread
constexpr int kFlagBytes = 16;

struct Top2Args {
  const int* block_ids;   // [n_sel], -1 = pad
  const float* dtable;    // [nq, m, k]
  const void* codes;      // [blocks, m, bs]
  const int8_t* mask;     // [blocks, bs]
  float* s_out;           // [nq, n_sel * 256]
  int* r_out;
  float* part_s;          // [grid, 2, qt, 256]: partial top-2s of the range's end pieces
  int* part_g;
  unsigned* counters;     // [tiles * n_sel], 0 between calls
  int nq, m, k, bs, groups, n_sel;
  int sg;                 // units of a query tile: n_sel * groups
  int cpt;                // CTAs of a query tile; grid = tiles * cpt
};

// The first unit (within its tile) of the tile's CTA ci, and the CTA (within
// the tile) that holds unit u.
__device__ __forceinline__ int unit_lo(const Top2Args& a, int ci) {
  return (int)((long long)ci * a.sg / a.cpt);
}
__device__ __forceinline__ int unit_cta(const Top2Args& a, int u) {
  return (int)(((long long)(u + 1) * a.cpt - 1) / a.sg);
}

// The code pointer of this thread's slots in unit u (null past `end`), and
// its block id.
template <typename CodeT>
__device__ __forceinline__ const CodeT* unit_codes(const Top2Args& a, int u, int end, int lane0,
                                                   int* id) {
  if (u >= end) return nullptr;
  const int sel = u / a.groups;
  *id = __ldg(a.block_ids + sel);
  return static_cast<const CodeT*>(a.codes) + (size_t)max(*id, 0) * a.m * a.bs +
         (u - sel * a.groups) * kLanes + lane0;
}

template <typename CodeT>
__device__ __forceinline__ typename Codes4<CodeT>::Word fetch(const CodeT* p, int s, int m,
                                                              int bs) {
  return (p != nullptr && s < m) ? Codes4<CodeT>::load(p + (size_t)s * bs) : Codes4<CodeT>::zero();
}

// s_out/r_out of (query q, selection sel, lane): the reference's rows.
__device__ __forceinline__ void write_final(const Top2Args& a, int q, int sel, int lane, float m1,
                                            float m2, uint32_t g1, uint32_t g2) {
  const size_t o = (size_t)q * a.n_sel * 256 + (size_t)sel * 256 + lane;
  const int base = sel * a.bs + lane;
  a.s_out[o] = m1;
  a.s_out[o + kLanes] = m2;
  a.r_out[o] = base + (int)g1 * kLanes;
  a.r_out[o + kLanes] = base + min((int)g2, a.groups - 1) * kLanes;
}

// A reader's running top-2 of selection sel, at its last unit in this CTA's
// range [lo, hi): final where the range holds the whole selection, else the
// piece's partial (slot 0: the piece holds lo).
template <int QT>
__device__ __forceinline__ void flush(const Top2Args& a, int q, int sel, int lo, int hi, int rq,
                                      int rl, float mn1, float mn2, uint32_t gg) {
  if (q >= a.nq) return;
  const int first = sel * a.groups;
  if (first >= lo && first + a.groups <= hi) {
    write_final(a, q, sel, rl, mn1, mn2, gg & 0xFFFFu, gg >> 16);
  } else {
    const int slot = first <= lo ? 0 : 1;
    const size_t o = (((size_t)blockIdx.x * 2 + slot) * QT + rq) * 256 + rl;
    a.part_s[o] = mn1;
    a.part_s[o + kLanes] = mn2;
    a.part_g[o] = (int)(gg & 0xFFFFu);
    a.part_g[o + kLanes] = (int)(gg >> 16);
  }
}

// blockIdx.x = tile * cpt + ci: CTA ci of query tile `tile` runs the tile's
// units [unit_lo(ci), unit_lo(ci + 1)), unit u being group u % groups of
// selection u / groups; in each round warp w computes one unit.
template <typename CodeT, int QT, bool kSmemTab>
__global__ void __launch_bounds__(kTopThreads, 1) ivf_top2_kernel(const Top2Args a) {
  using C4 = Codes4<CodeT>;
  using Word = typename C4::Word;
  extern __shared__ __align__(16) float sm[];
  // the table rounded up to whole 16-byte units: the scores follow as float4
  const size_t tab_floats = kSmemTab ? ((size_t)a.m * a.k * QT + 3) / 4 * 4 : 0;
  float* tab = sm;                                   // [m][k][QT]
  float* stash = sm + tab_floats;                    // [warp][QT][128] scores of a round
  int* flags = reinterpret_cast<int*>(stash + kTopWarps * QT * kLanes);
  const int warp = threadIdx.x / kWarp;
  const int lane0 = (threadIdx.x % kWarp) * kLpt;
  const int tile = blockIdx.x / a.cpt;
  const int ci = blockIdx.x % a.cpt;
  const int lo = unit_lo(a, ci);
  const int hi = unit_lo(a, ci + 1);
  const int q0 = tile * QT;
  // the reader role of a round: (query of the tile, lane)
  const bool reader = threadIdx.x < QT * kLanes;
  const int rq = threadIdx.x / kLanes;
  const int rl = threadIdx.x % kLanes;
  const float inf = __int_as_float(0x7f800000);

  // the first unit's codes are in flight while the table lands
  int id = 0, id_next = 0;
  const CodeT* cp = unit_codes<CodeT>(a, lo + warp, hi, lane0, &id);
  Word w[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i) w[i] = fetch(cp, i, a.m, a.bs);
  if (kSmemTab) {  // the tile's tables, interleaved [m][k][QT] as they are loaded
    const size_t n = (size_t)a.m * a.k;
    const float* d0 = a.dtable + (size_t)q0 * n;
    const float* d1 = a.dtable + (size_t)min(q0 + 1, a.nq - 1) * n;
    if ((n & 3) == 0 && ((uintptr_t)a.dtable & 15) == 0) {
#pragma unroll 4
      for (int i = threadIdx.x; i < (int)(n / 4); i += kTopThreads) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(d0) + i);
        if (QT == 1) {
          reinterpret_cast<float4*>(tab)[i] = x;
        } else {  // a padded query's entries are never read into a result
          const float4 y = __ldg(reinterpret_cast<const float4*>(d1) + i);
          reinterpret_cast<float4*>(tab)[2 * i] = make_float4(x.x, y.x, x.y, y.y);
          reinterpret_cast<float4*>(tab)[2 * i + 1] = make_float4(x.z, y.z, x.w, y.w);
        }
      }
    } else {
#pragma unroll 4
      for (int i = threadIdx.x; i < (int)n; i += kTopThreads) {
        tab[(size_t)i * QT] = __ldg(d0 + i);
        if (QT == 2) tab[(size_t)i * QT + 1] = __ldg(d1 + i);
      }
    }
    __syncthreads();
  }
  // steps of a unit, a multiple of the ring: the next unit's words follow
  const int mp = (a.m + kPre - 1) / kPre * kPre;

  float mn1 = inf, mn2 = inf;
  uint32_t gg = 0;
  int open = -1;  // the selection of the running top-2
  for (int r0 = lo; r0 < hi; r0 += kTopWarps) {
    const int u = r0 + warp;
    if (u < hi) {
      const CodeT* cpn = unit_codes<CodeT>(a, u + kTopWarps, hi, lane0, &id_next);
      const int grp = u % a.groups;
      const int row0 = grp * kLanes + lane0;
      const uint32_t keep4 =
          __ldg(reinterpret_cast<const uint32_t*>(a.mask + (size_t)max(id, 0) * a.bs + row0));
      float acc[kLpt][QT];
#pragma unroll
      for (int j = 0; j < kLpt; ++j) {
#pragma unroll
        for (int p = 0; p < QT; ++p) acc[j][p] = 0.0f;
      }
      for (int m0 = 0; m0 < mp; m0 += kPre) {
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int mm = m0 + i;
          if (mm < a.m) {
#pragma unroll
            for (int j = 0; j < kLpt; ++j) {
              const uint32_t c = C4::at(w[i], j);
              if (kSmemTab) {
                // plain loads: the table is written once, before the barrier,
                // so the compiler may run them ahead of the additions
                if (QT == 2) {
                  const float2 e = reinterpret_cast<const float2*>(tab)[mm * a.k + (int)c];
                  acc[j][0] = __fadd_rn(acc[j][0], e.x);
                  acc[j][QT - 1] = __fadd_rn(acc[j][QT - 1], e.y);
                } else {
                  acc[j][0] = __fadd_rn(acc[j][0], tab[mm * a.k + (int)c]);
                }
              } else {
#pragma unroll
                for (int p = 0; p < QT; ++p) {
                  const int q = min(q0 + p, a.nq - 1);
                  acc[j][p] = __fadd_rn(acc[j][p],
                                        __ldg(a.dtable + ((size_t)q * a.m + mm) * a.k + c));
                }
              }
            }
          }
          // refill with the word kPre steps on, the next unit's past the end
          const int nx = mm + kPre;
          w[i] = nx < mp ? fetch(cp, nx, a.m, a.bs) : fetch(cpn, nx - mp, a.m, a.bs);
        }
      }
      // (acc + slot bias) + pad bias, the reference's order
      const float pad = id >= 0 ? 0.0f : kBig;
#pragma unroll
      for (int p = 0; p < QT; ++p) {
        float v[kLpt];
#pragma unroll
        for (int j = 0; j < kLpt; ++j) {
          const float bias = (int8_t)((keep4 >> (8 * j)) & 0xFFu) > 0 ? 0.0f : kBig;
          v[j] = __fadd_rn(__fadd_rn(acc[j][p], bias), pad);
        }
        *reinterpret_cast<float4*>(stash + (warp * QT + p) * kLanes + lane0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      cp = cpn;
      id = id_next;
    }
    __syncthreads();
    if (reader) {  // the round's units in order: ascending groups per selection
      const int rend = min(r0 + kTopWarps, hi);
      int sel = r0 / a.groups;
      int grp = r0 - sel * a.groups;
      for (int uu = r0; uu < rend; ++uu) {
        if (sel != open) {
          if (open >= 0) flush<QT>(a, q0 + rq, open, lo, hi, rq, rl, mn1, mn2, gg);
          open = sel;
          mn1 = inf;
          mn2 = inf;
          gg = 0;
        }
        top2_insert(stash[((uu - r0) * QT + rq) * kLanes + rl], (uint32_t)grp, mn1, mn2, gg);
        if (++grp == a.groups) {
          grp = 0;
          ++sel;
        }
      }
    }
    __syncthreads();
  }
  if (reader) flush<QT>(a, q0 + rq, open, lo, hi, rq, rl, mn1, mn2, gg);

  // pieces shared with the tile's other CTAs: the selections of the range's
  // first and last units, where the range cuts them
  const int s0 = lo / a.groups;
  const int s1 = (hi - 1) / a.groups;
  const bool part0 = s0 * a.groups < lo || (s0 == s1 && (s0 + 1) * a.groups > hi);
  const bool part1 = s1 != s0 && (s1 + 1) * a.groups > hi;
  if (!part0 && !part1) return;
  __threadfence();  // this CTA's partials are visible before its count
  __syncthreads();
  if (threadIdx.x % kWarp == 0 && threadIdx.x / kWarp < 2) {  // one thread a piece
    const int slot = threadIdx.x / kWarp;
    flags[slot] = 0;
    if (slot ? part1 : part0) {
      const int sel = slot ? s1 : s0;
      const int first = sel * a.groups;
      const int pieces = unit_cta(a, first + a.groups - 1) - unit_cta(a, first) + 1;
      unsigned* count = a.counters + (size_t)tile * a.n_sel + sel;
      if (atomicAdd(count, 1u) + 1 == (unsigned)pieces) {
        atomicExch(count, 0u);  // zero again for the next call
        flags[slot] = 1;
      }
      __threadfence();
    }
  }
  __syncthreads();
  const int q = q0 + rq;
  for (int slot = 0; slot < 2; ++slot) {
    if (!flags[slot] || !reader || q >= a.nq) continue;
    // the last piece is in: insert the pieces in ascending order
    const int sel = slot ? s1 : s0;
    const int first = sel * a.groups;
    const int c0 = unit_cta(a, first);
    const int c1 = unit_cta(a, first + a.groups - 1);
    float m1 = inf, m2 = inf;
    int g1 = 0, g2 = 0;
    for (int c = c0; c <= c1; ++c) {
      const int ps = unit_lo(a, c) >= first ? 0 : 1;  // c's piece holds its lo: slot 0
      const size_t o = ((((size_t)tile * a.cpt + c) * 2 + ps) * QT + rq) * 256 + rl;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = __ldcg(a.part_s + o + h * kLanes);
        const int g = __ldcg(a.part_g + o + h * kLanes);
        if (c == c0) {
          if (h == 0) {
            m1 = v;
            g1 = g;
          } else {
            m2 = v;
            g2 = g;
          }
        } else if (v < m1) {
          m2 = m1;
          g2 = g1;
          m1 = v;
          g1 = g;
        } else if (v < m2) {
          m2 = v;
          g2 = g;
        }
      }
    }
    write_final(a, q, sel, rl, m1, m2, (uint32_t)g1, (uint32_t)g2);
  }
}

// ----- host side -----

// Above 48 KB of dynamic shared memory a kernel must opt in; `opted` keeps
// the most it was allowed so far.
template <typename K>
int opt_in(K kernel, size_t smem, size_t* opted) {
  if (smem <= *opted) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *opted = smem;
  return (int)e;
}

template <typename CodeT, int QN, bool S>
int launch_rows(const RowsArgs& a, int grid, size_t smem, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const int err = opt_in(ivf_rows_kernel<CodeT, QN, S>, smem, &opted);
  if (err != 0) return err;
  ivf_rows_kernel<CodeT, QN, S><<<grid, kWarp, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename CodeT>
int rows_code(const RowsArgs& a, bool smem_tab, int grid, size_t smem, cudaStream_t st) {
  if (a.nq == 1) {
    return smem_tab ? launch_rows<CodeT, 1, true>(a, grid, smem, st)
                    : launch_rows<CodeT, 1, false>(a, grid, smem, st);
  }
  return smem_tab ? launch_rows<CodeT, 2, true>(a, grid, smem, st)
                  : launch_rows<CodeT, 2, false>(a, grid, smem, st);
}

template <typename CodeT, int QT, bool S>
int launch_top2(const Top2Args& a, int grid, size_t smem, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const int err = opt_in(ivf_top2_kernel<CodeT, QT, S>, smem, &opted);
  if (err != 0) return err;
  ivf_top2_kernel<CodeT, QT, S><<<grid, kTopThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename CodeT>
int top2_code(const Top2Args& a, int qt, bool smem_tab, int grid, size_t smem, cudaStream_t st) {
  if (qt == 1) {
    return smem_tab ? launch_top2<CodeT, 1, true>(a, grid, smem, st)
                    : launch_top2<CodeT, 1, false>(a, grid, smem, st);
  }
  return smem_tab ? launch_top2<CodeT, 2, true>(a, grid, smem, st)
                  : launch_top2<CodeT, 2, false>(a, grid, smem, st);
}

template <typename CodeT>
cudaError_t attributes(int kernel, int q, bool s, cudaFuncAttributes* fa) {
  if (kernel == 0) {
    if (q == 1) {
      return s ? cudaFuncGetAttributes(fa, ivf_rows_kernel<CodeT, 1, true>)
               : cudaFuncGetAttributes(fa, ivf_rows_kernel<CodeT, 1, false>);
    }
    return s ? cudaFuncGetAttributes(fa, ivf_rows_kernel<CodeT, 2, true>)
             : cudaFuncGetAttributes(fa, ivf_rows_kernel<CodeT, 2, false>);
  }
  if (q == 1) {
    return s ? cudaFuncGetAttributes(fa, ivf_top2_kernel<CodeT, 1, true>)
             : cudaFuncGetAttributes(fa, ivf_top2_kernel<CodeT, 1, false>);
  }
  return s ? cudaFuncGetAttributes(fa, ivf_top2_kernel<CodeT, 2, true>)
           : cudaFuncGetAttributes(fa, ivf_top2_kernel<CodeT, 2, false>);
}

bool aligned(const void* p, uintptr_t to) { return (uintptr_t)p % to == 0; }

}  // namespace

extern "C" {

// Each entry point checks its geometry, launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take; the
// wrappers in ops/ivf.py check the same and raise with the reason first).
// code_bytes is 1 (u8 codes) or 2 (u16).

// K7 for nq <= 2: out[j, q, slot] for the blocks block_ids[j] (a pad -1
// scores block 0).  smem_tab stages the table in chunks of mc subspaces
// (k % 4 == 0, dtable 16-byte aligned, nq * m * k floats and 16 mbarriers
// within 227 KB).
int annlite_ivf_rows(const void* block_ids, const void* dtable, const void* codes, void* out,
                     int n_sel, int nq, int m, int k, int bs, int code_bytes, int smem_tab, int mc,
                     void* stream) {
  RowsArgs a{};
  a.block_ids = (const int*)block_ids;
  a.dtable = (const float*)dtable;
  a.codes = codes;
  a.out = (float*)out;
  a.nq = nq;
  a.m = m;
  a.k = k;
  a.bs = bs;
  a.mc = mc;
  a.nchunks = mc > 0 ? (m + mc - 1) / mc : 0;
  const size_t smem = smem_tab ? (size_t)nq * m * k * sizeof(float) + kMaxChunks * 8 : 0;
  const long long grid = (long long)n_sel * (bs / kRowCta);
  if (n_sel < 1 || (nq != 1 && nq != 2) || m < 1 || k < 1 || bs < kLanes || bs % kLanes != 0 ||
      grid >= (1ll << 31) || (code_bytes != 1 && code_bytes != 2) ||
      !aligned(codes, 2 * code_bytes) || !aligned(out, 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_tab && (k % 4 != 0 || !aligned(dtable, 16) || smem > (size_t)kMaxSmem || mc < 1 ||
                   a.nchunks > kMaxChunks)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return code_bytes == 1 ? rows_code<uint8_t>(a, smem_tab, (int)grid, smem, st)
                         : rows_code<uint16_t>(a, smem_tab, (int)grid, smem, st);
}

// K6's block pass: s_out/r_out [nq, n_sel * 256], rows as j * bs + slot;
// qt (1 or 2) queries a tile, cpt CTAs a tile, each over a contiguous range
// of the tile's n_sel * (bs / 128) units; part_s/part_g [tiles * cpt, 2, qt,
// 256] scratch; counters [tiles * n_sel] zero (and zero again after the
// launch).  smem_tab stages each tile's table in shared memory (m * k * qt
// floats beside a round's scores), else it is read through L2.
int annlite_ivf_top2(const void* block_ids, const void* dtable, const void* codes,
                     const void* mask, void* s_out, void* r_out, void* part_s, void* part_g,
                     void* counters, int n_sel, int nq, int m, int k, int bs, int code_bytes,
                     int qt, int smem_tab, int cpt, void* stream) {
  Top2Args a{};
  a.block_ids = (const int*)block_ids;
  a.dtable = (const float*)dtable;
  a.codes = codes;
  a.mask = (const int8_t*)mask;
  a.s_out = (float*)s_out;
  a.r_out = (int*)r_out;
  a.part_s = (float*)part_s;
  a.part_g = (int*)part_g;
  a.counters = (unsigned*)counters;
  a.nq = nq;
  a.m = m;
  a.k = k;
  a.bs = bs;
  a.groups = bs / kLanes;
  a.n_sel = n_sel;
  a.sg = n_sel * a.groups;
  a.cpt = cpt;
  const long long tiles = qt > 0 ? (nq + qt - 1) / qt : 0;
  const long long grid = tiles * cpt;
  const size_t smem = (smem_tab ? ((size_t)m * k * qt + 3) / 4 * 4 * sizeof(float) : 0) +
                      (size_t)kTopWarps * qt * kLanes * sizeof(float) + kFlagBytes;
  if (n_sel < 1 || nq < 1 || (qt != 1 && qt != 2) || m < 1 || k < 1 || bs < kLanes ||
      bs % kLanes != 0 || a.groups > 0xFFFF || (long long)n_sel * bs >= (1ll << 31) ||
      tiles * n_sel >= (1ll << 31) || cpt < 1 || cpt > a.sg || grid >= (1ll << 31) ||
      (long long)m * k >= (1ll << 31) || (code_bytes != 1 && code_bytes != 2) ||
      !aligned(codes, 4 * code_bytes) || !aligned(mask, 4) || smem > (size_t)kMaxSmem ||
      part_s == nullptr || part_g == nullptr || counters == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return code_bytes == 1 ? top2_code<uint8_t>(a, qt, smem_tab, (int)grid, smem, st)
                         : top2_code<uint16_t>(a, qt, smem_tab, (int)grid, smem, st);
}

// The instantiation of kernel (0 K7's rows, 1 K6's top-2) for code_bytes,
// q (K7: queries, K6: query tile; 1 or 2) and smem_tab: out = {registers
// per thread, local (spill) bytes per thread}.
int annlite_ivf_info(int kernel, int code_bytes, int q, int smem_tab, int* out) {
  if ((kernel != 0 && kernel != 1) || (code_bytes != 1 && code_bytes != 2) || (q != 1 && q != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes fa;
  const cudaError_t e = code_bytes == 1 ? attributes<uint8_t>(kernel, q, smem_tab != 0, &fa)
                                        : attributes<uint16_t>(kernel, q, smem_tab != 0, &fa);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return 0;
}

}  // extern "C"
