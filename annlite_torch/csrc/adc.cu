// ADC (asymmetric distance computation) scans for Hopper (sm_90a).
//
// Replaces four Pallas kernels of the JAX package, which share one body, the
// table-lookup sum  score[q, n] = sum_m dtable[q, m, codes[m, n]]:
//   * annlite_tpu/ops/adc.py:67  _adc_kernel   (K5) -> EPI kScores: the full
//     [Q, N] score matrix, BIG where the mask is 0;
//   * annlite_tpu/ops/adc.py:169 _adc_kernel8  (K4) -> EPI kBlockTop2, then
//     lane8_merge (csrc/fused_scan.cu): per block of rows the best two of
//     each (query, row mod 128) bucket, then a running top-8 per lane class;
//   * annlite_tpu/ops/ivf.py:31  _ivf_kernel   (K7) -> EPI kIvfScores: the
//     probed code blocks named by a device array of block ids, [S, Q, BS];
//   * annlite_tpu/ops/ivf.py:78  _ivf_kernel8  (K6) -> EPI kIvfTop2, then
//     lane8_merge: K7's scores plus the slot-mask bias and BIG for pad
//     selections, bucketed top-2 with provenance j * BS + slot.
// K6 and K7 run here only where ops/ivf.py ivf_plan gives them the core;
// csrc/ivf.cu has their bodies for few queries over few blocks.
// The TPU kernels turn the lookup into a one-hot matrix product with a bf16
// table, a device for the TPU's matrix unit.  Here the lookup stays a lookup
// into float32 tables in shared memory; the four epilogues share one core.
//
// Bounds on an H100 SXM at Q = 64, N = 2^20, M = 64, K = 256 (u8): the codes
// are 64 MB (0.02 ms at 3.35 TB/s), the Q*N*M = 4.3e9 additions take 0.064
// ms at 67 TFLOP/s, but each addition first reads its table entry from
// shared memory at an address the code picks: 17.2 GB of 4-byte lookups at
// 128 B per clock per SM (132 SMs, 33.4 TB/s at 1.98 GHz) take ~0.51 ms.
// That lookup floor is the bound no design that reads one float32 entry per
// (query, row, subspace) can beat; a half- or 4-bit table would change the
// scores.
//
// What the design does about what held the first version back:
//   1. A query tile per CTA.  A CTA holds QT queries (1 to 32, planned in
//      Python, ops/adc.py adc_plan; 32 on the PQ path at batch 64) and every
//      code it loads serves all of them, so the codes cross L2 ceil(Q / QT)
//      times instead of Q times.
//   2. A table layout that serves several queries per shared-memory read.
//      A small kernel first interleaves the tile's tables in global memory as
//      [tile][m][kp][QT] floats (kp = K rounded up to 4), so one code's
//      entries for the QT queries are contiguous.  A thread holds two
//      queries of the tile and reads both entries with one 8-byte LDS; the
//      QT/2 threads that share a row read neighbouring words of one entry.
//      Bank conflicts then arise only between the rows of one phase: at
//      QT = 16 a half-warp reads two random 64-byte entries (1.5 passes on
//      average), where the first version's warp read 32 random words (about
//      3.5 passes); at QT = 32 a half-warp reads one row's whole 128-byte
//      entry, all 32 banks once.  At QT = 1 the layout is the table's own
//      [Q][m][K] (K % 4 == 0): the core reads it in place and nothing is
//      interleaved.
//   3. Wide code loads.  A thread owns 4 neighbouring lanes (rows) and reads
//      their codes for one subspace as one 32-bit (u8) or 64-bit (u16) load;
//      no 1-byte load per (row, subspace) remains.  A lookup's shared
//      address is one byte permute and one shifted add (LEA) from the code.
//   4. The tables reach shared memory by cp.async.bulk (TMA) into a ring of
//      buffers of mc subspaces, completing on mbarriers.  When the tile's
//      whole table fits (QT <= 2 at K = 256) it is staged once and stays.
//      Otherwise the CTA holds the accumulators of kG groups of its lanes in
//      registers while the chunks stream through the ring, then starts again
//      for the next kG groups, so staging costs K / (rows in flight) of the
//      lookups: 25% at QT = 16, kG = 4 and 512 threads.  No barrier of the
//      CTA stops the stream: the last warp done with a buffer refills it,
//      and a warp waits only for a chunk that has not arrived.  Below
//      QT = 16, kG = 4 is the most that fits 128 registers beside the
//      prefetched codes (ptxas fails on kG = 8; kG = 6, or 256 threads with
//      kG = 8 to 16, ran slower: the loop needs its 16 warps per SM to hide
//      the lookups' latency).
//   5. The staged tiles (QT = 16 and the wide tile, 32) bring their codes
//      through the ring too.  Each use of a slot holds, beside the table
//      chunk, the codes of the CTA's rows in flight for the chunk's
//      subspaces (one bulk copy per subspace and row block), and the lookup
//      loop reads them from shared memory: no global load, and no latency of
//      one, is left in the loop.  Loading the codes from global memory cost
//      the QT = 16 core 0.34 of its 1.36 ms at Q 64, N 2^20, M 64 (a copy
//      that made its codes up in registers ran 1.02 ms); bank conflicts
//      0.12 ms (codes that put a half-warp's two rows in opposite bank
//      halves), the table's restaging 0.06 ms (a copy that never refilled).
//      With no codes prefetched into registers, a pass holds kG = 8 groups
//      (1,024 rows in flight at QT = 32, 2,048 at QT = 16: the table's bytes
//      restaged are 25% and 12.5% of the lookups'), and the lookups of two
//      groups are issued before their additions.  Smaller tiles keep their
//      codes in global memory and their table resident where it fits (one
//      or two queries; K7 and K6 on the core below 16 queries).
// Filling the card: a CTA holds nbc row blocks; while the grid stays within
// one wave, the host splits each block's groups over more CTAs, and
// adc_merge inserts the splits' partial top-2s in ascending order with
// strict '<' (the lower-group split wins a tie), exactly the sequential
// result.  No finer "blocks" are emitted: lane8_merge's answer stays.
//
// Exactness.  Every score is 0 + t_0 + t_1 + ... + t_{M-1} in float32 with
// __fadd_rn, in that order, as the plain versions in annlite_torch/ops/adc.py
// and ivf.py compute it: the scores are bit-equal to them.  Chunks run in
// ascending m and never reorder an accumulator's sum.  Selection is
// sequential in ascending group order with strict '<', the rule of
// _bucket_top2 (lowest group wins a tie; the second group is clamped to
// groups - 1); g1 and g2 share one register (16 bits each).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookup.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kLpt = 4;              // lanes per thread: one wide code load
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;     // 227 KB: a block's shared memory limit
constexpr int kMaxBuf = 4;           // ring buffers
constexpr int kBarBytes = 64;        // after the ring: kMaxBuf mbarriers and counters

enum Epi { kScores = 0, kBlockTop2 = 1, kIvfScores = 2, kIvfTop2 = 3 };

struct Args {
  const float* tab;        // interleaved tables [tiles, m, kp, qt]
  const void* codes;       // dense: [m, ld]; ivf: [blocks, m, bn]
  const int8_t* mask;      // dense: [n]; ivf: [blocks, bn]
  const int* block_ids;    // ivf: [n_rb], -1 = pad
  float* s_out;            // see the epilogues
  int* r_out;
  float* part_s;           // top-2 with splits > 1: [splits, nq, n_rb * 256]
  int* part_g;
  int nq, m, kp;
  int n;                   // dense: valid rows; ivf: unused
  int ld;                  // dense: row stride of codes_t (a multiple of 4)
  int bn;                  // rows per row block (ivf: the block size)
  int n_rb;                // row blocks (ivf: selections)
  int groups;              // bn / 128
  // the launch plan (ops/adc.py adc_plan)
  int qt, tiles, nbc, splits, gps, mc, nbuf, nchunks;
  int nrbg;                // CTAs per (tile, split): row-block groups
  uint32_t tab_bytes;      // a ring slot's table chunk: mc * kp * qt floats
  uint32_t slot_bytes;     // a slot: the table chunk, then (staged tiles) its codes
};

// Queries per thread (one 4- or 8-byte LDS), threads per lane quad, and the
// groups of a pass; tiles from 16 queries stage their codes in the ring
// (point 5).
template <int QT>
struct Tile {
  static constexpr int kQpt = QT == 1 ? 1 : 2;
  static constexpr int kTq = QT / kQpt;
  // log2 of a table entry's bytes (QT floats)
  static constexpr int kShift =
      QT == 1 ? 2 : QT == 2 ? 3 : QT == 4 ? 4 : QT == 8 ? 5 : QT == 16 ? 6 : 7;
  static constexpr bool kStaged = QT >= 16;
  // groups per pass: kG * 4 * QPT accumulators
  static constexpr int kG = kStaged ? 8 : 4;
};

bool valid_tile(int qt) {
  return qt == 1 || qt == 2 || qt == 4 || qt == 8 || qt == 16 || qt == 32;
}
int threads_per_block(int qt) { return 32 * (qt == 1 ? 1 : qt / 2); }
bool staged(int qt) { return qt >= 16; }
int groups_per_pass(int qt) { return staged(qt) ? 8 : 4; }

// acc[p] += the QPT floats at shared address `addr`, in order.  Volatile: the
// reads stay after the mbarrier wait that makes the chunk visible.
template <int QPT>
__device__ __forceinline__ void lookup_add(uint32_t addr, float (&acc)[QPT]) {
  if constexpr (QPT == 2) {
    float x, y;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x), "=f"(y) : "r"(addr));
    acc[0] = __fadd_rn(acc[0], x);
    acc[1] = __fadd_rn(acc[1], y);
  } else {
    float x;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
    acc[0] = __fadd_rn(acc[0], x);
  }
}

// The QPT floats at shared address `addr`, without adding them.
template <int QPT>
__device__ __forceinline__ void lookup(uint32_t addr, float (&x)[QPT]) {
  if constexpr (QPT == 2) {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x[0]), "=f"(x[1]) : "r"(addr));
  } else {
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[0]) : "r"(addr));
  }
}

// Four codes of one subspace staged in shared memory (staged tiles).
__device__ __forceinline__ uint32_t code_word(uint32_t addr, uint8_t) {
  uint32_t w;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(w) : "r"(addr));
  return w;
}
__device__ __forceinline__ uint2 code_word(uint32_t addr, uint16_t) {
  uint2 w;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(w.x), "=r"(w.y) : "r"(addr));
  return w;
}

// The codes a staged tile brings for row block rbi of CTA group rbg in the pass
// of groups [gp, gp + kG): their first code within a subspace (`first`; add
// the subspace's offset) and their count, 0 where the block is inactive.
template <bool kIvf>
__device__ __forceinline__ int pass_codes(const Args& a, int rbg, int rbi, int gp, int g_hi,
                                          int kG, size_t* first) {
  const int rb = rbg * a.nbc + rbi;
  if (rb >= a.n_rb) return 0;
  const int ng = min(kG, g_hi - gp);
  if (kIvf) {
    const int blk = max(a.block_ids[rb], 0);  // a pad selection scores block 0
    *first = (size_t)blk * a.m * a.bn + (size_t)gp * kLanes;
    return ng * kLanes;
  }
  const size_t start = (size_t)rb * a.bn + (size_t)gp * kLanes;
  if (start >= (size_t)a.ld) return 0;
  *first = start;
  return (int)min((size_t)ng * kLanes, (size_t)a.ld - start);  // dense codes end at ld
}

// Use s of the stream into ring slot s % nbuf, completing on that slot's
// barrier: chunk s % nchunks of the tile's table and, for a staged tile, the
// codes of pass s / nchunks for the chunk's subspaces, [subspace][row block]
// [group][lane] (kG * 128 codes a row block).  Issued by one thread.
template <typename CodeT, bool kIvf, int QT>
__device__ void fill(const Args& a, unsigned char* ring, uint64_t* full, int tile, int rbg,
                     int g_lo, int g_hi, int s) {
  constexpr int kG = Tile<QT>::kG;
  const int c = s % a.nchunks;
  const int b = s % a.nbuf;
  const int m0 = c * a.mc;
  const int mcur = min(a.mc, a.m - m0);
  const size_t per_m = (size_t)a.kp * QT;
  const uint32_t tbytes = (uint32_t)(mcur * per_m * sizeof(float));
  unsigned char* slot = ring + (size_t)b * a.slot_bytes;
  const float* src = a.tab + ((size_t)tile * a.m + m0) * per_m;
  if constexpr (!Tile<QT>::kStaged) {
    wg::mbar_expect_tx(&full[b], tbytes);
    wg::bulk_load(slot, src, tbytes, &full[b]);
  } else {
    const int gp = g_lo + (s / a.nchunks) * kG;
    uint32_t cbytes = 0;
    for (int r = 0; r < a.nbc; ++r) {
      size_t first;
      cbytes += (uint32_t)(pass_codes<kIvf>(a, rbg, r, gp, g_hi, kG, &first) * sizeof(CodeT));
    }
    wg::mbar_expect_tx(&full[b], tbytes + cbytes * mcur);
    wg::bulk_load(slot, src, tbytes, &full[b]);
    const CodeT* codes = static_cast<const CodeT*>(a.codes);
    CodeT* dst = reinterpret_cast<CodeT*>(slot + a.tab_bytes);
    for (int r = 0; r < a.nbc; ++r) {
      size_t first;
      const int cnt = pass_codes<kIvf>(a, rbg, r, gp, g_hi, kG, &first);
      if (cnt == 0) continue;
      for (int mm = 0; mm < mcur; ++mm) {
        wg::bulk_load(dst + ((size_t)mm * a.nbc + r) * kG * kLanes,
                      codes + first + (size_t)(m0 + mm) * (kIvf ? a.bn : a.ld),
                      (uint32_t)(cnt * sizeof(CodeT)), &full[b]);
      }
    }
  }
}

// blockIdx.x = (tile * splits + split) * nrbg + row-block group.  Thread t
// holds queries tile * QT + (t % TQ) * QPT (+1) and the 4 lanes from
// ((t / TQ) % 32) * 4 of row block (t / TQ) / 32 of its CTA's group.
template <typename CodeT, int EPI, int QT>
__global__ void __launch_bounds__(kMaxThreads, 1) adc_kernel(const Args a) {
  using C4 = Codes4<CodeT>;
  constexpr int QPT = Tile<QT>::kQpt;
  constexpr int TQ = Tile<QT>::kTq;
  constexpr int kG = Tile<QT>::kG;
  constexpr bool kStaged = Tile<QT>::kStaged;
  constexpr bool kIvf = EPI == kIvfScores || EPI == kIvfTop2;
  constexpr bool kTop2 = EPI == kBlockTop2 || EPI == kIvfTop2;
  extern __shared__ __align__(16) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)a.nbuf * a.slot_bytes);
  uint32_t* done = reinterpret_cast<uint32_t*>(full + kMaxBuf);  // warps past each buffer
  const uint32_t nwarps = blockDim.x / 32;

  const int rbg = blockIdx.x % a.nrbg;
  const int ts = blockIdx.x / a.nrbg;
  const int split = ts % a.splits;
  const int tile = ts / a.splits;
  const int lq = threadIdx.x / TQ;
  const int rbi = lq / 32;  // row block within the CTA
  const int rb = rbg * a.nbc + rbi;
  const int lane0 = (lq % 32) * kLpt;
  const int q0 = tile * QT + (threadIdx.x % TQ) * QPT;
  const bool active = rb < a.n_rb;
  const int g_lo = split * a.gps;
  const int g_hi = g_lo + a.gps;

  // where this row block's codes start and the stride between subspaces
  const CodeT* codes = static_cast<const CodeT*>(a.codes);
  size_t cbase;
  size_t ld;
  int blk = 0;
  bool valid = true;
  if (kIvf) {
    const int id = active ? a.block_ids[rb] : 0;
    valid = id >= 0;
    blk = max(id, 0);  // a pad selection scores block 0, as the reference
    cbase = (size_t)blk * a.m * a.bn;
    ld = (size_t)a.bn;
  } else {
    cbase = (size_t)rb * a.bn;
    ld = (size_t)a.ld;
  }
  cbase += lane0;

  // a staged tile's slots change codes every pass: it never keeps its table
  const bool resident = !kStaged && a.nchunks <= a.nbuf;
  const int passes = (a.gps + kG - 1) / kG;
  const int total = resident ? a.nchunks : passes * a.nchunks;
  if (threadIdx.x == 0) {
    for (int b = 0; b < a.nbuf; ++b) {
      wg::mbar_init(&full[b], 1);
      done[b] = 0;
    }
    wg::mbar_init_fence();
  }
  __syncthreads();  // the barriers are initialised before any copy
  if (threadIdx.x == 0) {
    for (int s = 0; s < min(a.nbuf, total); ++s) {
      fill<CodeT, kIvf, QT>(a, ring, full, tile, rbg, g_lo, g_hi, s);
    }
  }

  float mn1[kLpt][QPT], mn2[kLpt][QPT];
  uint32_t gg[kLpt][QPT];
#pragma unroll
  for (int j = 0; j < kLpt; ++j) {
#pragma unroll
    for (int p = 0; p < QPT; ++p) {
      mn1[j][p] = __int_as_float(0x7f800000);  // +inf
      mn2[j][p] = __int_as_float(0x7f800000);
      gg[j][p] = 0u;
    }
  }

  const uint32_t m_bytes = (uint32_t)((size_t)a.kp * QT * sizeof(float));
  const uint32_t ring0 = wg::smem_u32(ring);
  int s = 0;
  for (int gp = g_lo; gp < g_hi; gp += kG) {
    bool ok[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int grp = gp + g;
      ok[g] = active && grp < g_hi;
      // dense codes end at ld (a multiple of 4): rows [n, ld) are padding
      if (!kIvf) ok[g] = ok[g] && (size_t)rb * a.bn + (size_t)grp * kLanes + lane0 < ld;
    }
    float acc[kG][kLpt][QPT];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int j = 0; j < kLpt; ++j) {
#pragma unroll
        for (int p = 0; p < QPT; ++p) acc[g][j][p] = 0.0f;
      }
    }

    for (int c = 0; c < a.nchunks; ++c, ++s) {
      const int b = s % a.nbuf;
      wg::mbar_wait(&full[b], resident ? 0u : (uint32_t)((s / a.nbuf) & 1));
      const int m0 = c * a.mc;
      const int mcur = min(a.mc, a.m - m0);
      // this thread's queries in slot b; entry c of subspace mm at
      // + (mm * kp + c) * QT floats
      const uint32_t tb = ring0 + b * a.slot_bytes + (threadIdx.x % TQ) * QPT * sizeof(float);
      if constexpr (kStaged) {
        // the codes of lane0 in slot b: + ((mm * nbc + rbi) * kG + g) * 128 codes
        const uint32_t cw = ring0 + b * a.slot_bytes + a.tab_bytes +
                            (uint32_t)((rbi * kG * kLanes + lane0) * sizeof(CodeT));
        const uint32_t cm_bytes = (uint32_t)(a.nbc * kG * kLanes * sizeof(CodeT));
        // not unrolled: unrolled by 3, nvcc 12.8 ran a short last chunk for
        // 3 subspaces (wrong scores where m % 3 != 0); by 2 it ran slower
#pragma unroll 1
        for (int mm = 0; mm < mcur; ++mm) {
          typename C4::Word w[kG];
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            w[g] = ok[g] ? code_word(cw + mm * cm_bytes + g * kLanes * sizeof(CodeT), CodeT{})
                         : C4::zero();
          }
          const uint32_t t = tb + mm * m_bytes;
          // the lookups of two groups in flight before their additions
#pragma unroll
          for (int h = 0; h < kG; h += 2) {
            float x[2][kLpt][QPT];
#pragma unroll
            for (int gi = 0; gi < 2; ++gi) {
#pragma unroll
              for (int j = 0; j < kLpt; ++j) {
                lookup<QPT>(t + (C4::at(w[h + gi], j) << Tile<QT>::kShift), x[gi][j]);
              }
            }
#pragma unroll
            for (int gi = 0; gi < 2; ++gi) {
#pragma unroll
              for (int j = 0; j < kLpt; ++j) {
#pragma unroll
                for (int p = 0; p < QPT; ++p) {
                  acc[h + gi][j][p] = __fadd_rn(acc[h + gi][j][p], x[gi][j][p]);
                }
              }
            }
          }
        }
      } else {
        const CodeT* cp = codes + cbase + (size_t)m0 * ld + (size_t)gp * kLanes;
#pragma unroll 2
        for (int mm = 0; mm < mcur; ++mm) {
          typename C4::Word w[kG];
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            w[g] = ok[g] ? C4::load(cp + (size_t)mm * ld + g * kLanes) : C4::zero();
          }
          const uint32_t t = tb + mm * m_bytes;
#pragma unroll
          for (int g = 0; g < kG; ++g) {
#pragma unroll
            for (int j = 0; j < kLpt; ++j) {
              lookup_add<QPT>(t + (C4::at(w[g], j) << Tile<QT>::kShift), acc[g][j]);
            }
          }
        }
      }
      if (!resident) {
        // the last warp done with slot b refills it; no warp waits for the
        // others except on a chunk that has not arrived
        __syncwarp();
        if (threadIdx.x % 32 == 0) {
          __threadfence_block();
          if ((atomicAdd(&done[b], 1u) + 1) % nwarps == 0 && s + a.nbuf < total) {
            fill<CodeT, kIvf, QT>(a, ring, full, tile, rbg, g_lo, g_hi, s + a.nbuf);
          }
        }
      }
    }

    // epilogue of this pass's groups
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (!ok[g]) continue;
      const int grp = gp + g;
      const int row0 = grp * kLanes + lane0;  // lane0's row within the row block
      uint32_t keep4 = 0;  // the mask bytes of the 4 lanes
      if (EPI == kScores || EPI == kBlockTop2) {
        keep4 = __ldg(reinterpret_cast<const uint32_t*>(a.mask + (size_t)rb * a.bn + row0));
      } else if (EPI == kIvfTop2) {
        keep4 = __ldg(reinterpret_cast<const uint32_t*>(a.mask + (size_t)blk * a.bn + row0));
      }
#pragma unroll
      for (int p = 0; p < QPT; ++p) {
        const int q = q0 + p;
        if (q >= a.nq) continue;
        float v[kLpt];
#pragma unroll
        for (int j = 0; j < kLpt; ++j) {
          const bool keep = (int8_t)((keep4 >> (8 * j)) & 0xFF) > 0;
          v[j] = acc[g][j][p];
          if (EPI == kScores) {
            v[j] = keep ? v[j] : kBig;
          } else if (EPI == kBlockTop2) {
            top2_insert(keep ? v[j] : kBig, grp, mn1[j][p], mn2[j][p], gg[j][p]);
          } else if (EPI == kIvfTop2) {  // (acc + slot bias) + pad bias, the reference's order
            const float bias = keep ? 0.0f : kBig;
            const float pad = valid ? 0.0f : kBig;
            top2_insert(__fadd_rn(__fadd_rn(v[j], bias), pad), grp, mn1[j][p], mn2[j][p],
                        gg[j][p]);
          }
        }
        if (EPI == kScores) {
          const size_t grow = (size_t)rb * a.bn + row0;
          float* o = a.s_out + (size_t)q * a.n + grow;
          if ((a.n & 3) == 0 && grow + kLpt <= (size_t)a.n) {
            *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int j = 0; j < kLpt; ++j) {
              if (grow + j < (size_t)a.n) o[j] = v[j];
            }
          }
        } else if (EPI == kIvfScores) {
          *reinterpret_cast<float4*>(a.s_out + ((size_t)rb * a.nq + q) * a.bn + row0) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }

  if (kTop2 && active) {
#pragma unroll
    for (int j = 0; j < kLpt; ++j) {
#pragma unroll
      for (int p = 0; p < QPT; ++p) {
        const int q = q0 + p;
        if (q >= a.nq) continue;
        const int lane = lane0 + j;
        const int g1 = (int)(gg[j][p] & 0xFFFFu);
        const int g2 = (int)(gg[j][p] >> 16);
        if (a.splits == 1) {
          const size_t o = (size_t)q * a.n_rb * 256 + (size_t)rb * 256 + lane;
          const int base = rb * a.bn + lane;  // global row (K4) or provenance j * BS (K6)
          a.s_out[o] = mn1[j][p];
          a.s_out[o + kLanes] = mn2[j][p];
          a.r_out[o] = base + g1 * kLanes;
          a.r_out[o + kLanes] = base + min(g2, a.groups - 1) * kLanes;
        } else {
          const size_t o = ((size_t)split * a.nq + q) * a.n_rb * 256 + (size_t)rb * 256 + lane;
          a.part_s[o] = mn1[j][p];
          a.part_s[o + kLanes] = mn2[j][p];
          a.part_g[o] = g1;
          a.part_g[o + kLanes] = g2;
        }
      }
    }
  }
}

// One thread per (query, row block, lane): the splits' partial top-2s in
// ascending split order, each split's (mn1, g1) then (mn2, g2) inserted with
// strict '<'.  A partial's +inf entries (a split with fewer than two finite
// scores) never enter, so their groups do not matter.
__global__ void __launch_bounds__(kLanes)
adc_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_g,
                 float* __restrict__ s_out, int* __restrict__ r_out, int nq, int n_rb,
                 int splits, int groups, int bn) {
  const int q = blockIdx.x;
  const int rb = blockIdx.y;
  const int lane = threadIdx.x;
  const size_t width = (size_t)n_rb * 256;
  const size_t o = (size_t)q * width + (size_t)rb * 256 + lane;
  float m1 = part_s[o], m2 = part_s[o + kLanes];
  int g1 = part_g[o], g2 = part_g[o + kLanes];
  for (int s = 1; s < splits; ++s) {
    const size_t at = (size_t)s * nq * width + o;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = __ldg(part_s + at + h * kLanes);
      const int g = __ldg(part_g + at + h * kLanes);
      if (v < m1) {
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
  const int base = rb * bn + lane;
  s_out[o] = m1;
  s_out[o + kLanes] = m2;
  r_out[o] = base + g1 * kLanes;
  r_out[o + kLanes] = base + min(g2, groups - 1) * kLanes;
}

// dtable [nq, m, k] -> tab [tiles, m, kp, qt]: a code's entries for the
// tile's queries side by side; padded queries and codes k..kp-1 are 0.
__global__ void interleave_kernel(const float* __restrict__ dt, float* __restrict__ tab, int nq,
                                  int m, int k, int kp, int qt, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int qi = (int)(i % qt);
    size_t r = i / qt;
    const int kk = (int)(r % kp);
    r /= kp;
    const int mm = (int)(r % m);
    const int q = (int)(r / m) * qt + qi;
    tab[i] = (q < nq && kk < k) ? __ldg(dt + ((size_t)q * m + mm) * k + kk) : 0.0f;
  }
}

// ----- host side: check the plan, pick the instantiation -----

// plan = {qt, tiles, nbc, splits, mc, nbuf} from ops/adc.py adc_plan;
// false for a plan the kernel cannot run.
bool set_plan(Args& a, const int* plan, int code_bytes, int* threads, size_t* smem, int* grid) {
  a.qt = plan[0];
  a.tiles = plan[1];
  a.nbc = plan[2];
  a.splits = plan[3];
  a.mc = plan[4];
  a.nbuf = plan[5];
  const int qt = a.qt;
  if (!valid_tile(qt)) return false;
  if (a.tiles < 1 || (long long)a.tiles * qt < a.nq || (long long)(a.tiles - 1) * qt >= a.nq) {
    return false;
  }
  if (a.splits < 1 || a.groups % a.splits != 0 || a.nbc < 1) return false;
  if (a.mc < 1 || a.mc > a.m || a.nbuf < 1 || a.nbuf > kMaxBuf) return false;
  a.gps = a.groups / a.splits;
  a.nchunks = (a.m + a.mc - 1) / a.mc;
  if (!staged(qt) && a.nbuf > a.nchunks) return false;
  *threads = threads_per_block(qt) * a.nbc;
  const size_t tab = (size_t)a.mc * a.kp * qt * sizeof(float);
  const size_t codes =
      staged(qt) ? (size_t)a.mc * a.nbc * groups_per_pass(qt) * kLanes * code_bytes : 0;
  *smem = (size_t)a.nbuf * (tab + codes) + kBarBytes;
  a.tab_bytes = (uint32_t)tab;
  a.slot_bytes = (uint32_t)(tab + codes);
  a.nrbg = (a.n_rb + a.nbc - 1) / a.nbc;
  const long long g = (long long)a.tiles * a.splits * a.nrbg;
  if (*threads > kMaxThreads || *smem > (size_t)kMaxSmem || g >= (1ll << 31)) return false;
  *grid = (int)g;
  return true;
}

template <typename CodeT, int EPI, int QT>
int launch_one(const Args& a, int threads, size_t smem, int grid, cudaStream_t st) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        adc_kernel<CodeT, EPI, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  adc_kernel<CodeT, EPI, QT><<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename CodeT, int EPI>
int launch_qt(const Args& a, int threads, size_t smem, int grid, cudaStream_t st) {
  switch (a.qt) {
    case 1: return launch_one<CodeT, EPI, 1>(a, threads, smem, grid, st);
    case 2: return launch_one<CodeT, EPI, 2>(a, threads, smem, grid, st);
    case 4: return launch_one<CodeT, EPI, 4>(a, threads, smem, grid, st);
    case 8: return launch_one<CodeT, EPI, 8>(a, threads, smem, grid, st);
    case 16: return launch_one<CodeT, EPI, 16>(a, threads, smem, grid, st);
    default: return launch_one<CodeT, EPI, 32>(a, threads, smem, grid, st);
  }
}

template <typename CodeT, int EPI>
cudaError_t attributes_qt(int qt, cudaFuncAttributes* fa) {
  switch (qt) {
    case 1: return cudaFuncGetAttributes(fa, adc_kernel<CodeT, EPI, 1>);
    case 2: return cudaFuncGetAttributes(fa, adc_kernel<CodeT, EPI, 2>);
    case 4: return cudaFuncGetAttributes(fa, adc_kernel<CodeT, EPI, 4>);
    case 8: return cudaFuncGetAttributes(fa, adc_kernel<CodeT, EPI, 8>);
    case 16: return cudaFuncGetAttributes(fa, adc_kernel<CodeT, EPI, 16>);
    default: return cudaFuncGetAttributes(fa, adc_kernel<CodeT, EPI, 32>);
  }
}

template <typename CodeT>
cudaError_t attributes(int epi, int qt, cudaFuncAttributes* fa) {
  switch (epi) {
    case kScores: return attributes_qt<CodeT, kScores>(qt, fa);
    case kBlockTop2: return attributes_qt<CodeT, kBlockTop2>(qt, fa);
    case kIvfScores: return attributes_qt<CodeT, kIvfScores>(qt, fa);
    default: return attributes_qt<CodeT, kIvfTop2>(qt, fa);
  }
}

// Interleave the tables into `tab` (a null `tab` at QT = 1, K % 4 == 0 and a
// 16-byte aligned dtable: the core reads dtable in place), run the core,
// then (top-2 with splits) merge the splits' partial results.
template <int EPI>
int launch(Args a, const float* dtable, int k, float* tab, const int* plan, int code_bytes,
           void* stream) {
  constexpr bool kTop2 = EPI == kBlockTop2 || EPI == kIvfTop2;
  // four codes a load; a staged tile's bulk copies of codes take 16-byte
  // aligned codes and row strides
  const bool codes_aligned =
      (uintptr_t)a.codes % (4 * (uintptr_t)code_bytes) == 0 &&
      (!staged(plan[0]) || ((uintptr_t)a.codes % 16 == 0 && ((size_t)a.ld * code_bytes) % 16 == 0));
  if (a.nq < 1 || a.m < 1 || k < 1 || a.bn < kLanes || a.bn % kLanes != 0 || a.n_rb < 1 ||
      a.bn / kLanes > 0xFFFF || a.ld % 4 != 0 || !codes_aligned ||
      (a.mask != nullptr && (uintptr_t)a.mask % 4 != 0) || (code_bytes != 1 && code_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  a.groups = a.bn / kLanes;
  a.kp = (k + 3) / 4 * 4;
  int threads, grid;
  size_t smem;
  if (!set_plan(a, plan, code_bytes, &threads, &smem, &grid)) return (int)cudaErrorInvalidValue;
  if (kTop2 && a.splits > 1 && (a.part_s == nullptr || a.part_g == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (tab == nullptr) {  // [nq, m, k] is [tiles, m, kp, 1]
    if (a.qt != 1 || a.kp != k || (uintptr_t)dtable % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    a.tab = dtable;
  } else {
    const size_t total = (size_t)a.tiles * a.m * a.kp * a.qt;
    // a grid-stride loop of at most 8 CTAs of 256 threads per SM of an H100
    const int ig = (int)(total / 256 + 1 < 1056 ? total / 256 + 1 : 1056);
    interleave_kernel<<<ig, 256, 0, st>>>(dtable, tab, a.nq, a.m, k, a.kp, a.qt, total);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    a.tab = tab;
  }
  err = code_bytes == 1 ? launch_qt<uint8_t, EPI>(a, threads, smem, grid, st)
                        : launch_qt<uint16_t, EPI>(a, threads, smem, grid, st);
  if (err != 0 || !kTop2 || a.splits == 1) return err;
  adc_merge_kernel<<<dim3(a.nq, a.n_rb), kLanes, 0, st>>>(a.part_s, a.part_g, a.s_out, a.r_out,
                                                          a.nq, a.n_rb, a.splits, a.groups, a.bn);
  return (int)cudaGetLastError();
}

Args dense_args(const void* codes, const void* mask, void* s_out, void* r_out, void* part_s,
                void* part_g, int nq, int m, int n, int ld, int bn) {
  Args a{};
  a.codes = codes;
  a.mask = (const int8_t*)mask;
  a.s_out = (float*)s_out;
  a.r_out = (int*)r_out;
  a.part_s = (float*)part_s;
  a.part_g = (int*)part_g;
  a.nq = nq;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.bn = bn;
  a.n_rb = bn > 0 ? (n + bn - 1) / bn : 0;
  return a;
}

Args ivf_args(const void* block_ids, const void* codes, const void* mask, void* s_out,
              void* r_out, void* part_s, void* part_g, int n_sel, int nq, int m, int bs) {
  Args a{};
  a.codes = codes;
  a.mask = (const int8_t*)mask;
  a.block_ids = (const int*)block_ids;
  a.s_out = (float*)s_out;
  a.r_out = (int*)r_out;
  a.part_s = (float*)part_s;
  a.part_g = (int*)part_g;
  a.nq = nq;
  a.m = m;
  a.ld = bs;
  a.bn = bs;
  a.n_rb = n_sel;
  return a;
}

}  // namespace

extern "C" {

// Each entry point checks its geometry and plan, launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take; the wrappers check the same and raise with the reason first).
// code_bytes is 1 (u8 codes) or 2 (u16); tab is scratch for the interleaved
// tables, tiles * m * kp * qt floats, or null where the core reads dtable in
// place (QT = 1, K % 4 == 0); plan = {qt, tiles, nbc, splits, mc, nbuf}
// (ops/adc.py adc_plan).

// K5: out[q, n] (ld = row stride of codes_t [m, ld], n <= ld, ld % 4 == 0;
// a staged tile takes ld * code_bytes % 16 == 0).
int annlite_adc_scores(const void* dtable, const void* codes_t, const void* mask, void* out,
                       void* tab, int nq, int m, int k, int n, int ld, int code_bytes,
                       const int* plan, void* stream) {
  if (n < 1 || ld < n) return (int)cudaErrorInvalidValue;
  return launch<kScores>(dense_args(codes_t, mask, out, nullptr, nullptr, nullptr, nq, m, n, ld,
                                    4096),
                         (const float*)dtable, k, (float*)tab, plan, code_bytes, stream);
}

// K4's block pass: s_out/r_out [nq, n / block_n * 256]; n % block_n == 0;
// part_s/part_g [splits, nq, n / block_n * 256] when the plan splits groups.
int annlite_adc_block_top2(const void* dtable, const void* codes_t, const void* mask,
                           void* s_out, void* r_out, void* part_s, void* part_g, void* tab,
                           int nq, int m, int k, int n, int ld, int block_n, int code_bytes,
                           const int* plan, void* stream) {
  if (block_n < kLanes || n < block_n || n % block_n != 0 || ld < n) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<kBlockTop2>(
      dense_args(codes_t, mask, s_out, r_out, part_s, part_g, nq, m, n, ld, block_n),
      (const float*)dtable, k, (float*)tab, plan, code_bytes, stream);
}

// K7: out[j, q, slot] for the blocks block_ids[j] (a pad -1 scores block 0).
int annlite_ivf_scores(const void* block_ids, const void* dtable, const void* codes_blocks,
                       void* out, void* tab, int n_sel, int nq, int m, int k, int bs,
                       int code_bytes, const int* plan, void* stream) {
  return launch<kIvfScores>(
      ivf_args(block_ids, codes_blocks, nullptr, out, nullptr, nullptr, nullptr, n_sel, nq, m,
               bs),
      (const float*)dtable, k, (float*)tab, plan, code_bytes, stream);
}

// K6's block pass: s_out/r_out [nq, n_sel * 256], rows as j * bs + slot.
int annlite_ivf_block_top2(const void* block_ids, const void* dtable, const void* codes_blocks,
                           const void* mask_blocks, void* s_out, void* r_out, void* part_s,
                           void* part_g, void* tab, int n_sel, int nq, int m, int k, int bs,
                           int code_bytes, const int* plan, void* stream) {
  return launch<kIvfTop2>(ivf_args(block_ids, codes_blocks, mask_blocks, s_out, r_out, part_s,
                                   part_g, n_sel, nq, m, bs),
                          (const float*)dtable, k, (float*)tab, plan, code_bytes, stream);
}

// The core's instantiation for code_bytes (1, 2), epilogue epi (0 K5, 1 K4,
// 2 K7, 3 K6) and query tile qt: out = {registers per thread, local (spill)
// bytes per thread}.
int annlite_adc_info(int code_bytes, int epi, int qt, int* out) {
  if ((code_bytes != 1 && code_bytes != 2) || epi < 0 || epi > 3) {
    return (int)cudaErrorInvalidValue;
  }
  if (!valid_tile(qt)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t e = code_bytes == 1 ? attributes<uint8_t>(epi, qt, &fa)
                                        : attributes<uint16_t>(epi, qt, &fa);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return 0;
}

}  // extern "C"
