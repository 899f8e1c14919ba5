// Fused quantized scan with in-kernel candidate selection, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of annlite_tpu/ops/fused_scan.py, in every
// branch of the block scoring they share (_block_scores, :46):
//   * _fused_scan_kernel (K2, :99): per block of 8192 corpus rows, the
//     bucketed top-2 of each (query, row mod 128) bucket -> block_top2 here;
//   * _fused_scan8_kernel (K1, :121): the same block pass plus a running
//     sorted top-8 per (query, lane class) across all blocks (merge_top8,
//     :159) -> block_top2 followed by lane8_merge here.
// The block pass has one variant per scan copy (template parameter V):
//   * kInt8: int8 codes [N, D] against int8 query codes (the default);
//   * kInt4: nibble-packed int4 [N, D/2] (byte j holds dim j in its low
//     nibble and dim j + D/2 in its high nibble) against int8 query codes;
//   * kBf16: bf16 rows [N, D] against the queries rounded to bf16.
// On the TPU the grid runs in order, so K1 carries the top-8 stack in VMEM
// from one block to the next.  CUDA blocks run in no order, so K1 is two
// passes: the block pass writes [Q, nb*256] candidates (about 2% of the
// int8 corpus bytes at 2^20 x 768, Q = 64) and one thread per (query, lane)
// merges them in block order.
//
// Bounds on an H100 SXM (3.35 TB/s; 1979 int8 TOPS and 989 bf16 TFLOP/s on
// the tensor cores) at Q = 64, N = 2^20, D = 768, counting the corpus, row
// scales, biases and candidates: int8 ~831 MB, 0.248 ms; int4 ~428 MB,
// 0.128 ms; bf16 ~1636 MB, 0.488 ms.  The products (1.03e11 multiply-adds)
// take 0.10 ms in int8 and 0.21 ms in bf16 on the tensor cores, so every
// variant is bound by the corpus bytes, read once.
//
// Design.  The products run on the tensor cores (wgmma, wgmma.cuh), fed by
// TMA.  Corpus rows are wgmma's M operand, 64 rows (one lane half of a
// 128-row group) per warpgroup; the queries are its N operand: up to 32
// queries per warpgroup padded to N = 8, 16 or 32 (TMA fills rows past Q
// with zeros), so batch 1 wastes 7/8 of an N = 8 tile, not 63/64 of an M
// tile.  Both operands are K-major, as int8 wgmma requires and as the
// row-major corpus and query codes already are; every tile is a TMA box of
// 128 bytes of K, 128-byte swizzled: four k-steps of 32 bytes.  Each CTA is
// one or two consumer warpgroups (NWG; two hold a 64-query int8 tile, 32
// queries each, on the same corpus stages) and one producer warp, which
// streams the corpus box of each (group, K chunk) through a ring of stages
// (six when two CTAs fit an SM, else up to twelve) with full/empty
// mbarriers.  The query tile stays resident in shared memory when it fits
// beside the ring (int4's always; int8's 64 and bf16's 32 queries up to
// D = 2816); otherwise its K chunk streams in each stage beside the
// corpus's (re-read from L2 for each group).  Hopper has no int4 product:
// for int4 each consumer thread reads the packed bytes of its own A fragment
// from the stage and unpacks them (int4_lo / int4_hi) into two int8
// fragments, dims [k, k + 32) and [D/2 + k, ...), for two register-A wgmmas
// against the query's low and high K chunks.
//
// Selection in registers.  Rows r and r + 128 g of a block share a bucket,
// and the accumulator fragment gives a thread the same (row, query)
// positions in every group, so the thread that holds lane L of group g holds
// lane L of every group of the block.  It keeps mn1, mn2 and g1 | g2 << 16
// for each of its positions in registers across the groups, in ascending
// group order with strict '<' (_block_top2's rules: the lowest group wins a
// tie, g2 is clamped to groups - 1).  No shuffles and no shared memory.
//
// Filling the card.  A CTA is one (row block, lane half, group split, query
// tile); the grid's order puts the query tiles of one corpus tile side by
// side, so they share its rows through L2.  The host (block_pass_plan in
// annlite_torch/ops/fused_scan.py) takes the tile shapes measured fastest
// on the card (PERF.md): int8 tiles of up to 64 queries (two warpgroups
// above 32), int4 and bf16 tiles of up to 32 (at two warpgroups int4's
// unpacked fragments spill and bf16's query tile leaves one CTA per SM).
// Q = 128 thus takes two or four tiles rather than N = 128, whose 64
// accumulators and 192 words of selection state would not fit a thread's
// registers (a warpgroup at N = 64 already spilled).  Where blocks are few
// (N = 16,384 to 131,072), the host splits each block's groups over CTAs:
// each split writes its partial top-2 with groups, and split_merge inserts
// the splits' (mn1, mn2) in ascending split order with strict '<', which
// gives the sequential result exactly (the lower-group part wins every tie).
//
// Registers and occupancy: __launch_bounds__(threads, 2).  At N = 32 a
// consumer holds 16 accumulators and 3 x 16 words of selection state; the
// int4 variant also unpacks its 8 A fragments of a stage (32 registers)
// before the fence that issues them.  ptxas gives one warpgroup's CTA at
// N = 32 106-120 registers (three CTAs share an SM where shared memory
// allows), two warpgroups' 96.  setmaxnreg is not used (the producer is one
// warp).  Counts per variant and tile: block_pass_info, printed by
// chip_smoke.py.
//
// Exactness.  The int8 x int8 and int4 x int8 products accumulate in int32
// on the tensor cores, exactly.  The bf16 products are exact in float32 and
// the tensor cores sum them in their own order and rounding, so bf16 scores
// equal the plain version bit for bit only where every partial sum is exact
// (e.g. dyadic data).  Scores are bias + coef * ((acc * qsc) * rs) in this
// order, each step rounded on its own (__fmul_rn / __fadd_rn cannot be
// contracted into an FMA), the order of the JAX kernel and of the plain
// versions (_fused_scan_ref in annlite_torch/ops/fused_scan.py); qsc and rs
// are 1 for bf16, which changes no bit.  The merge keeps the rule of
// _fused_scan8_ref (a stable sort: an earlier candidate wins a tie) for
// every tie; see insert8 for where merge_top8 departs from it.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kLanes = 128;           // row r of a block is in bucket r % 128
constexpr int kHalf = 64;             // rows of a wgmma M tile: one lane half
constexpr int kChunk = 128;           // bytes of K in a TMA box
constexpr int kXBox = kHalf * kChunk;  // one corpus box: 8 KB
constexpr int kWarpgroup = 128;       // threads of a consumer warpgroup
constexpr int kMaxTile = 64;          // queries of a tile (NWG x wgmma N)
constexpr int kMaxDim = 3072;
constexpr int kMaxSmem = 232448;      // 227 KB: a block's shared memory limit
constexpr int kTwoPerSm = 113 * 1024;  // at most this, two CTAs share an SM
constexpr int kMinStages = 6;
constexpr int kMaxStages = 12;

enum Variant { kInt8 = 0, kInt4 = 1, kBf16 = 2 };

__device__ __forceinline__ float to_float(int a) { return __int2float_rn(a); }
__device__ __forceinline__ float to_float(float a) { return a; }

// The four low (high) nibbles of a word of packed int4, each sign-extended
// to a byte: (n ^ 8) - 8 maps 0..15 to 0..7, -8..-1.
__device__ __forceinline__ uint32_t int4_lo(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t int4_hi(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

struct Pass {
  const float* qsc;   // [nq]
  const float* rs;    // [n]
  const float* bias;  // [n]
  float* s_out;       // [nq, nb * 256]
  int* r_out;         // [nq, nb * 256]
  float* part_s;      // [splits, nq, nb * 256] when splits > 1
  int* part_g;        // [splits, nq, nb * 256]: the groups of part_s
  int nq, qt, tiles, splits, nb, groups, block_rows;
  int kc;             // 128-byte K chunks of a corpus row
  int kq;             // 128-byte K chunks of a query row
  int stages, resident;
  float coef;
};

// Shared memory: [query tile if resident | ring of stages | qsc | barriers],
// from a 1024-byte aligned base (the swizzled boxes need it).
struct Layout {
  int qbox, stage, ring_off, qsc_off, bar_off, bytes;
};

// tile: the query tile's rows (NWG x NT), one query box of 128-byte rows.
__host__ __device__ inline Layout layout(int v, int tile, int kq, int stages, int resident) {
  Layout l;
  l.qbox = tile * kChunk;
  l.stage = kXBox + (resident ? 0 : (v == kInt4 ? 2 : 1) * l.qbox);
  l.ring_off = resident ? kq * l.qbox : 0;
  l.qsc_off = l.ring_off + stages * l.stage;
  l.bar_off = l.qsc_off + kMaxTile * 4;
  l.bytes = 1024 + l.bar_off + (2 * stages + 1) * 8;
  return l;
}

// NWG consumer warpgroups, each with NT of the tile's queries, share the
// corpus stages; one producer warp follows them.
template <int V, int NT, int NWG>
__global__ void __launch_bounds__(NWG * kWarpgroup + 32, 2)
block_top2_kernel(const __grid_constant__ CUtensorMap xmap,  // corpus, box 128 B x 64 rows
                  const __grid_constant__ CUtensorMap qmap,  // queries, box 128 B x NWG*NT rows
                  const Pass p) {
  constexpr int kConsumers = NWG * kWarpgroup;
  extern __shared__ uint8_t smem_raw[];
  // an offset into the array keeps the pointer in the shared space (ld.shared)
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  const Layout lay = layout(V, NWG * NT, p.kq, p.stages, p.resident);
  uint8_t* ring = smem + lay.ring_off;
  float* sq = reinterpret_cast<float*>(smem + lay.qsc_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + p.stages;
  uint64_t* qbar = empty + p.stages;

  // this CTA: query tile fastest, then group split, lane half, row block
  int cta = blockIdx.x;
  const int t = cta % p.tiles;
  cta /= p.tiles;
  const int split = cta % p.splits;
  cta /= p.splits;
  const int half = cta & 1;
  const int blk = cta >> 1;
  const int q0 = t * p.qt;
  const int gps = p.groups / p.splits;
  const int g_begin = split * gps;
  const int g_end = g_begin + gps;
  const int row_base = blk * p.block_rows + half * kHalf;  // + 128 g

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      wg::mbar_init(full + i, 1);
      wg::mbar_init(empty + i, kConsumers);
    }
    wg::mbar_init(qbar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    if (threadIdx.x == kConsumers) {
      if (p.resident) {
        wg::mbar_expect_tx(qbar, p.kq * lay.qbox);
        for (int c = 0; c < p.kq; ++c) {
          wg::tma_load_2d(smem + c * lay.qbox, &qmap, c * kChunk, q0, qbar);
        }
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int g = g_begin; g < g_end; ++g) {
        for (int c = 0; c < p.kc; ++c) {
          wg::mbar_wait(empty + slot, phase ^ 1);
          uint8_t* st = ring + slot * lay.stage;
          wg::mbar_expect_tx(full + slot, lay.stage);
          wg::tma_load_2d(st, &xmap, c * kChunk, row_base + g * kLanes, full + slot);
          if (!p.resident) {
            wg::tma_load_2d(st + kXBox, &qmap, c * kChunk, q0, full + slot);
            if (V == kInt4) {
              wg::tma_load_2d(st + kXBox + lay.qbox, &qmap, (p.kc + c) * kChunk, q0,
                              full + slot);
            }
          }
          if (++slot == p.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: NWG warpgroups, the same rows, NT queries each ----
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = ((tid & 127) >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8 of the M tile
  const int qw = (tid >> 7) * NT;  // this warpgroup's first query of the tile
  const int tq = qw + 2 * (lane & 3);  // queries 8 j + tq + {0, 1}
  if (tid < NWG * NT) sq[tid] = (tid < p.qt && q0 + tid < p.nq) ? p.qsc[q0 + tid] : 1.0f;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  constexpr int R = NT / 2;  // positions: 2 rows x NT/4 queries
  using Acc = typename std::conditional<V == kBf16, float, int>::type;
  Acc acc[R];
  float mn1[R], mn2[R];
  uint32_t gg[R];  // g1 | g2 << 16
#pragma unroll
  for (int k = 0; k < R; ++k) {
    acc[k] = 0;
    mn1[k] = __int_as_float(0x7f800000);  // +inf
    mn2[k] = __int_as_float(0x7f800000);
    gg[k] = 0;
  }
  if (p.resident) wg::mbar_wait(qbar, 0);

  float rs_next[2], b_next[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_base + g_begin * kLanes + r0 + 8 * i;
    rs_next[i] = __ldg(p.rs + row);
    b_next[i] = __ldg(p.bias + row);
  }
  int slot = 0;
  uint32_t phase = 0;
  for (int g = g_begin; g < g_end; ++g) {
    float rsv[2], bv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsv[i] = rs_next[i];
      bv[i] = b_next[i];
      if (g + 1 < g_end) {  // the next group's row data, in flight meanwhile
        const int row = row_base + (g + 1) * kLanes + r0 + 8 * i;
        rs_next[i] = __ldg(p.rs + row);
        b_next[i] = __ldg(p.bias + row);
      }
    }
    for (int c = 0; c < p.kc; ++c) {
      wg::mbar_wait(full + slot, phase);
      const uint8_t* st = ring + slot * lay.stage;
      const uint8_t* qlo = (p.resident ? smem + c * lay.qbox : st + kXBox) + qw * kChunk;
      const int first = (c == 0) ? 0 : 1;  // 0: the group's sum starts here
      if constexpr (V == kInt4) {
        // this thread's A fragments: packed bytes 4(l%4) and 16 + 4(l%4) of
        // each 32-byte k-step, rows r0 and r0 + 8 (r0 % 8 = l / 4 sets the
        // 128-byte swizzle of both)
        const uint8_t* qhi =
            (p.resident ? smem + (p.kc + c) * lay.qbox : st + kXBox + lay.qbox) + qw * kChunk;
        uint32_t lo[4][4], hi[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int row = r0 + 8 * (a & 1);
            const int unit = (2 * kk + (a >> 1)) ^ (lane >> 2);
            const uint32_t w =
                *reinterpret_cast<const uint32_t*>(st + row * kChunk + unit * 16 + 4 * (lane & 3));
            lo[kk][a] = int4_lo(w);
            hi[kk][a] = int4_hi(w);
          }
          // the fragments are complete before the fence: no instruction
          // writes a wgmma's registers inside the batch
          wg::fence_regs(lo[kk]);
          wg::fence_regs(hi[kk]);
        }
        wg::fence_regs(acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wg::Mma<NT>::s8_rs(acc, lo[kk], wg::sw128_desc(qlo) + 2 * kk, first | kk);
          wg::Mma<NT>::s8_rs(acc, hi[kk], wg::sw128_desc(qhi) + 2 * kk, 1);
        }
      } else {
        wg::fence_regs(acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // the 32-byte k-steps of a 128-byte chunk
          const uint64_t da = wg::sw128_desc(st) + 2 * kk;
          const uint64_t db = wg::sw128_desc(qlo) + 2 * kk;
          if constexpr (V == kBf16) {
            wg::Mma<NT>::bf16_ss(acc, da, db, first | kk);
          } else {
            wg::Mma<NT>::s8_ss(acc, da, db, first | kk);
          }
        }
      }
      wg::commit();
      wg::wait_all();
      wg::fence_regs(acc);
      wg::mbar_arrive(empty + slot);
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    // epilogue of group g: score and select, in ascending g with strict '<'
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = (k >> 1) & 1;
      const float qs = sq[8 * (k >> 2) + tq + (k & 1)];
      const float dots = __fmul_rn(to_float(acc[k]), qs);
      const float v = __fadd_rn(bv[i], __fmul_rn(p.coef, __fmul_rn(dots, rsv[i])));
      if (v < mn1[k]) {
        mn2[k] = mn1[k];
        mn1[k] = v;
        gg[k] = (gg[k] << 16) | static_cast<uint32_t>(g);
      } else if (v < mn2[k]) {
        mn2[k] = v;
        gg[k] = (gg[k] & 0xFFFFu) | (static_cast<uint32_t>(g) << 16);
      }
    }
  }

  const size_t width = (size_t)p.nb * 256;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int q = 8 * (k >> 2) + tq + (k & 1);
    if (q < p.qt && q0 + q < p.nq) {
      const int ln = half * kHalf + r0 + 8 * ((k >> 1) & 1);
      const int g1 = static_cast<int>(gg[k] & 0xFFFFu);
      const int g2 = static_cast<int>(gg[k] >> 16);
      if (p.splits == 1) {
        const size_t o = (size_t)(q0 + q) * width + (size_t)blk * 256 + ln;
        const int base = blk * p.block_rows + ln;
        p.s_out[o] = mn1[k];
        p.s_out[o + kLanes] = mn2[k];
        p.r_out[o] = base + g1 * kLanes;
        p.r_out[o + kLanes] = base + min(g2, p.groups - 1) * kLanes;
      } else {
        const size_t o = ((size_t)split * p.nq + q0 + q) * width + (size_t)blk * 256 + ln;
        p.part_s[o] = mn1[k];
        p.part_s[o + kLanes] = mn2[k];
        p.part_g[o] = g1;
        p.part_g[o + kLanes] = g2;
      }
    }
  }
}

// One thread per (query, block, lane): the splits' partial top-2s in
// ascending split order, each split's (mn1, g1) then (mn2, g2) inserted
// with strict '<'.  A partial's +inf entries (fewer than two finite scores)
// never enter, so their groups do not matter.
__global__ void __launch_bounds__(kLanes)
split_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_g,
                   float* __restrict__ s_out, int* __restrict__ r_out, int nq, int nb,
                   int splits, int groups, int block_rows) {
  const int q = blockIdx.x;
  const int blk = blockIdx.y;
  const int lane = threadIdx.x;
  const size_t width = (size_t)nb * 256;
  const size_t o = (size_t)q * width + (size_t)blk * 256 + lane;
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
  const int base = blk * block_rows + lane;
  s_out[o] = m1;
  s_out[o + kLanes] = m2;
  r_out[o] = base + g1 * kLanes;
  r_out[o + kLanes] = base + min(g2, groups - 1) * kLanes;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A [rows, row_bytes] byte matrix read in boxes of 128 bytes x box_rows,
// 128-byte swizzled; rows past the end read as zeros.
bool make_map(CUtensorMap* map, const void* base, int rows, int row_bytes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The query tile stays resident if it fits beside kMinStages stages; the
// ring takes six stages where two CTAs then share an SM, else as many as
// fit, up to twelve.  Returns the dynamic shared memory of a CTA.
int plan_smem(int v, int tile, int kq, int* stages, int* resident) {
  *resident = layout(v, tile, kq, kMinStages, 1).bytes <= kMaxSmem;
  *stages = kMinStages;
  if (layout(v, tile, kq, kMinStages, *resident).bytes > kTwoPerSm) {
    while (*stages < kMaxStages &&
           layout(v, tile, kq, *stages + 1, *resident).bytes <= kMaxSmem) {
      ++*stages;
    }
  }
  return layout(v, tile, kq, *stages, *resident).bytes;
}

// The tile shapes the host plans: NWG = 1 with NT = 8, 16 or 32 queries;
// for int8 also NWG = 2 with NT = 32.
bool known_tile(int v, int nt, int nwg) {
  return nwg == 1 ? (nt == 8 || nt == 16 || nt == 32) : (v == kInt8 && nwg == 2 && nt == 32);
}

template <int V>
cudaError_t kernel_attributes(int nt, int nwg, cudaFuncAttributes* a) {
  if constexpr (V == kInt8) {
    if (nwg == 2) return cudaFuncGetAttributes(a, block_top2_kernel<V, 32, 2>);
  }
  switch (nt) {
    case 8: return cudaFuncGetAttributes(a, block_top2_kernel<V, 8, 1>);
    case 16: return cudaFuncGetAttributes(a, block_top2_kernel<V, 16, 1>);
    default: return cudaFuncGetAttributes(a, block_top2_kernel<V, 32, 1>);
  }
}

template <int V, int NT, int NWG>
int launch_tile(const CUtensorMap& xm, const CUtensorMap& qm, const Pass& p, int smem, int grid,
                cudaStream_t stream) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_top2_kernel<V, NT, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  block_top2_kernel<V, NT, NWG><<<grid, NWG * kWarpgroup + 32, smem, stream>>>(xm, qm, p);
  return (int)cudaGetLastError();
}

// The kernel of a known tile shape (known_tile).
template <int V>
int launch_planned(int nt, int nwg, const CUtensorMap& xm, const CUtensorMap& qm, const Pass& p,
                   int smem, int grid, cudaStream_t stream) {
  if constexpr (V == kInt8) {
    if (nwg == 2) return launch_tile<V, 32, 2>(xm, qm, p, smem, grid, stream);
  }
  switch (nt) {
    case 8: return launch_tile<V, 8, 1>(xm, qm, p, smem, grid, stream);
    case 16: return launch_tile<V, 16, 1>(xm, qm, p, smem, grid, stream);
    default: return launch_tile<V, 32, 1>(xm, qm, p, smem, grid, stream);
  }
}

// Checks the geometry and the plan (query tile qt of nwg x nt, splits),
// lays out shared memory, launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for what the kernel does not
// take; the wrapper checks the same and raises with the reason first).
template <int V>
int launch_block_top2(const void* q, const void* qsc, const void* x, const void* rs,
                      const void* bias, void* s_out, void* r_out, void* part_s, void* part_g,
                      int nq, int n, int d, int block_rows, int qt, int nt, int nwg,
                      int splits, float coef, void* stream) {
  const int q_row = V == kBf16 ? 2 * d : d;
  const int x_row = V == kInt8 ? d : V == kInt4 ? d / 2 : 2 * d;
  const int groups = block_rows / kLanes;
  if (nq < 1 || d < 1 || d > kMaxDim || q_row % kChunk != 0 || x_row % kChunk != 0 ||
      block_rows < kLanes || block_rows % kLanes != 0 || n < block_rows ||
      n % block_rows != 0 || groups > 0xFFFF || !known_tile(V, nt, nwg) || qt < 1 ||
      qt > nwg * nt || splits < 1 || groups % splits != 0 ||
      (splits > 1 && (part_s == nullptr || part_g == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Pass p;
  p.qsc = static_cast<const float*>(qsc);
  p.rs = static_cast<const float*>(rs);
  p.bias = static_cast<const float*>(bias);
  p.s_out = static_cast<float*>(s_out);
  p.r_out = static_cast<int*>(r_out);
  p.part_s = static_cast<float*>(part_s);
  p.part_g = static_cast<int*>(part_g);
  p.nq = nq;
  p.qt = qt;
  p.tiles = (nq + qt - 1) / qt;
  p.splits = splits;
  p.nb = n / block_rows;
  p.groups = groups;
  p.block_rows = block_rows;
  p.kc = x_row / kChunk;
  p.kq = q_row / kChunk;
  p.coef = coef;
  const int smem = plan_smem(V, nwg * nt, p.kq, &p.stages, &p.resident);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, qm;
  if (!make_map(&xm, x, n, x_row, kHalf) || !make_map(&qm, q, nq, q_row, nwg * nt)) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = p.nb * 2 * splits * p.tiles;
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_planned<V>(nt, nwg, xm, qm, p, smem, grid, st);
  if (err != 0 || splits == 1) return err;
  split_merge_kernel<<<dim3(nq, p.nb), kLanes, 0, st>>>(
      p.part_s, p.part_g, p.s_out, p.r_out, nq, p.nb, splits, groups, block_rows);
  return (int)cudaGetLastError();
}

// lane8_merge: the stable top-8 of each (query, lane class) over the nb
// blocks' candidates (block 0's mn1, its mn2, block 1's mn1, ...).  Output
// column 128 * k + lane is the k-th best.
//
// One thread per (query, lane class) walking all nb blocks (two dependent
// loads a block, 8,192 threads at Q = 64) was latency-bound at 8-16x its
// byte bound.  Here a CTA holds one query's chunk of 32 lane classes, so a
// warp's loads are 128 contiguous bytes, and its `ranges` warps (planned in
// ops/fused_scan.py lane8_merge_plan) walk `ranges` contiguous block ranges
// side by side, each keeping its own stack in registers with kMergeUnroll
// blocks' loads in flight.  The stacks then merge pairwise through shared
// memory, the earlier range's stack receiving the later one's entries in
// order.  Every insert shifts with strict '<', so this is exactly the
// sequential walk: the stable top-8 of a concatenation is the in-order
// insertion of the parts' stable top-8s (an entry a part drops has 8 of its
// own ahead of it, no later than it, so it could not have entered), ties go
// to the earlier part, and +inf fillers never enter.  split_merge and
// adc_merge rest on the same argument.
constexpr int kMergeMaxRanges = 16;
constexpr int kMergeUnroll = 4;

// Insert (cs, cr) into a sorted 8-deep stack.  Once the new candidate has its
// slot, every entry below it moves down one place.  A compare-exchange
// cascade with '<' alone (merge_top8) lets a displaced entry skip an equal
// later one, which breaks the "earlier candidate first" order among ties;
// shifting keeps the stack a stable sort of the candidates seen so far.
__device__ __forceinline__ void insert8(float (&s)[8], int (&r)[8], float cs, int cr) {
  bool placed = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool take = placed || cs < s[k];
    placed = take;
    const float ts = s[k];
    const int tr = r[k];
    s[k] = take ? cs : ts;
    r[k] = take ? cr : tr;
    cs = take ? ts : cs;
    cr = take ? tr : cr;
  }
}

// blockIdx.x = query * 4 + lane chunk; warp w walks blocks
// [w * nb / ranges, (w + 1) * nb / ranges).
__global__ void __launch_bounds__(kMergeMaxRanges * 32)
lane8_merge_kernel(const float* __restrict__ s_in,   // [nq, nb * 256]
                   const int* __restrict__ r_in,     // [nq, nb * 256]
                   float* __restrict__ s_out,        // [nq, 1024]
                   int* __restrict__ r_out,          // [nq, 1024]
                   int nb, int ranges) {
  __shared__ float part_s[kMergeMaxRanges][8][32];
  __shared__ int part_r[kMergeMaxRanges][8][32];
  const int q = blockIdx.x >> 2;
  const int l = threadIdx.x & 31;
  const int lane = (blockIdx.x & 3) * 32 + l;
  const int w = threadIdx.x >> 5;
  float s[8];
  int r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = __int_as_float(0x7f800000);
    r[k] = 0;
  }
  const int hi = (int)((long long)(w + 1) * nb / ranges);
  int blk = (int)((long long)w * nb / ranges);
  const float* sp = s_in + (size_t)q * nb * 256 + lane;
  const int* rp = r_in + (size_t)q * nb * 256 + lane;
  for (; blk + kMergeUnroll <= hi; blk += kMergeUnroll) {
    float cs[kMergeUnroll][2];
    int cr[kMergeUnroll][2];
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t at = (size_t)(blk + u) * 256 + h * kLanes;
        cs[u][h] = __ldg(sp + at);
        cr[u][h] = __ldg(rp + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      insert8(s, r, cs[u][0], cr[u][0]);
      insert8(s, r, cs[u][1], cr[u][1]);
    }
  }
  for (; blk < hi; ++blk) {
    const size_t at = (size_t)blk * 256;
    const float s0 = __ldg(sp + at), s1 = __ldg(sp + at + kLanes);
    const int r0 = __ldg(rp + at), r1 = __ldg(rp + at + kLanes);
    insert8(s, r, s0, r0);
    insert8(s, r, s1, r1);
  }
  // pairwise: in round d, warp w with w % 2d == d hands its stack (ranges
  // [w, w + d)) to warp w - d, which inserts it in order after its own
  for (int d = 1; d < ranges; d <<= 1) {
    if ((w & (2 * d - 1)) == d) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        part_s[w][k][l] = s[k];
        part_r[w][k][l] = r[k];
      }
    }
    __syncthreads();
    if ((w & (2 * d - 1)) == 0 && w + d < ranges) {
#pragma unroll
      for (int k = 0; k < 8; ++k) insert8(s, r, part_s[w + d][k][l], part_r[w + d][k][l]);
    }
  }
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s_out[(size_t)q * 1024 + k * kLanes + lane] = s[k];
      r_out[(size_t)q * 1024 + k * kLanes + lane] = r[k];
    }
  }
}

}  // namespace

extern "C" {

// The block pass over int8 codes x [n, d] (q: int8 codes [nq, d]); the plan
// (qt, nt, nwg, splits) comes from block_pass_plan, part_s / part_g hold the
// splits' partial results when splits > 1 (else null).
int annlite_block_top2(const void* q8, const void* qsc, const void* x, const void* rs,
                       const void* bias, void* s_out, void* r_out, void* part_s, void* part_g,
                       int nq, int n, int d, int block_rows, int qt, int nt, int nwg,
                       int splits, float coef, void* stream) {
  return launch_block_top2<kInt8>(q8, qsc, x, rs, bias, s_out, r_out, part_s, part_g, nq, n, d,
                                  block_rows, qt, nt, nwg, splits, coef, stream);
}

// The block pass over packed int4 x [n, d/2] (q: int8 codes [nq, d]).
int annlite_block_top2_int4(const void* q8, const void* qsc, const void* x, const void* rs,
                            const void* bias, void* s_out, void* r_out, void* part_s,
                            void* part_g, int nq, int n, int d, int block_rows, int qt, int nt,
                            int nwg, int splits, float coef, void* stream) {
  return launch_block_top2<kInt4>(q8, qsc, x, rs, bias, s_out, r_out, part_s, part_g, nq, n, d,
                                  block_rows, qt, nt, nwg, splits, coef, stream);
}

// The block pass over bf16 x [n, d] (q: bf16 [nq, d]).
int annlite_block_top2_bf16(const void* qbf, const void* qsc, const void* x, const void* rs,
                            const void* bias, void* s_out, void* r_out, void* part_s,
                            void* part_g, int nq, int n, int d, int block_rows, int qt, int nt,
                            int nwg, int splits, float coef, void* stream) {
  return launch_block_top2<kBf16>(qbf, qsc, x, rs, bias, s_out, r_out, part_s, part_g, nq, n, d,
                                  block_rows, qt, nt, nwg, splits, coef, stream);
}

// What the block pass of variant v (0 int8, 1 int4, 2 bf16) with nwg
// warpgroups of nt queries over rows of d values runs with: out =
// {registers per thread, local (spill) bytes per thread, dynamic shared
// memory per CTA, ring stages, query tile resident (1) or streamed (0)}.
int annlite_block_pass_info(int v, int nt, int nwg, int d, int* out) {
  if (v < 0 || v > 2 || d < 1 || d > kMaxDim || !known_tile(v, nt, nwg)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes a;
  const cudaError_t e = v == kInt8   ? kernel_attributes<kInt8>(nt, nwg, &a)
                        : v == kInt4 ? kernel_attributes<kInt4>(nt, nwg, &a)
                                     : kernel_attributes<kBf16>(nt, nwg, &a);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = plan_smem(v, nwg * nt, (v == kBf16 ? 2 * d : d) / kChunk, &out[3], &out[4]);
  return 0;
}

// lane8_merge of [nq, nb * 256] candidates -> [nq, 1024], each lane class's
// blocks walked as `ranges` contiguous ranges (1 <= ranges <= min(nb, 16)).
int annlite_lane8_merge(const void* s_in, const void* r_in, void* s_out,
                        void* r_out, int nq, int nb, int ranges, void* stream) {
  if (nq < 1 || nb < 1 || ranges < 1 || ranges > kMergeMaxRanges || ranges > nb) {
    return (int)cudaErrorInvalidValue;
  }
  lane8_merge_kernel<<<nq * 4, ranges * 32, 0, (cudaStream_t)stream>>>(
      (const float*)s_in, (const int*)r_in, (float*)s_out, (int*)r_out, nb, ranges);
  return (int)cudaGetLastError();
}

}  // extern "C"
