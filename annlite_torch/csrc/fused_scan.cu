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
// int8 corpus bytes: 16.8 MB against 805 MB at 2^20 x 768, Q = 64) and one
// thread per (query, lane) merges them in block order.
//
// Bounds on an H100 SXM (3.35 TB/s, 1979 int8 TOPS, 67 float32 TFLOP/s on
// the CUDA cores) at Q = 64, N = 2^20, D = 768, counting the corpus, row
// scales, biases and candidates: int8 ~831 MB, 0.248 ms; int4 ~428 MB,
// 0.128 ms; bf16 ~1636 MB, 0.488 ms.  All are memory-bound on the tensor
// cores.  This first version scores on the CUDA cores (__dp4a for int8 and
// int4, float32 FMAs for bf16; no tensor cores), which makes it
// compute-bound well above the memory bound; for bf16 the 1.03e11 FMA
// operations alone take 1.54 ms at 67 TFLOP/s.  A wgmma version is later
// work.  The design does about the bound only this much: each corpus row is
// read once per 16-query tile, and the tiles of one row block are
// neighbouring CTAs (blockIdx.x is the query tile), so they share the rows
// through L2.  Hopper's tensor cores have no int4 product, so the int4
// variant unpacks each nibble to a sign-extended byte in registers.
//
// Exactness.  The int8 x int8 and int4 x int8 products accumulate in i32,
// exactly.  The bf16 products are exact in float32 (8-bit significands) and
// accumulate in one float32 per query in ascending d (one rounding per
// step, __fmaf_rn); the plain version sums in another order, so bf16 scores
// equal it bit for bit only where every partial sum is exact (e.g. dyadic
// data).  Scores are bias + coef * ((acc * qsc) * rs) in this order, each
// step rounded on its own (__fmul_rn / __fadd_rn cannot be contracted into
// an FMA), which is the order of the JAX kernel and of the plain versions
// (_fused_scan_ref in annlite_torch/ops/fused_scan.py); qsc and rs are 1
// for bf16, which changes no bit.  Selection is sequential in ascending
// group order with strict '<', which reproduces _block_top2's rules (lowest
// group wins a tie).  The merge keeps the rule of _fused_scan8_ref (a
// stable sort: an earlier candidate wins a tie) for every tie; see
// lane8_merge_kernel for where merge_top8 departs from it.
#include <cstdint>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kLanes = 128;          // row r of a block is in bucket r % 128
constexpr int kQueryTile = 16;       // queries per CTA
// Largest D: the int8 query tile then takes 48 KB of shared memory, the
// bf16 variant's float32 tile 192 KB (dynamic shared memory, opted in).
constexpr int kMaxDim = 3072;

enum Variant { kInt8 = 0, kInt4 = 1, kBf16 = 2 };

__device__ __forceinline__ float to_float(int a) { return __int2float_rn(a); }
__device__ __forceinline__ float to_float(float a) { return a; }

// The two bf16 values of a 32-bit word (the lower address in the low half)
// widened to float32, exactly.
__device__ __forceinline__ float bf16_lo(int w) {
  return __uint_as_float(static_cast<unsigned>(w) << 16);
}
__device__ __forceinline__ float bf16_hi(int w) {
  return __uint_as_float(static_cast<unsigned>(w) & 0xFFFF0000u);
}

// The four low (high) nibbles of a word of packed int4, each sign-extended
// to a byte: (n ^ 8) - 8 maps 0..15 to 0..7, -8..-1.
__device__ __forceinline__ int int4_lo(int w) {
  return __vsub4((static_cast<unsigned>(w) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int int4_hi(int w) {
  return __vsub4(((static_cast<unsigned>(w) >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                 0x08080808u);
}

template <int V>
__global__ void __launch_bounds__(kLanes)
block_top2_kernel(const void* __restrict__ qv,       // [nq, d] int8 codes | bf16
                  const float* __restrict__ qsc,     // [nq]
                  const void* __restrict__ xv,       // [n, d] int8 | [n, d/2] int4 | [n, d] bf16
                  const float* __restrict__ rs,      // [n]
                  const float* __restrict__ bias,    // [n]
                  float* __restrict__ s_out,         // [nq, nb * 256]
                  int* __restrict__ r_out,           // [nq, nb * 256]
                  int nq, int d, int block_rows, int nb, float coef) {
  // the query tile: int8 codes, or the bf16 queries widened to float32
  extern __shared__ int4 qtile[];
  const int q0 = blockIdx.x * kQueryTile;
  const int blk = blockIdx.y;
  const int lane = threadIdx.x;
  const int nqt = min(kQueryTile, nq - q0);
  // 16-byte vectors per query row of the tile and per corpus row
  const int qv16 = (V == kBf16 ? 4 * d : d) / 16;
  const int xv16 = (V == kInt8 ? d : V == kInt4 ? d / 2 : 2 * d) / 16;

  if constexpr (V == kBf16) {
    // 16 bytes of bf16 queries become two float4 of the tile
    const int in16 = d / 8;
    const int4* qsrc = reinterpret_cast<const int4*>(
        static_cast<const uint16_t*>(qv) + (size_t)q0 * d);
    float4* dst = reinterpret_cast<float4*>(qtile);
    for (int i = lane; i < kQueryTile * in16; i += kLanes) {
      const int4 w = i < nqt * in16 ? qsrc[i] : make_int4(0, 0, 0, 0);
      dst[2 * i] = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
      dst[2 * i + 1] = make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
    }
  } else {
    const int4* qsrc = reinterpret_cast<const int4*>(
        static_cast<const int8_t*>(qv) + (size_t)q0 * d);
    for (int i = lane; i < kQueryTile * qv16; i += kLanes) {
      qtile[i] = i < nqt * qv16 ? qsrc[i] : make_int4(0, 0, 0, 0);
    }
  }
  float qscale[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) qscale[j] = j < nqt ? qsc[q0 + j] : 1.0f;
  __syncthreads();

  float mn1[kQueryTile], mn2[kQueryTile];
  int g1[kQueryTile], g2[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) {
    mn1[j] = __int_as_float(0x7f800000);  // +inf
    mn2[j] = __int_as_float(0x7f800000);
    g1[j] = 0;
    g2[j] = 0;
  }

  using Acc = typename std::conditional<V == kBf16, float, int>::type;
  const int groups = block_rows / kLanes;
  const size_t base = (size_t)blk * block_rows;
  for (int g = 0; g < groups; ++g) {
    const size_t row = base + (size_t)g * kLanes + lane;
    const int4* xr = static_cast<const int4*>(xv) + row * xv16;
    Acc acc[kQueryTile];
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) acc[j] = 0;
    for (int c = 0; c < xv16; ++c) {
      const int4 x4 = __ldg(xr + c);
      if constexpr (V == kInt8) {
#pragma unroll
        for (int j = 0; j < kQueryTile; ++j) {
          const int4 q4 = qtile[j * qv16 + c];
          acc[j] = __dp4a(x4.x, q4.x, acc[j]);
          acc[j] = __dp4a(x4.y, q4.y, acc[j]);
          acc[j] = __dp4a(x4.z, q4.z, acc[j]);
          acc[j] = __dp4a(x4.w, q4.w, acc[j]);
        }
      } else if constexpr (V == kInt4) {
        // dims [16c, 16c + 16) in the low nibbles, [d/2 + 16c, ...) in the
        // high ones; the high half of a query row starts at vector xv16
        const int l0 = int4_lo(x4.x), l1 = int4_lo(x4.y), l2 = int4_lo(x4.z),
                  l3 = int4_lo(x4.w);
        const int h0 = int4_hi(x4.x), h1 = int4_hi(x4.y), h2 = int4_hi(x4.z),
                  h3 = int4_hi(x4.w);
#pragma unroll
        for (int j = 0; j < kQueryTile; ++j) {
          const int4 ql = qtile[j * qv16 + c];
          const int4 qh = qtile[j * qv16 + xv16 + c];
          acc[j] = __dp4a(l0, ql.x, acc[j]);
          acc[j] = __dp4a(l1, ql.y, acc[j]);
          acc[j] = __dp4a(l2, ql.z, acc[j]);
          acc[j] = __dp4a(l3, ql.w, acc[j]);
          acc[j] = __dp4a(h0, qh.x, acc[j]);
          acc[j] = __dp4a(h1, qh.y, acc[j]);
          acc[j] = __dp4a(h2, qh.z, acc[j]);
          acc[j] = __dp4a(h3, qh.w, acc[j]);
        }
      } else {
        // dims [8c, 8c + 8), accumulated in ascending order
        const float f0 = bf16_lo(x4.x), f1 = bf16_hi(x4.x), f2 = bf16_lo(x4.y),
                    f3 = bf16_hi(x4.y), f4 = bf16_lo(x4.z), f5 = bf16_hi(x4.z),
                    f6 = bf16_lo(x4.w), f7 = bf16_hi(x4.w);
        const float4* qt = reinterpret_cast<const float4*>(qtile);
#pragma unroll
        for (int j = 0; j < kQueryTile; ++j) {
          const float4 qa = qt[j * qv16 + 2 * c];
          const float4 qb = qt[j * qv16 + 2 * c + 1];
          float a = acc[j];
          a = __fmaf_rn(f0, qa.x, a);
          a = __fmaf_rn(f1, qa.y, a);
          a = __fmaf_rn(f2, qa.z, a);
          a = __fmaf_rn(f3, qa.w, a);
          a = __fmaf_rn(f4, qb.x, a);
          a = __fmaf_rn(f5, qb.y, a);
          a = __fmaf_rn(f6, qb.z, a);
          a = __fmaf_rn(f7, qb.w, a);
          acc[j] = a;
        }
      }
    }
    const float r_s = __ldg(rs + row);
    const float b = __ldg(bias + row);
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) {
      const float dots = __fmul_rn(to_float(acc[j]), qscale[j]);
      const float v = __fadd_rn(b, __fmul_rn(coef, __fmul_rn(dots, r_s)));
      if (v < mn1[j]) {
        mn2[j] = mn1[j];
        g2[j] = g1[j];
        mn1[j] = v;
        g1[j] = g;
      } else if (v < mn2[j]) {
        mn2[j] = v;
        g2[j] = g;
      }
    }
  }

  const size_t width = (size_t)nb * 256;
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) {
    if (j < nqt) {
      const size_t o = (size_t)(q0 + j) * width + (size_t)blk * 256;
      s_out[o + lane] = mn1[j];
      s_out[o + kLanes + lane] = mn2[j];
      r_out[o + lane] = (int)base + g1[j] * kLanes + lane;
      r_out[o + kLanes + lane] = (int)base + min(g2[j], groups - 1) * kLanes + lane;
    }
  }
}

// Checks the geometry, sizes the query tile, launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a geometry the
// kernel does not take).
template <int V>
int launch_block_top2(const void* q, const void* qsc, const void* x, const void* rs,
                      const void* bias, void* s_out, void* r_out, int nq, int n,
                      int d, int block_rows, float coef, void* stream) {
  // bytes of a query row and of a corpus row, read in 16-byte vectors
  const int q_row = V == kBf16 ? 2 * d : d;
  const int x_row = V == kInt8 ? d : V == kInt4 ? d / 2 : 2 * d;
  if (nq < 1 || d < 1 || d > kMaxDim || q_row % 16 != 0 || x_row % 16 != 0 ||
      block_rows < kLanes || block_rows % kLanes != 0 || n < block_rows ||
      n % block_rows != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = kQueryTile * (V == kBf16 ? 4 * d : d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_top2_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nb = n / block_rows;
  dim3 grid((nq + kQueryTile - 1) / kQueryTile, nb);
  block_top2_kernel<V><<<grid, kLanes, smem, (cudaStream_t)stream>>>(
      q, (const float*)qsc, x, (const float*)rs, (const float*)bias,
      (float*)s_out, (int*)r_out, nq, d, block_rows, nb, coef);
  return (int)cudaGetLastError();
}

// One thread per (query, lane class): walk the blocks in ascending order and
// insert each block's (mn1, row1) then (mn2, row2) into a sorted 8-deep
// stack held in registers.  Output column 128 * k + lane is the k-th best.
__global__ void __launch_bounds__(kLanes)
lane8_merge_kernel(const float* __restrict__ s_in,   // [nq, nb * 256]
                   const int* __restrict__ r_in,     // [nq, nb * 256]
                   float* __restrict__ s_out,        // [nq, 1024]
                   int* __restrict__ r_out,          // [nq, 1024]
                   int nb) {
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  float s[8];
  int r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = __int_as_float(0x7f800000);
    r[k] = 0;
  }
  const size_t row0 = (size_t)q * nb * 256 + lane;
  for (int blk = 0; blk < nb; ++blk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = row0 + (size_t)blk * 256 + h * kLanes;
      float cs = __ldg(s_in + at);
      int cr = __ldg(r_in + at);
      // Once the new candidate has its slot, every entry below it moves down
      // one place.  A compare-exchange cascade with '<' alone (merge_top8)
      // lets a displaced entry skip an equal later one, which breaks the
      // "earlier candidate first" order among ties; shifting keeps the stack
      // a stable sort of the candidates seen so far.
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
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s_out[(size_t)q * 1024 + k * kLanes + lane] = s[k];
    r_out[(size_t)q * 1024 + k * kLanes + lane] = r[k];
  }
}

}  // namespace

extern "C" {

// The block pass over int8 codes x [n, d] (q: int8 codes [nq, d]).
int annlite_block_top2(const void* q8, const void* qsc, const void* x,
                       const void* rs, const void* bias, void* s_out,
                       void* r_out, int nq, int n, int d, int block_rows,
                       float coef, void* stream) {
  return launch_block_top2<kInt8>(q8, qsc, x, rs, bias, s_out, r_out, nq, n, d,
                                  block_rows, coef, stream);
}

// The block pass over packed int4 x [n, d/2] (q: int8 codes [nq, d]).
int annlite_block_top2_int4(const void* q8, const void* qsc, const void* x,
                            const void* rs, const void* bias, void* s_out,
                            void* r_out, int nq, int n, int d, int block_rows,
                            float coef, void* stream) {
  return launch_block_top2<kInt4>(q8, qsc, x, rs, bias, s_out, r_out, nq, n, d,
                                  block_rows, coef, stream);
}

// The block pass over bf16 x [n, d] (q: bf16 [nq, d]).
int annlite_block_top2_bf16(const void* qbf, const void* qsc, const void* x,
                            const void* rs, const void* bias, void* s_out,
                            void* r_out, int nq, int n, int d, int block_rows,
                            float coef, void* stream) {
  return launch_block_top2<kBf16>(qbf, qsc, x, rs, bias, s_out, r_out, nq, n, d,
                                  block_rows, coef, stream);
}

int annlite_lane8_merge(const void* s_in, const void* r_in, void* s_out,
                        void* r_out, int nq, int nb, void* stream) {
  if (nq < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  lane8_merge_kernel<<<nq, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)s_in, (const int*)r_in, (float*)s_out, (int*)r_out, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
