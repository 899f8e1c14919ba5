// Fused int8 scan with in-kernel candidate selection, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of annlite_tpu/ops/fused_scan.py:
//   * _fused_scan_kernel (K2, :99): per block of 8192 corpus rows, the
//     bucketed top-2 of each (query, row mod 128) bucket -> block_top2 here;
//   * _fused_scan8_kernel (K1, :121): the same block pass plus a running
//     sorted top-8 per (query, lane class) across all blocks (merge_top8,
//     :159) -> block_top2 followed by lane8_merge here.
// On the TPU the grid runs in order, so K1 carries the top-8 stack in VMEM
// from one block to the next.  CUDA blocks run in no order, so K1 is two
// passes: the block pass writes [Q, nb*256] candidates (about 2% of the
// corpus bytes: 16.8 MB against 805 MB at 2^20 x 768, Q = 64) and one
// thread per (query, lane) merges them in block order.
//
// Bound on an H100 SXM (3.35 TB/s, 1979 int8 TOPS): at Q = 64, N = 2^20,
// D = 768 the block pass must read ~814 MB (int8 rows, row scales, biases),
// 0.243 ms, while its 1.03e11 int8 operations take 0.052 ms on the tensor
// cores: memory-bound.  This first version scores with __dp4a on the CUDA
// cores (no tensor cores), which makes it compute-bound well above the
// memory bound; a wgmma version is later work.  Its design does about the
// bound only this much: each corpus row is read once per 16-query tile, and
// the tiles of one row block are neighbouring CTAs (blockIdx.x is the query
// tile), so they share the rows through L2.
//
// Exactness.  The i8 x i8 products accumulate in i32, exactly.  Scores are
// bias + coef * ((acc * qsc) * rs) in this order, each step rounded on its
// own (__fmul_rn / __fadd_rn cannot be contracted into an FMA), which is the
// order of the JAX kernel and of the plain versions (_fused_scan_ref in
// annlite_torch/ops/fused_scan.py): the scores are bit-equal to them.
// Selection is sequential in ascending group order with strict '<', which
// reproduces _block_top2's rules (lowest group wins a tie).  The merge keeps
// the rule of _fused_scan8_ref (a stable sort: an earlier candidate wins a
// tie) for every tie; see lane8_merge_kernel for where merge_top8 departs
// from it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;          // row r of a block is in bucket r % 128
constexpr int kQueryTile = 16;       // queries per CTA
constexpr int kMaxDim = 3072;        // kQueryTile * kMaxDim bytes = 48 KB

__global__ void __launch_bounds__(kLanes)
block_top2_kernel(const int8_t* __restrict__ q8,     // [nq, d]
                  const float* __restrict__ qsc,     // [nq]
                  const int8_t* __restrict__ x,      // [n, d]
                  const float* __restrict__ rs,      // [n]
                  const float* __restrict__ bias,    // [n]
                  float* __restrict__ s_out,         // [nq, nb * 256]
                  int* __restrict__ r_out,           // [nq, nb * 256]
                  int nq, int d, int block_rows, int nb, float coef) {
  __shared__ int4 qtile[kQueryTile * kMaxDim / 16];
  const int q0 = blockIdx.x * kQueryTile;
  const int blk = blockIdx.y;
  const int lane = threadIdx.x;
  const int dv = d / 16;  // 16-byte chunks per row
  const int nqt = min(kQueryTile, nq - q0);

  const int4* qsrc = reinterpret_cast<const int4*>(q8 + (size_t)q0 * d);
  for (int i = lane; i < kQueryTile * dv; i += kLanes) {
    qtile[i] = i < nqt * dv ? qsrc[i] : make_int4(0, 0, 0, 0);
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

  const int groups = block_rows / kLanes;
  const size_t base = (size_t)blk * block_rows;
  for (int g = 0; g < groups; ++g) {
    const size_t row = base + (size_t)g * kLanes + lane;
    const int4* xr = reinterpret_cast<const int4*>(x + row * d);
    int acc[kQueryTile];
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) acc[j] = 0;
    for (int c = 0; c < dv; ++c) {
      const int4 xv = __ldg(xr + c);
#pragma unroll
      for (int j = 0; j < kQueryTile; ++j) {
        const int4 qv = qtile[j * dv + c];
        acc[j] = __dp4a(xv.x, qv.x, acc[j]);
        acc[j] = __dp4a(xv.y, qv.y, acc[j]);
        acc[j] = __dp4a(xv.z, qv.z, acc[j]);
        acc[j] = __dp4a(xv.w, qv.w, acc[j]);
      }
    }
    const float r_s = __ldg(rs + row);
    const float b = __ldg(bias + row);
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) {
      const float dots = __fmul_rn(__int2float_rn(acc[j]), qscale[j]);
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

// Checks its geometry, launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry the kernel does not take).
int annlite_block_top2(const void* q8, const void* qsc, const void* x,
                       const void* rs, const void* bias, void* s_out,
                       void* r_out, int nq, int n, int d, int block_rows,
                       float coef, void* stream) {
  if (nq < 1 || d < 16 || d % 16 != 0 || d > kMaxDim || block_rows < kLanes ||
      block_rows % kLanes != 0 || n < block_rows || n % block_rows != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = n / block_rows;
  dim3 grid((nq + kQueryTile - 1) / kQueryTile, nb);
  block_top2_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q8, (const float*)qsc, (const int8_t*)x,
      (const float*)rs, (const float*)bias, (float*)s_out, (int*)r_out, nq, d,
      block_rows, nb, coef);
  return (int)cudaGetLastError();
}

int annlite_lane8_merge(const void* s_in, const void* r_in, void* s_out,
                        void* r_out, int nq, int nb, void* stream) {
  if (nq < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  lane8_merge_kernel<<<nq, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)s_in, (const int*)r_in, (float*)s_out, (int*)r_out, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
