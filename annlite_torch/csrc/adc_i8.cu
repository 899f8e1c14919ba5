// ADC scores with an int8 table, for Hopper (sm_90a).
//
// Replaces annlite_tpu/ops/adc_i8.py:56 _adc_i8_kernel (K9):
//     out[q, n] = float(sum_m t8[q, m, codes[m, n]]) * scale[q] + offset[q],
// BIG where mask[n] is 0, with t8 the int8 table that ops/adc_i8.py
// quantize_dtable makes (centred per (q, m), one scale per q).  The TPU ran
// the lookup as one-hot int8 matrix products on its matrix unit; here it is
// a lookup: each CTA stages one query's int8 table in shared memory (16 KB
// at M = 64, K = 256; tiled over subspaces above 227 KB, as csrc/adc.cu),
// codes are transposed [M, N] so neighbouring threads read neighbouring
// bytes, and each thread adds table entries for kRows rows into int32
// registers.  The integer sum is exact (|acc| <= 127 * M) and does not
// depend on the order; the epilogue is __fadd_rn(__fmul_rn(acc, scale),
// offset), the plain version's two roundings, so the two are bit-equal.
//
// Bound on an H100 SXM (3.35 TB/s): at Q = 64, N = 2^20, M = 64 the codes
// (64 MB) and the float32 scores (256 MB) are the same bytes as K5's, about
// 0.10 ms; the Q*N*M integer additions are 4.3e9.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;          // rows a thread scores per table pass
constexpr int kTile = kThreads * kRows;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's shared memory limit
constexpr float kBig = 3.4e38f;   // BIG of the Python side, in float32

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
adc_i8_kernel(const int8_t* __restrict__ t8, const CodeT* __restrict__ codes,
              const int8_t* __restrict__ mask, const float* __restrict__ scale,
              const float* __restrict__ offset, float* __restrict__ out, int n, int m,
              int k, int mc, int rows_per_cta) {
  extern __shared__ int8_t tab[];  // [mc][k]
  const int q = blockIdx.y;
  const int nchunks = (m + mc - 1) / mc;
  const float sc = __ldg(scale + q);
  const float off = __ldg(offset + q);
  const int lo = blockIdx.x * rows_per_cta;
  const int hi = min(n, lo + rows_per_cta);
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    int acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int m0 = ch * mc;
      const int mcur = min(mc, m - m0);
      // stage the chunk: once for the whole CTA when it holds every m
      if (nchunks > 1 || t0 == lo) {
        if (nchunks > 1) __syncthreads();
        const int8_t* src = t8 + ((size_t)q * m + m0) * k;
        for (int i = threadIdx.x; i < mcur * k; i += kThreads) tab[i] = src[i];
        __syncthreads();
      }
      for (int mm = 0; mm < mcur; ++mm) {
        const CodeT* cp = codes + (size_t)(m0 + mm) * n;
        const int8_t* t = tab + mm * k;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = t0 + r * kThreads + threadIdx.x;
          if (row < hi) acc[r] += t[(int)__ldg(cp + row)];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = t0 + r * kThreads + threadIdx.x;
      if (row < hi) {
        out[(size_t)q * n + row] =
            __ldg(mask + row) > 0 ? __fadd_rn(__fmul_rn((float)acc[r], sc), off) : kBig;
      }
    }
  }
}

template <typename CodeT>
int launch(const void* t8, const void* codes, const void* mask, const void* scale,
           const void* offset, void* out, int nq, int m, int k, int n, cudaStream_t st) {
  const size_t fit = (size_t)kMaxSmem / (size_t)k;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int mc = (int)(fit < (size_t)m ? fit : (size_t)m);
  const size_t smem = (size_t)mc * k;
  // rows per CTA: 16 tiles, fewer until the grid holds two CTAs per SM
  int rows = 16 * kTile;
  while (rows > kTile && (long long)nq * ((n + rows - 1) / rows) < 264) rows /= 2;
  auto kern = adc_i8_kernel<CodeT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)nq);
  kern<<<grid, kThreads, smem, st>>>(
      (const int8_t*)t8, (const CodeT*)codes, (const int8_t*)mask, (const float*)scale,
      (const float*)offset, (float*)out, n, m, k, mc, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K9: out[q, n] from t8 [nq, m, k] int8, codes_t [m, n] (u8 when code_bytes
// == 1, u16 when 2), mask [n] int8, scale and offset [nq] float32.  Launches
// on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// geometry it does not take).
int annlite_adc_i8_scores(const void* t8, const void* codes_t, const void* mask,
                          const void* scale, const void* offset, void* out, int nq, int m,
                          int k, int n, int code_bytes, void* stream) {
  if (nq < 1 || nq > 65535 || m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1)
    return launch<uint8_t>(t8, codes_t, mask, scale, offset, out, nq, m, k, n, st);
  if (code_bytes == 2)
    return launch<uint16_t>(t8, codes_t, mask, scale, offset, out, nq, m, k, n, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
