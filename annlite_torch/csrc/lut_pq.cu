// Per-query PQ table lookup for graph traversal, for Hopper (sm_90a).
//
// Replaces annlite_tpu/ops/adc.py:283 _lut_pq_kernel (K8), which the JAX
// package reaches through ops/beam.py make_pq_scorer: every beam iteration
// of a PQ-scored graph search scores each query's own candidate set
//     out[q, c] = sum_m dtable[q, m, codes[ids[q, c], m]],
// BIG where ids[q, c] < 0 or >= n.  The TPU gathered the candidates' code
// rows and applied the validity mask outside its kernel, and turned the
// lookup into a one-hot select-reduce for its vector unit.  Here the row
// gather and the mask are fused in, and the lookup stays a lookup.
//
// Design.  One CTA per query stages that query's float32 table in shared
// memory (64 KB at M = 64, K = 256); when it exceeds the 227 KB a block may
// use, it is tiled over subspaces as in csrc/adc.cu (one subspace must fit:
// K <= 58,112).  One thread per candidate reads the candidate's id, then its
// M code bytes (16-byte vector loads when the row allows it) and adds the
// table entries into a float32 register over m in order 0..M-1 with
// __fadd_rn: every score is 0 + t_0 + ... + t_{M-1}, as the plain version in
// annlite_torch/ops/adc.py computes it, so the two are bit-equal.
//
// Bound on an H100 SXM (3.35 TB/s): at Q = 64, C = 256, M = 64, K = 256 the
// tables (4 MB), the gathered codes (1 MB), the ids and the output are about
// 5.4 MB, 0.0016 ms; the Q*C*M additions are 1e6.  A beam iteration is far
// below what a launch costs, so the kernel is launch-bound.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: a block's shared memory limit
constexpr int kMaxThreads = 512;  // candidates scored at once by a CTA
constexpr float kBig = 3.4e38f;   // BIG of the Python side, in float32

// code j (compile-time after unrolling) of a 16-byte word of codes
template <typename CodeT>
__device__ __forceinline__ int code_at(const uint4& w, int j) {
  constexpr int kPerWord = 4 / (int)sizeof(CodeT);
  constexpr unsigned kMask = sizeof(CodeT) == 1 ? 0xffu : 0xffffu;
  const int word = j / kPerWord;
  const unsigned x = word == 0 ? w.x : word == 1 ? w.y : word == 2 ? w.z : w.w;
  return (int)((x >> (8 * (int)sizeof(CodeT) * (j % kPerWord))) & kMask);
}

// kVec: every code row is 16-byte aligned and the whole table is staged
// once (mc == m), so a thread reads its row with vector loads.
template <typename CodeT, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
lut_pq_kernel(const int* __restrict__ ids, const CodeT* __restrict__ codes,
              const float* __restrict__ dtable, float* __restrict__ out, int nc,
              int n, int m, int k, int mc) {
  extern __shared__ float tab[];  // [mc][k]
  const int q = blockIdx.x;
  const int nchunks = (m + mc - 1) / mc;
  for (int c0 = 0; c0 < nc; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const int id = c < nc ? __ldg(ids + (size_t)q * nc + c) : -1;
    const bool valid = id >= 0 && id < n;
    const CodeT* row = codes + (size_t)(valid ? id : 0) * m;
    float acc = 0.0f;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int m0 = ch * mc;
      const int mcur = min(mc, m - m0);
      // stage the chunk: once for the whole kernel when it holds every m
      if (nchunks > 1 || c0 == 0) {
        if (nchunks > 1) __syncthreads();
        const float* src = dtable + ((size_t)q * m + m0) * k;
        for (int i = threadIdx.x; i < mcur * k; i += blockDim.x) tab[i] = __ldg(src + i);
        __syncthreads();
      }
      if (!valid) continue;
      if (kVec) {
        constexpr int kPer = 16 / (int)sizeof(CodeT);
        const uint4* rp = reinterpret_cast<const uint4*>(row);
        for (int v = 0; v < m / kPer; ++v) {
          const uint4 w = __ldg(rp + v);
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            acc = __fadd_rn(acc, tab[(v * kPer + j) * k + code_at<CodeT>(w, j)]);
          }
        }
      } else {
        for (int mm = 0; mm < mcur; ++mm) {
          acc = __fadd_rn(acc, tab[mm * k + (int)__ldg(row + m0 + mm)]);
        }
      }
    }
    if (c < nc) out[(size_t)q * nc + c] = valid ? acc : kBig;
  }
}

template <typename CodeT>
int launch(const int* ids, const void* codes, const float* dtable, float* out, int nq,
           int nc, int n, int m, int k, cudaStream_t st) {
  const size_t per_m = (size_t)k * sizeof(float);
  const size_t fit = (size_t)kMaxSmem / per_m;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int mc = (int)(fit < (size_t)m ? fit : (size_t)m);
  const size_t smem = (size_t)mc * per_m;
  const bool vec = mc == m && ((size_t)m * sizeof(CodeT)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  int threads = ((nc + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  auto run = [&](auto kern) {
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<nq, threads, smem, st>>>(ids, static_cast<const CodeT*>(codes), dtable, out, nc,
                                   n, m, k, mc);
    return (int)cudaGetLastError();
  };
  return vec ? run(lut_pq_kernel<CodeT, true>) : run(lut_pq_kernel<CodeT, false>);
}

}  // namespace

extern "C" {

// K8: out[q, c] for ids [nq, nc] int32 into codes [n, m] (row-major, u8 when
// code_bytes == 1, u16 when 2) and dtable [nq, m, k] float32.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// geometry it does not take).
int annlite_lut_pq_scores(const void* ids, const void* codes, const void* dtable, void* out,
                          int nq, int nc, int n, int m, int k, int code_bytes,
                          void* stream) {
  if (nq < 1 || nc < 1 || n < 1 || m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* i = (const int*)ids;
  const float* d = (const float*)dtable;
  float* o = (float*)out;
  if (code_bytes == 1) return launch<uint8_t>(i, codes, d, o, nq, nc, n, m, k, st);
  if (code_bytes == 2) return launch<uint16_t>(i, codes, d, o, nq, nc, n, m, k, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
