// Gather-rerank for Hopper (sm_90a): exact float32 distances between each
// query and its R shortlist rows.
//
// Replaces the Pallas kernel annlite_tpu/ops/gather.py:31
// (_gather_rerank_kernel, K3).  The TPU version fetches the whole 8-row HBM
// tile around each candidate and double-buffers the DMAs across queries,
// because a TPU cannot slice one row out of a tiled array.  A GPU reads one
// row directly, so none of that carries over: one CTA per query holds the
// query in shared memory, and each warp takes one candidate row at a time,
// reads it with coalesced float4 loads (scalar loads when D is not a
// multiple of 4 or the rows are not 16-byte aligned), forms the float32
// result with FMAs (no TF32) and reduces it with shuffles.
//
// L2 returns sum((q - c)^2) directly, the better-conditioned form, which is
// what the plain version (_gather_rerank_ref) computes; inner product and
// cosine return 1 - q.c.  Out-of-range ids are clamped into [0, n).
//
// Bound on an H100 SXM (3.35 TB/s): at Q = 64, R = 40, D = 768 the kernel
// must read 7.9 MB of rows, 2.3 us; in practice a launch costs more.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 12288;  // the query row in 48 KB of shared memory

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
gather_rerank_kernel(const float* __restrict__ q,     // [nq, d]
                     const float* __restrict__ x,     // [n, d]
                     const int* __restrict__ cand,    // [nq, r]
                     float* __restrict__ out,         // [nq, r]
                     int n, int d, int r, int l2) {
  extern __shared__ float4 qsh4[];
  float* qsh = reinterpret_cast<float*>(qsh4);
  const int qi = blockIdx.x;
  for (int i = threadIdx.x; i < d; i += kThreads) qsh[i] = q[(size_t)qi * d + i];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = warp; j < r; j += kThreads / 32) {
    const int c = min(max(cand[(size_t)qi * r + j], 0), n - 1);
    const float* xr = x + (size_t)c * d;
    float acc = 0.0f;
    if (kVec4) {
      const float4* xr4 = reinterpret_cast<const float4*>(xr);
      for (int i = lane; i < d / 4; i += 32) {
        const float4 cv = __ldg(xr4 + i);
        const float4 qv = qsh4[i];
        if (l2) {
          const float a = qv.x - cv.x, b = qv.y - cv.y;
          const float e = qv.z - cv.z, f = qv.w - cv.w;
          acc = fmaf(a, a, acc);
          acc = fmaf(b, b, acc);
          acc = fmaf(e, e, acc);
          acc = fmaf(f, f, acc);
        } else {
          acc = fmaf(qv.x, cv.x, acc);
          acc = fmaf(qv.y, cv.y, acc);
          acc = fmaf(qv.z, cv.z, acc);
          acc = fmaf(qv.w, cv.w, acc);
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float cv = __ldg(xr + i);
        if (l2) {
          const float a = qsh[i] - cv;
          acc = fmaf(a, a, acc);
        } else {
          acc = fmaf(qsh[i], cv, acc);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[(size_t)qi * r + j] = l2 ? acc : 1.0f - acc;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for a geometry the kernel does not take).  `vec4` asks for float4 row
// loads: the caller checks that d % 4 == 0 and that x is 16-byte aligned.
int annlite_gather_rerank(const void* q, const void* x, const void* cand,
                          void* out, int nq, int n, int d, int r, int l2,
                          int vec4, void* stream) {
  if (nq < 1 || n < 1 || d < 1 || d > kMaxDim || r < 1 || (vec4 && d % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)d * sizeof(float);
  if (vec4) {
    gather_rerank_kernel<true><<<nq, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)x, (const int*)cand, (float*)out, n, d, r, l2);
  } else {
    gather_rerank_kernel<false><<<nq, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)x, (const int*)cand, (float*)out, n, d, r, l2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
