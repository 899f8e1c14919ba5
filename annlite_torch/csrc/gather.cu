// Gather-rerank for Hopper (sm_90a): exact float32 distances between each
// query and its R shortlist rows.
//
// Replaces the Pallas kernel annlite_tpu/ops/gather.py:31
// (_gather_rerank_kernel, K3).  The TPU version fetches the whole 8-row HBM
// tile around each candidate and double-buffers the DMAs across queries,
// because a TPU cannot slice one row out of a tiled array.  A GPU reads one
// row directly, so none of that carries over.
//
// L2 returns sum((q - c)^2) directly, the better-conditioned form, which is
// what the plain version (_gather_rerank_ref) computes; inner product and
// cosine return 1 - q.c.  Out-of-range ids are clamped into [0, n).  Every
// product is a float32 FMA on the CUDA cores (no TF32); the sum's order is
// lane-strided, then a shuffle tree.
//
// What bounds it on an H100 SXM.  At Q = 64, R = 40, D = 768 the kernel must
// read 7.9 MB of rows, 2.4 us at 3.35 TB/s (R = 128: 25 MB, 7.5 us), but a
// flat search runs it once, so its time is latency: the launch, then two
// dependent DRAM reads (the candidate id, then its row) and the transfer.
// The first version held one CTA per query (64 CTAs on 132 SMs, one at
// Q = 1), staged the query in shared memory behind a barrier, and let each
// warp walk its R/8 candidates one after another, two DRAM latencies each.
// This design does three things about that:
//   1. One warp per (query, candidate) pair.  The pairs are numbered
//      query * R + candidate, which is also the index of the id and of the
//      output; ops/gather.py gather_plan picks the warps per CTA (8, or
//      fewer until the grid holds 132 CTAs), so Q = 64, R = 40 is 320 CTAs
//      and Q = 1 spreads its R warps over R SMs.
//   2. Every load before the first FMA.  A warp reads its id (one broadcast
//      load) and its query row (no barrier: after its first reader the row
//      sits in L1/L2), then issues all of its row's loads: D/128 float4 per
//      lane into registers, with the count fixed at compile time up to
//      D = 1024 (NV vectors per lane, the tail masked) and issued in groups
//      of kChunk by a loop above it.  So the kernel takes one id latency
//      and one row latency, whatever R is.  On an H100 SXM (700 W) it reads
//      0.0106 ms at Q = 64, R = 40, D = 768, against 0.0052 for an empty
//      launch and 0.0024 for the rows' bytes.
//   3. Scalar loads where D % 4 != 0 or a base is not 16-byte aligned, on
//      the same plan (NV scalars per lane, a power of two).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;     // warps (pairs) per CTA
constexpr int kMaxDim = 12288;   // the wrapper's limit (ops/gather.py MAX_GATHER_DIM)
constexpr int kChunk = 8;        // vectors a lane issues at once above the fixed plans

__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& v) { v = 0.f; }

__device__ __forceinline__ float term(float acc, float qv, float cv, int l2) {
  if (l2) {
    const float a = qv - cv;
    return fmaf(a, a, acc);
  }
  return fmaf(qv, cv, acc);
}
__device__ __forceinline__ float term(float acc, float4 qv, float4 cv, int l2) {
  acc = term(acc, qv.x, cv.x, l2);
  acc = term(acc, qv.y, cv.y, l2);
  acc = term(acc, qv.z, cv.z, l2);
  return term(acc, qv.w, cv.w, l2);
}

// Vectors [i0, i0 + NV * 32) of a lane's share (lane + 32 t): all loads,
// then the FMAs.  Vectors past dv load as zeros, which add nothing.
template <typename V, int NV>
__device__ __forceinline__ float dot_span(const V* qr, const V* xr, int i0, int dv, int lane,
                                          int l2, float acc) {
  V qv[NV], cv[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int i = i0 + lane + kWarp * t;
    if (i < dv) {
      qv[t] = load(qr + i);
      cv[t] = load(xr + i);
    } else {
      zero(qv[t]);
      zero(cv[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < NV; ++t) acc = term(acc, qv[t], cv[t], l2);
  return acc;
}

// Warp w of CTA b takes pair b * warps + w: query pair / r, its id and its
// output at index pair.  NV > 0: the fixed plan of NV vectors a lane; NV == 0:
// the loop, kChunk vectors a lane at a time.
template <typename V, int NV>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
gather_rerank_kernel(const float* __restrict__ q,     // [nq, d]
                     const float* __restrict__ x,     // [n, d]
                     const int* __restrict__ cand,    // [nq, r]
                     float* __restrict__ out,         // [nq, r]
                     int n, int d, int r, long long pairs, int l2) {
  const long long pair = (long long)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (pair >= pairs) return;
  const int lane = threadIdx.x % kWarp;
  constexpr int kPer = sizeof(V) / sizeof(float);
  const int dv = d / kPer;
  const V* qr = reinterpret_cast<const V*>(q + (size_t)(pair / r) * d);
  const int c = min(max(__ldg(cand + pair), 0), n - 1);
  const V* xr = reinterpret_cast<const V*>(x + (size_t)c * d);
  float acc = 0.0f;
  if constexpr (NV > 0) {
    acc = dot_span<V, NV>(qr, xr, 0, dv, lane, l2, acc);
  } else {
    for (int i0 = 0; i0 < dv; i0 += kWarp * kChunk) {
      acc = dot_span<V, kChunk>(qr, xr, i0, dv, lane, l2, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[pair] = l2 ? acc : 1.0f - acc;
}

template <typename V, int NV>
void launch(int grid, int warps, cudaStream_t st, const float* q, const float* x,
            const int* cand, float* out, int n, int d, int r, long long pairs, int l2) {
  gather_rerank_kernel<V, NV><<<grid, warps * kWarp, 0, st>>>(q, x, cand, out, n, d, r,
                                                             pairs, l2);
}

using Launch = void (*)(int, int, cudaStream_t, const float*, const float*, const int*,
                        float*, int, int, int, long long, int);

// The instance for d: float4 with NV = ceil(d / 128) up to D = 1024, scalars
// with NV = ceil(d / 32) rounded up to a power of two up to D = 1024, the
// loop above.
Launch pick(int d, int vec4) {
  if (vec4) {
    switch ((d / 4 + kWarp - 1) / kWarp) {
      case 1: return launch<float4, 1>;
      case 2: return launch<float4, 2>;
      case 3: return launch<float4, 3>;
      case 4: return launch<float4, 4>;
      case 5: return launch<float4, 5>;
      case 6: return launch<float4, 6>;
      case 7: return launch<float4, 7>;
      case 8: return launch<float4, 8>;
      default: return launch<float4, 0>;
    }
  }
  const int nv = (d + kWarp - 1) / kWarp;
  if (nv <= 1) return launch<float, 1>;
  if (nv <= 2) return launch<float, 2>;
  if (nv <= 4) return launch<float, 4>;
  if (nv <= 8) return launch<float, 8>;
  if (nv <= 16) return launch<float, 16>;
  if (nv <= 32) return launch<float, 32>;
  return launch<float, 0>;
}

}  // namespace

extern "C" {

// Launches `warps` warps per CTA (ops/gather.py gather_plan) on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a geometry the kernel
// does not take).  `vec4` asks for float4 loads: the caller checks that
// d % 4 == 0 and that q and x are 16-byte aligned.
int annlite_gather_rerank(const void* q, const void* x, const void* cand, void* out, int nq,
                          int n, int d, int r, int l2, int vec4, int warps, void* stream) {
  if (nq < 1 || n < 1 || d < 1 || d > kMaxDim || r < 1 || (vec4 && d % 4 != 0) ||
      warps < 1 || warps > kMaxWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const long long pairs = (long long)nq * r;
  const int grid = (int)((pairs + warps - 1) / warps);
  pick(d, vec4)(grid, warps, (cudaStream_t)stream, (const float*)q, (const float*)x,
                (const int*)cand, (float*)out, n, d, r, pairs, l2);
  return (int)cudaGetLastError();
}

// Registers and spilled bytes per thread of the instance that takes d.
int annlite_gather_info(int d, int vec4, int* out) {
  cudaFuncAttributes fa;
  const Launch f = pick(d, vec4);
  cudaError_t e = cudaErrorInvalidValue;
#define ANNLITE_INFO(V, NV) \
  if (f == launch<V, NV>) e = cudaFuncGetAttributes(&fa, gather_rerank_kernel<V, NV>);
  ANNLITE_INFO(float4, 1) ANNLITE_INFO(float4, 2) ANNLITE_INFO(float4, 3)
  ANNLITE_INFO(float4, 4) ANNLITE_INFO(float4, 5) ANNLITE_INFO(float4, 6)
  ANNLITE_INFO(float4, 7) ANNLITE_INFO(float4, 8) ANNLITE_INFO(float4, 0)
  ANNLITE_INFO(float, 1) ANNLITE_INFO(float, 2) ANNLITE_INFO(float, 4)
  ANNLITE_INFO(float, 8) ANNLITE_INFO(float, 16) ANNLITE_INFO(float, 32)
  ANNLITE_INFO(float, 0)
#undef ANNLITE_INFO
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return 0;
}

}  // extern "C"
