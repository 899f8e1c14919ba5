// One persistent beam search per query over the resident rows, for Hopper
// (sm_90a).
//
// Replaces the port's eager vector traversal (annlite_torch/ops/beam.py
// _beam_loop with make_vector_scorer, the port of annlite_tpu/ops/beam.py
// _beam_vec): the TPU ran that loop as one lax.while_loop under jit with an
// einsum scorer, outside any Pallas kernel; the eager loop issues ~65
// PyTorch ops an iteration (cumsum, sorts, gathers, the scorer's gather and
// reduce), ~540 launches for a batch-64 search at ef 50, and the host, not
// the card, sets its pace.  Here one CTA runs one query's whole search, on
// the loop body beam_pq.cu runs (csrc/beam.cuh: seed, frontier, expansion,
// both stable merge sorts in shared memory, one launch).
//
// The scorer: the query row (dim float32) is staged in shared memory once.
// A candidate's row is read by a group of g lanes (g = the row's 16-byte
// loads rounded up to a power of two, at most 32: a warp a row at D = 128
// float32, half a warp at D = 128 bf16), neighbouring lanes on neighbouring
// 16-byte words; each lane issues the loads of kU candidates before the
// first FMA, then the group sums its lanes by shuffles.  Rows whose width
// is not a whole number of 16-byte words, or whose base is not aligned, are
// read element by element (kVec false).  Rows are float32 or bf16 (the
// facade's copy beside a PQ codec); sums are float32:
//   euclidean      sum_d (q - v)^2, the eager scorer's own form, never
//                  |q|^2 + |v|^2 - 2 q.v (on integer rows below 2^24 every
//                  partial sum is exact, so any order gives its bits);
//   inner product  1 - sum_d q * v (cosine: the caller normalised the rows);
//   an id < 0 or >= n scores BIG.
//
// Bound on an H100 SXM (3.35 TB/s) at Q = 64, N = 262,144, D = 128 float32,
// ef 50, B 16, degree 48, ~8 iterations: at most 8 * 768 candidate rows of
// 512 bytes a query, ~200 MB for the batch, 0.06 ms; pads (-1) and repeated
// ids read less.  Every iteration reads the adjacency rows and then,
// dependent on them, the candidates' rows: two dependent global reads an
// iteration, some 10-20 us for 8 iterations whatever the bandwidth.  One CTA
// per query leaves SMs idle at small Q.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "beam.cuh"

namespace {

using beam::kBig;

constexpr int kU = 8;  // candidates whose loads a lane issues before its FMAs

struct Args {
  beam::Loop lp;
  const void* rows;       // [n, dim] float32 or bf16
  const float* queries;   // [nq, dim]
  int dim, lanes, euclid;
};

__host__ __device__ __forceinline__ size_t query_bytes(int dim) {
  return ((size_t)dim * sizeof(float) + 15) & ~(size_t)15;
}

// kBytes: 4 for float32 rows, 2 for bf16.  kVec: 16-byte loads of
// kPer elements, else one element a load.
template <int kBytes, bool kVec>
struct VecScorer {
  static constexpr int kPer = kVec ? 16 / kBytes : 1;
  using Unit = typename std::conditional<kVec, uint4, uint32_t>::type;

  const unsigned char* rows;
  const float* q;  // shared memory
  int n, dim, g;
  bool euclid;

  __device__ __forceinline__ Unit load(int id, int v) const {
    const unsigned char* row = rows + (size_t)id * dim * kBytes;
    if constexpr (kVec) {
      return __ldg(reinterpret_cast<const uint4*>(row) + v);
    } else if constexpr (kBytes == 4) {
      return __ldg(reinterpret_cast<const unsigned int*>(row) + v);
    } else {
      return (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(row) + v) << 16;
    }
  }

  __device__ __forceinline__ float step(float acc, float qx, float vx) const {
    const float diff = qx - vx;
    return euclid ? fmaf(diff, diff, acc) : fmaf(qx, vx, acc);
  }

  // acc plus the terms of load v (elements v * kPer ..)
  __device__ __forceinline__ float terms(float acc, const Unit& w, int v) const {
    const float* qv = q + v * kPer;
    if constexpr (!kVec) {
      return step(acc, qv[0], __uint_as_float(w));
    } else {
      const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kBytes == 4) {
          acc = step(acc, qv[j], __uint_as_float(x[j]));
        } else {
          acc = step(acc, qv[2 * j], __uint_as_float(x[j] << 16));
          acc = step(acc, qv[2 * j + 1], __uint_as_float(x[j] & 0xffff0000u));
        }
      }
      return acc;
    }
  }

  // Warp w scores the candidates t = w + nwarps * j: lane l reads the id of
  // the warp's candidate j0 + l, and the 32 / g groups of g lanes take kU
  // candidates each a round.
  template <class IdOf>
  __device__ __forceinline__ void score(int count, IdOf id_of, float* d, uint32_t* dk) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int per = 32 / g;         // candidates side by side in a warp
    const int sub = lane / g;       // this lane's group
    const int gl = lane & (g - 1);  // this lane's place in its group
    const int nv = dim / kPer;      // loads a row
    const int mine = count > warp ? (count - warp + nwarps - 1) / nwarps : 0;
    for (int j0 = 0; j0 < mine; j0 += 32) {
      const int chunk = min(32, mine - j0);
      const int my_id = lane < chunk ? id_of(warp + nwarps * (j0 + lane)) : -1;
      for (int c0 = 0; c0 < chunk; c0 += per * kU) {
        int id[kU];
        bool ok[kU];
        float acc[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = c0 + sub + per * u;
          id[u] = __shfl_sync(0xffffffffu, my_id, c & 31);
          ok[u] = c < chunk && id[u] >= 0 && id[u] < n;
          acc[u] = 0.0f;
        }
        for (int v = gl; v < nv; v += g) {
          Unit w[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) w[u] = ok[u] ? load(id[u], v) : Unit{};
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (ok[u]) acc[u] = terms(acc[u], w[u], v);
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          for (int off = g >> 1; off > 0; off >>= 1) {
            acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
          }
        }
        if (gl == 0) {
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int c = c0 + sub + per * u;
            if (c < chunk) {
              const float dist = !ok[u] ? kBig : euclid ? acc[u] : 1.0f - acc[u];
              beam::put(d, dk, warp + nwarps * (j0 + c), id[u], dist);
            }
          }
        }
      }
    }
  }
};

// kFilter: a filtered search (beam.cuh), the k best passing rows out.
template <int kBytes, bool kVec, int E, bool kFilter>
__global__ void __launch_bounds__(beam::kMaxThreads) beam_vec_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  const float* qg = a.queries + (size_t)blockIdx.x * a.dim;
  for (int i = threadIdx.x; i < a.dim; i += blockDim.x) qs[i] = __ldg(qg + i);
  __syncthreads();
  const VecScorer<kBytes, kVec> sc{static_cast<const unsigned char*>(a.rows), qs, a.lp.n,
                                   a.dim, a.lanes, a.euclid != 0};
  beam::search<E, kFilter>(a.lp, sc, smem + query_bytes(a.dim));
}

template <int kBytes, bool kVec, int E, bool kFilter>
int run(const Args& a, int nq, cudaStream_t st) {
  const size_t smem = query_bytes(a.dim) + beam::state_bytes(a.lp.p, a.lp.B) +
                      (kFilter ? (size_t)a.lp.k * 8 : 0);
  if (smem > (size_t)beam::kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = beam_vec_kernel<kBytes, kVec, E, kFilter>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<nq, a.lp.p / E, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int kBytes, bool kVec, bool kFilter>
int run_e(const Args& a, int nq, int e, cudaStream_t st) {
  if (e == 2) return run<kBytes, kVec, 2, kFilter>(a, nq, st);
  if (e == 4) return run<kBytes, kVec, 4, kFilter>(a, nq, st);
  return run<kBytes, kVec, 8, kFilter>(a, nq, st);
}

template <int kBytes, bool kVec>
int run_f(const Args& a, int nq, int e, cudaStream_t st) {
  return a.lp.pass != nullptr ? run_e<kBytes, kVec, true>(a, nq, e, st)
                              : run_e<kBytes, kVec, false>(a, nq, e, st);
}

template <int kBytes>
int launch(Args a, int nq, int e, cudaStream_t st) {
  const bool vec = ((size_t)a.dim * kBytes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.rows) % 16 == 0;
  const int nv = vec ? a.dim * kBytes / 16 : a.dim;
  a.lanes = 1;
  while (a.lanes < 32 && a.lanes < nv) a.lanes <<= 1;
  return vec ? run_f<kBytes, true>(a, nq, e, st) : run_f<kBytes, false>(a, nq, e, st);
}

}  // namespace

extern "C" {

// The whole vector beam search of nq queries: adjacency [n, r] int32,
// entries [nq, e] int32, rows [n, dim] (float32 when row_bytes == 4, bf16
// when 2), queries [nq, dim] float32 -> d_out [nq, k] float32, id_out [nq,
// k] int32 and, when not null, iters_out [nq] int32 (the iterations each
// query ran).  euclid: squared L2, else 1 - inner product.  pass: null, or
// the predicate of a filtered search, n_pass bytes (nonzero: the row
// passes); d_out and id_out then hold the k best passing rows scored, by
// (distance, id), padded with (BIG, NO_ID).  The plan (sort
// slots p, threads) comes from ops/beam.py beam_vec_plan: p a power of two
// >= max(64, L + B * r), each thread holding p / threads (2, 4 or 8) sort
// keys.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry it does not take).
int annlite_beam_vec(const void* adj, const void* entry, const void* rows, const void* queries,
                     const void* pass, void* d_out, void* id_out, void* iters_out, int n, int r,
                     int e, int dim, int nq, int L, int B, int iters, int k, int row_bytes,
                     int euclid, int n_pass, int p, int threads, void* stream) {
  Args a;
  a.lp.adj = static_cast<const int*>(adj);
  a.lp.entry = static_cast<const int*>(entry);
  a.lp.d_out = static_cast<float*>(d_out);
  a.lp.id_out = static_cast<int*>(id_out);
  a.lp.iters_out = static_cast<int*>(iters_out);
  a.lp.pass = static_cast<const unsigned char*>(pass);
  a.lp.n_pass = n_pass;
  a.lp.n = n;
  a.lp.r = r;
  a.lp.e = e;
  a.lp.L = L;
  a.lp.B = B;
  a.lp.iters = iters;
  a.lp.k = k;
  a.lp.p = p;
  a.rows = rows;
  a.queries = static_cast<const float*>(queries);
  a.dim = dim;
  a.lanes = 1;
  a.euclid = euclid;
  if (!beam::loop_ok(a.lp, nq, threads) || dim < 1 || (pass != nullptr && n_pass < 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int per = p / threads;  // sort keys per thread
  const cudaStream_t st = (cudaStream_t)stream;
  if (row_bytes == 4) return launch<4>(a, nq, per, st);
  if (row_bytes == 2) return launch<2>(a, nq, per, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
