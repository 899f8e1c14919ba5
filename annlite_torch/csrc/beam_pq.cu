// One persistent beam search per query over PQ codes, for Hopper (sm_90a).
//
// Replaces annlite_tpu/ops/adc.py:283 _lut_pq_kernel (K8) together with the
// loop that calls it, annlite_tpu/ops/beam.py:149 _beam_loop with the PQ
// scorer.  The TPU ran the loop as one lax.while_loop under jit and scored
// each iteration's candidates with a one-hot select-reduce; the port's eager
// loop (annlite_torch/ops/beam.py _beam_loop) launches ~35 PyTorch ops and
// one K8 (csrc/lut_pq.cu) per iteration, ~5,800 kernels per search, and
// restages every query's table from HBM on each of them.  Here one CTA runs
// one query's whole search: the table, the candidate list and the sort
// buffers stay in shared memory from the seed to the result, and the host
// reads nothing until the search ends.
//
// What it computes, per query (the contracts of _beam_loop):
//   seed      score the E entry ids; an id scoring >= BIG becomes NO_ID; pad
//             with (BIG, NO_ID, exp 0) to L; stable sort by distance.
//   frontier  the first B slots in list order with exp == 0 and d < BIG;
//             each is marked expanded.  None left: the query stops (such an
//             iteration would leave the list as it is).
//   expand    adjacency[sel] row by row, in (slot, r) order; each id scores
//             sum_m dtable[q, m, codes[id, m]] from 0.0f over m = 0..M-1 in
//             order with __fadd_rn (lut_pq.cu's order: bit-equal to
//             _lut_pq_scores_ref), BIG for an id < 0 or >= n; then NO_ID
//             wherever d >= BIG.
//   merge     the list (L) and the new entries (B*R): a stable sort by
//             dkey = id*2 + (1 - exp); d = BIG for an entry whose id equals
//             its predecessor's and for id >= NO_ID; a stable sort by d; the
//             first L stay.
// Each stable sort is a bitonic sort of unique 64-bit keys (value << 32 |
// position) over P = next_pow2(L + B*R) slots (at least 64), padding keys
// all ones, held in registers, 2 to 8 a thread: equal values keep their
// positions' order, so the sort is stable and the tail of
// the list (the dedup's losing copies, then NO_IDs) comes out as the eager
// loop's.  A distance keys as its order-preserving uint32 image; no score is
// -0.0 (a sum that starts from +0.0 rounds to nearest), so the image maps
// back to the same bits.  An entry is its dkey (id and exp in one word) and
// its distance; the first sort's keys carry the dkey, the second's the
// distance, and the result is read back from both.
//
// Shared memory: the [M, K] float32 table (64 KB at M = 64, K = 256), staged
// once by one cp.async.bulk on an mbarrier (M * K a multiple of 4, as the
// plan asks), and 24 bytes per sort slot (two
// key buffers for the sorts' long strides and the first sort's result, the
// entries' distances and dkeys): 12 KB at P = 512.  A table
// that does not fit beside the state (u16 codes at K = 1024: 256 KB) is read
// from global memory, where it stays in L2: the same kernel, kSmemTab false.
//
// Bound on an H100 SXM (3.35 TB/s) at Q = 64, M = 64, K = 256 (u8), ef 128,
// B 8, R 32, 32 iterations: the tables (4.2 MB), the code rows (33.5 MB) and
// adjacency rows (2.1 MB) of the candidates, ~40 MB, 0.012 ms; the lookups
// (64 * 32 * 256 * 64 of 4 bytes in shared memory) ~0.004 ms.  Every
// iteration reads an adjacency row and then, dependent on it, the code rows:
// two dependent global reads, so 32 iterations take some 40-65 us whatever
// the bandwidth.  One CTA per query leaves SMs idle at small Q.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: a block's shared memory limit
constexpr int kMaxThreads = 512;
constexpr float kBig = 3.4e38f;   // BIG of the Python side, in float32
constexpr uint32_t kNoId = 1u << 29;
constexpr uint64_t kPad = ~0ull;  // sorts after every real key

struct Args {
  const int* adj;       // [n, r]
  const int* entry;     // [nq, e]
  const void* codes;    // [n, m] u8 or u16
  const float* dtable;  // [nq, m, kc]
  float* d_out;         // [nq, k]
  int* id_out;          // [nq, k]
  int* iters_out;       // [nq] or null
  int n, r, e, m, kc, L, B, iters, k, p;
};

// The shared-memory layout: the table (rounded to 16 bytes), then 24 bytes
// per sort slot (key1, key2, the entries' distances and dkeys), the
// selection and its count, one mbarrier.
__host__ __device__ __forceinline__ size_t table_bytes(const Args& a) {
  return ((size_t)a.m * a.kc * sizeof(float) + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t barrier_offset(const Args& a, bool smem_tab) {
  return (smem_tab ? table_bytes(a) : 0) + (size_t)a.p * 24 + ((size_t)a.B + 1 + 1) / 2 * 8;
}

// order-preserving uint32 image of a float32 (-0.0 folded to +0.0)
__device__ __forceinline__ uint32_t fkey(float d) {
  const uint32_t b = __float_as_uint(d == 0.0f ? 0.0f : d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float funkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// code j (compile-time after unrolling) of a 16-byte word of codes
template <typename CodeT>
__device__ __forceinline__ int code_at(const uint4& w, int j) {
  constexpr int kPerWord = 4 / (int)sizeof(CodeT);
  constexpr unsigned kMask = sizeof(CodeT) == 1 ? 0xffu : 0xffffu;
  const int word = j / kPerWord;
  const unsigned x = word == 0 ? w.x : word == 1 ? w.y : word == 2 ? w.z : w.w;
  return (int)((x >> (8 * (int)sizeof(CodeT) * (j % kPerWord))) & kMask);
}

// a table entry: from shared memory, or through the read-only path from L2
template <bool kSmemTab>
__device__ __forceinline__ float entry_at(const float* tab, int i) {
  return kSmemTab ? tab[i] : __ldg(tab + i);
}

// sum_m tab[m * kc + codes[id, m]] in order, BIG for an id outside [0, n).
// kVec: the code rows are 16-byte aligned, read as uint4 words.
template <typename CodeT, bool kVec, bool kSmemTab>
__device__ __forceinline__ float score(const Args& a, const float* tab, int id) {
  if (id < 0 || id >= a.n) return kBig;
  const CodeT* row = static_cast<const CodeT*>(a.codes) + (size_t)id * a.m;
  float acc = 0.0f;
  if (kVec) {
    constexpr int kPer = 16 / (int)sizeof(CodeT);
    const uint4* rp = reinterpret_cast<const uint4*>(row);
    for (int v = 0; v < a.m / kPer; ++v) {
      const uint4 w = __ldg(rp + v);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int at = (v * kPer + j) * a.kc + code_at<CodeT>(w, j);
        acc = __fadd_rn(acc, entry_at<kSmemTab>(tab, at));
      }
    }
  } else {
    for (int mm = 0; mm < a.m; ++mm) {
      acc = __fadd_rn(acc, entry_at<kSmemTab>(tab, mm * a.kc + (int)__ldg(row + mm)));
    }
  }
  return acc;
}

__device__ __forceinline__ void keep(uint64_t& x, uint64_t y, bool keep_min) {
  x = (x < y) == keep_min ? x : y;
}

// Ascending bitonic sort of p = E * blockDim.x keys, E to a thread: key j of
// thread t is element t * E + j.  A step of stride s pairs element e with
// e ^ s; a stride below E stays in the thread's registers, one below 32 E
// exchanges with lane t ^ (s / E) of the same warp, and only a longer one
// goes through shared memory (xbuf, p keys), 6 of the 45 steps at p = 512,
// E = 2.  Ends without a CTA barrier when p <= 32 E.
template <int E>
__device__ void bitonic(uint64_t (&k)[E], int p, uint64_t* xbuf) {
  const int t = threadIdx.x;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < E) {
#pragma unroll
        for (int sb = 1; sb < E; sb <<= 1) {
          if (stride != sb) continue;
#pragma unroll
          for (int j = 0; j < E; ++j) {
            if (j & sb) continue;
            const uint64_t x = k[j], y = k[j | sb];
            const bool asc = ((t * E + j) & size) == 0;
            k[j] = (x < y) == asc ? x : y;
            k[j | sb] = (x < y) == asc ? y : x;
          }
        }
      } else if (stride < 32 * E) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int e = t * E + j;
          const uint64_t y = __shfl_xor_sync(0xffffffffu, k[j], stride / E);
          keep(k[j], y, ((e & stride) == 0) == ((e & size) == 0));
        }
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) xbuf[t * E + j] = k[j];
        __syncthreads();
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int e = t * E + j;
          keep(k[j], xbuf[e ^ stride], ((e & stride) == 0) == ((e & size) == 0));
        }
        __syncthreads();
      }
    }
  }
}

template <typename CodeT, bool kVec, bool kSmemTab, int E>
__global__ void __launch_bounds__(kMaxThreads) beam_pq_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t tab_bytes = kSmemTab ? table_bytes(a) : 0;
  float* stab = reinterpret_cast<float*>(smem);
  uint64_t* key1 = reinterpret_cast<uint64_t*>(smem + tab_bytes);  // dkey << 32 | position
  uint64_t* key2 = key1 + a.p;                                     // fkey(d) << 32 | key1 slot
  float* all_d = reinterpret_cast<float*>(key2 + a.p);  // [0, L): the list; [L, L+BR): new
  uint32_t* all_dk = reinterpret_cast<uint32_t*>(all_d + a.p);
  int* sel = reinterpret_cast<int*>(all_dk + a.p);  // [B]
  int* nsel = sel + a.B;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + barrier_offset(a, kSmemTab));
  const float* gtab = a.dtable + (size_t)q * a.m * a.kc;
  const float* tab = kSmemTab ? stab : gtab;

  if (kSmemTab) {  // one bulk copy (the host checked: 16-byte multiple, aligned)
    if (tid == 0) {
      wg::mbar_init(bar, 1);
      wg::mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)((size_t)a.m * a.kc * sizeof(float));
      wg::mbar_expect_tx(bar, bytes);
      wg::bulk_load(stab, gtab, bytes, bar);
    }
    wg::mbar_wait(bar, 0);
  }

  // ---- seed: score the entries, pad to L, sort by d ----
  for (int i = tid; i < a.L; i += nthreads) {
    float d = kBig;
    uint32_t id = kNoId;
    if (i < a.e) {
      const int eid = __ldg(a.entry + (size_t)q * a.e + i);
      d = score<CodeT, kVec, kSmemTab>(a, tab, eid);
      if (d < kBig) id = (uint32_t)eid;
    }
    all_d[i] = d;
    all_dk[i] = id * 2u + 1u;
  }
  __syncthreads();
  uint64_t k[E];  // this thread's sort keys: elements tid * E + j
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid * E + j;
    k[j] = e < a.L ? ((uint64_t)fkey(all_d[e]) << 32 | (uint32_t)e) : kPad;
  }
  bitonic<E>(k, a.p, key2);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid * E + j;
    if (e < a.L) key1[e] = all_dk[(uint32_t)k[j]];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid * E + j;
    if (e < a.L) {
      all_dk[e] = (uint32_t)key1[e];
      all_d[e] = funkey((uint32_t)(k[j] >> 32));
    }
  }
  __syncthreads();

  const int nbr = a.B * a.r;
  const int nall = a.L + nbr;
  int it = 0;
  for (; it < a.iters; ++it) {
    // ---- frontier: the first B unexpanded alive slots, by warp 0 ----
    if (tid < 32) {
      int count = 0;
      for (int base = 0; base < a.L && count < a.B; base += 32) {
        const int i = base + tid;
        const bool c = i < a.L && (all_dk[i] & 1u) && all_d[i] < kBig;
        const unsigned ball = __ballot_sync(0xffffffffu, c);
        const int rank = count + __popc(ball & ((1u << tid) - 1u));
        if (c && rank < a.B) {
          sel[rank] = (int)(all_dk[i] >> 1);
          all_dk[i] -= 1u;  // exp = 1
        }
        count += __popc(ball);
      }
      if (tid == 0) *nsel = min(count, a.B);
    }
    __syncthreads();
    const int ns = *nsel;
    if (ns == 0) break;  // no frontier: the list would stay as it is
    // ---- expand: the selected nodes' neighbours, scored ----
    for (int t = tid; t < nbr; t += nthreads) {
      const int b = t / a.r;
      const int id = b < ns ? __ldg(a.adj + (size_t)sel[b] * a.r + (t - b * a.r)) : -1;
      const float d = score<CodeT, kVec, kSmemTab>(a, tab, id);
      all_d[a.L + t] = d;
      all_dk[a.L + t] = (d < kBig ? (uint32_t)id : kNoId) * 2u + 1u;
    }
    __syncthreads();
    // ---- merge: stable sort by dkey, dedup, stable sort by d, keep L ----
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = tid * E + j;
      k[j] = e < nall ? ((uint64_t)all_dk[e] << 32 | (uint32_t)e) : kPad;
    }
    bitonic<E>(k, a.p, key1);
#pragma unroll
    for (int j = 0; j < E; ++j) key1[tid * E + j] = k[j];  // read back by the result
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = tid * E + j;
      if (e < nall) {
        const uint32_t id = (uint32_t)(k[j] >> 33);
        const bool dup = e > 0 && (uint32_t)(key1[e - 1] >> 33) == id;
        const float d = (dup || id >= kNoId) ? kBig : all_d[(uint32_t)k[j]];
        k[j] = (uint64_t)fkey(d) << 32 | (uint32_t)e;
      } else {
        k[j] = kPad;
      }
    }
    bitonic<E>(k, a.p, key2);
    __syncthreads();  // every distance read above before the list is rewritten
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = tid * E + j;
      if (e < a.L) {
        all_dk[e] = (uint32_t)(key1[(uint32_t)k[j]] >> 32);
        all_d[e] = funkey((uint32_t)(k[j] >> 32));
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < a.k; i += nthreads) {
    a.d_out[(size_t)q * a.k + i] = all_d[i];
    a.id_out[(size_t)q * a.k + i] = (int)(all_dk[i] >> 1);
  }
  if (a.iters_out != nullptr && tid == 0) a.iters_out[q] = it;
}

template <typename CodeT, bool kVec, bool kSmemTab, int E>
int run(const Args& a, int nq, cudaStream_t st) {
  const size_t smem = barrier_offset(a, kSmemTab) + sizeof(uint64_t);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int threads = a.p / E;
  auto kern = beam_pq_kernel<CodeT, kVec, kSmemTab, E>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<nq, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename CodeT, bool kVec, bool kSmemTab>
int run_e(const Args& a, int nq, int e, cudaStream_t st) {
  if (e == 2) return run<CodeT, kVec, kSmemTab, 2>(a, nq, st);
  if (e == 4) return run<CodeT, kVec, kSmemTab, 4>(a, nq, st);
  return run<CodeT, kVec, kSmemTab, 8>(a, nq, st);
}

template <typename CodeT>
int launch(const Args& a, int nq, int e, int smem_tab, cudaStream_t st) {
  const bool vec = ((size_t)a.m * sizeof(CodeT)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.codes) % 16 == 0;
  if (smem_tab) {
    return vec ? run_e<CodeT, true, true>(a, nq, e, st) : run_e<CodeT, false, true>(a, nq, e, st);
  }
  return vec ? run_e<CodeT, true, false>(a, nq, e, st) : run_e<CodeT, false, false>(a, nq, e, st);
}

}  // namespace

extern "C" {

// The whole PQ beam search of nq queries: adjacency [n, r] int32, entries
// [nq, e] int32, codes [n, m] (u8 when code_bytes == 1, u16 when 2), dtable
// [nq, m, kc] float32 -> d_out [nq, k] float32, id_out [nq, k] int32 and,
// when not null, iters_out [nq] int32 (the iterations each query ran).  The
// plan (sort slots p, threads, table in shared memory) comes from
// ops/beam.py beam_pq_plan: p a power of two >= max(64, L + B * r), each
// thread holding p / threads (2, 4 or 8) sort keys.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a geometry it does not take).
int annlite_beam_pq(const void* adj, const void* entry, const void* codes, const void* dtable,
                    void* d_out, void* id_out, void* iters_out, int n, int r, int e, int m,
                    int kc, int nq, int L, int B, int iters, int k, int code_bytes, int p,
                    int threads, int smem_tab, void* stream) {
  if (nq < 1 || n < 1 || r < 1 || e < 1 || e > L || m < 1 || kc < 1 || B < 1 || B > L ||
      k < 1 || k > L || iters < 0 || n >= (int)kNoId || (p & (p - 1)) != 0 || p < L + B * r ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int per = p / threads;  // sort keys per thread
  if (per * threads != p || (per != 2 && per != 4 && per != 8) ||
      (smem_tab && (((size_t)m * kc) % 4 != 0 || reinterpret_cast<uintptr_t>(dtable) % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.adj = static_cast<const int*>(adj);
  a.entry = static_cast<const int*>(entry);
  a.codes = codes;
  a.dtable = static_cast<const float*>(dtable);
  a.d_out = static_cast<float*>(d_out);
  a.id_out = static_cast<int*>(id_out);
  a.iters_out = static_cast<int*>(iters_out);
  a.n = n;
  a.r = r;
  a.e = e;
  a.m = m;
  a.kc = kc;
  a.L = L;
  a.B = B;
  a.iters = iters;
  a.k = k;
  a.p = p;
  const cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1) return launch<uint8_t>(a, nq, per, smem_tab, st);
  if (code_bytes == 2) return launch<uint16_t>(a, nq, per, smem_tab, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
