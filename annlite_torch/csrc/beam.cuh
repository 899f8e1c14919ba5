// The loop body of the port's persistent beam searches: one CTA runs one
// query's whole search, seed, frontier, expansion and both merge sorts in
// shared memory, with the host reading nothing until the search ends.  The
// scorer is a template parameter: beam_pq.cu scores with a PQ table
// (K8 with its loop), beam_vec.cu with the resident rows.
//
// What it computes, per query (the contracts of annlite_torch/ops/beam.py
// _beam_loop, which the plain twin _beam_ref follows step by step):
//   seed      score the E entry ids; an id scoring >= BIG becomes NO_ID; pad
//             with (BIG, NO_ID, exp 0) to L; stable sort by distance.
//   frontier  the first B slots in list order with exp == 0 and d < BIG;
//             each is marked expanded.  None left: the query stops (such an
//             iteration would leave the list as it is).
//   expand    adjacency[sel] row by row, in (slot, r) order, each id scored
//             (BIG for an id < 0 or >= n); then NO_ID wherever d >= BIG.
//   merge     the list (L) and the new entries (B*R): a stable sort by
//             dkey = id*2 + (1 - exp); d = BIG for an entry whose id equals
//             its predecessor's and for id >= NO_ID; a stable sort by d; the
//             first L stay.
// Each stable sort is a bitonic sort of unique 64-bit keys (value << 32 |
// position) over P = next_pow2(L + B*R) slots (at least 64), padding keys
// all ones, held in registers, 2 to 8 a thread: equal values keep their
// positions' order, so the sort is stable and the tail of the list (the
// dedup's losing copies, then NO_IDs) comes out as the eager loop's.  A
// distance keys as its order-preserving uint32 image; no score is -0.0 (a
// sum that starts from +0.0 rounds to nearest, and 1 - x is never -0.0), so
// the image maps back to the same bits.  An entry is its dkey (id and exp in
// one word) and its distance; the first sort's keys carry the dkey, the
// second's the distance, and the result is read back from both.
//
// The state takes 24 bytes per sort slot (two key buffers for the sorts'
// long strides and the first sort's result, the entries' distances and
// dkeys), then the selection of B ids and its count: state_bytes().
//
// Filtered (kFilter): a predicate, one byte a row (nonzero: the row passes;
// an id >= n_pass fails), and a result list of the k best passing rows
// beside the traversal's list.  The traversal is untouched: every row is
// scored and may enter the list and be expanded, whether it passes or not,
// so routes through failing rows hold, and the stop rule is the same.  Each
// scored batch (the seed's entries, then each expansion's B*R) that holds a
// passing row below the result list's last is merged into it: one bitonic
// sort of (fkey(d) << 32 | id) over the list and the batch, then warp 0
// keeps the first k distinct keys (a row scores the same wherever it is
// scored, so its copies have one key and sort side by side).  The result is
// the k best of every passing row the search scored, by (distance, id): the
// plain twin's, whatever the order of the merges.  It takes 8 bytes a slot
// after the state.
//
// A scorer is a type with
//   template <class IdOf>
//   __device__ void score(int count, IdOf id_of, float* d, uint32_t* dk) const;
// which every thread of the CTA calls: it scores the ids id_of(t), t in
// [0, count), and stores each with put(d, dk, t, id, distance).  It may
// split the work among the threads as it likes; the caller synchronises
// after it.
#pragma once
#include <cstddef>
#include <cstdint>

namespace beam {

constexpr int kMaxSmem = 232448;  // 227 KB: a block's shared memory limit
constexpr int kMaxThreads = 512;
constexpr float kBig = 3.4e38f;   // BIG of the Python side, in float32
constexpr uint32_t kNoId = 1u << 29;
constexpr uint64_t kPad = ~0ull;  // sorts after every real key

// The scorer-independent arguments of a search.
struct Loop {
  const int* adj;   // [n, r]
  const int* entry; // [nq, e]
  float* d_out;     // [nq, k]
  int* id_out;      // [nq, k]
  int* iters_out;   // [nq] or null
  const unsigned char* pass;  // [n_pass] of a filtered search, else unused
  int n, r, e, L, B, iters, k, p, n_pass;
};

__host__ __device__ __forceinline__ size_t state_bytes(int p, int B) {
  return (size_t)p * 24 + ((size_t)B + 1 + 1) / 2 * 8;
}

// order-preserving uint32 image of a float32 (-0.0 folded to +0.0)
__device__ __forceinline__ uint32_t fkey(float d) {
  const uint32_t b = __float_as_uint(d == 0.0f ? 0.0f : d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float funkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// a scored entry: its distance and its dkey (NO_ID wherever d >= BIG, exp 0)
__device__ __forceinline__ void put(float* d, uint32_t* dk, int at, int id, float dist) {
  d[at] = dist;
  dk[at] = (dist < kBig ? (uint32_t)id : kNoId) * 2u + 1u;
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

// Merge the passing rows among `count` scored entries (src_d, src_dk) into
// the result list res[0, k) of a filtered search, which holds sorted keys
// fkey(d) << 32 | id, kPad past its last row.  Elements [0, nres) of the
// sort are the list (nres 0 at the seed, whose list is empty, else k), the
// next `count` the entries; an entry that fails, scores BIG or does not come
// before the list's last key sorts as padding.  Nothing is sorted where no
// entry comes before it.  xbuf and out: p keys each.  Every thread calls it.
template <int E>
__device__ void take_passing(const Loop& a, uint64_t* res, int nres, const float* src_d,
                             const uint32_t* src_dk, int count, uint64_t (&k)[E],
                             uint64_t* xbuf, uint64_t* out) {
  const int tid = threadIdx.x;
  const uint64_t last = res[a.k - 1];
  int any = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid * E + j;
    uint64_t x = kPad;
    if (e < nres) {
      x = res[e];
    } else if (e < nres + count) {
      const float d = src_d[e - nres];
      const uint32_t id = src_dk[e - nres] >> 1;
      if (d < kBig && id < (uint32_t)a.n_pass && __ldg(a.pass + id) != 0) {
        x = (uint64_t)fkey(d) << 32 | id;
        if (x < last) {
          any = 1;
        } else {
          x = kPad;
        }
      }
    }
    k[j] = x;
  }
  if (!__syncthreads_or(any)) return;
  bitonic<E>(k, a.p, xbuf);
#pragma unroll
  for (int j = 0; j < E; ++j) out[tid * E + j] = k[j];
  __syncthreads();
  if (tid < 32) {
    int kept = 0;
    for (int base = 0; base < a.p && kept < a.k; base += 32) {
      const int i = base + tid;
      const uint64_t x = out[i];
      const bool c = x != kPad && (i == 0 || out[i - 1] != x);
      const unsigned ball = __ballot_sync(0xffffffffu, c);
      const int rank = kept + __popc(ball & ((1u << tid) - 1u));
      if (c && rank < a.k) res[rank] = x;
      kept += __popc(ball);
      if (__ballot_sync(0xffffffffu, x == kPad) != 0) break;  // the rest is padding
    }
    for (int i = min(kept, a.k) + tid; i < a.k; i += 32) res[i] = kPad;
  }
  __syncthreads();
}

// One query's search (query blockIdx.x) in the state at `st`
// (state_bytes(a.p, a.B), 8-byte aligned, then k result keys when
// kFilter), blockDim.x == a.p / E threads.
template <int E, bool kFilter = false, class Scorer>
__device__ __forceinline__ void search(const Loop& a, const Scorer& sc, unsigned char* st) {
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  uint64_t* key1 = reinterpret_cast<uint64_t*>(st);  // dkey << 32 | position
  uint64_t* key2 = key1 + a.p;                      // fkey(d) << 32 | key1 slot
  float* all_d = reinterpret_cast<float*>(key2 + a.p);  // [0, L): the list; [L, L+BR): new
  uint32_t* all_dk = reinterpret_cast<uint32_t*>(all_d + a.p);
  int* sel = reinterpret_cast<int*>(all_dk + a.p);  // [B]
  int* nsel = sel + a.B;
  uint64_t* res = reinterpret_cast<uint64_t*>(st + state_bytes(a.p, a.B));  // kFilter: [k]

  // ---- seed: score the entries, pad to L, sort by d ----
  const int* entry = a.entry + (size_t)q * a.e;
  sc.score(a.e, [&](int i) { return __ldg(entry + i); }, all_d, all_dk);
  for (int i = a.e + tid; i < a.L; i += nthreads) {
    all_d[i] = kBig;
    all_dk[i] = kNoId * 2u + 1u;
  }
  if constexpr (kFilter) {
    for (int i = tid; i < a.k; i += nthreads) res[i] = kPad;
  }
  __syncthreads();
  uint64_t k[E];  // this thread's sort keys: elements tid * E + j
  if constexpr (kFilter) take_passing<E>(a, res, 0, all_d, all_dk, a.e, k, key2, key1);
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
    sc.score(
        nbr,
        [&](int t) {
          const int b = t / a.r;
          return b < ns ? __ldg(a.adj + (size_t)sel[b] * a.r + (t - b * a.r)) : -1;
        },
        all_d + a.L, all_dk + a.L);
    __syncthreads();
    if constexpr (kFilter) {
      take_passing<E>(a, res, a.k, all_d + a.L, all_dk + a.L, nbr, k, key2, key1);
    }
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
    if constexpr (kFilter) {
      const uint64_t x = res[i];
      a.d_out[(size_t)q * a.k + i] = x == kPad ? kBig : funkey((uint32_t)(x >> 32));
      a.id_out[(size_t)q * a.k + i] = x == kPad ? (int)kNoId : (int)(uint32_t)x;
    } else {
      a.d_out[(size_t)q * a.k + i] = all_d[i];
      a.id_out[(size_t)q * a.k + i] = (int)(all_dk[i] >> 1);
    }
  }
  if (a.iters_out != nullptr && tid == 0) a.iters_out[q] = it;
}

// Host-side checks common to both entry points: the geometry the loop
// takes (p a power of two >= L + B * r, p / threads keys a thread).
inline bool loop_ok(const Loop& a, int nq, int threads) {
  if (nq < 1 || a.n < 1 || a.r < 1 || a.e < 1 || a.e > a.L || a.B < 1 || a.B > a.L ||
      a.k < 1 || a.k > a.L || a.iters < 0 || a.n >= (int)kNoId || (a.p & (a.p - 1)) != 0 ||
      a.p < a.L + a.B * a.r || threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return false;
  }
  const int per = a.p / threads;
  return per * threads == a.p && (per == 2 || per == 4 || per == 8);
}

}  // namespace beam
