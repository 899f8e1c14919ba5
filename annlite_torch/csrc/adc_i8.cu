// ADC scores with an int8 table, for Hopper (sm_90a).
//
// Replaces annlite_tpu/ops/adc_i8.py:56 _adc_i8_kernel (K9):
//     out[q, n] = float(sum_m t8[q, m, codes[m, n]]) * scale[q] + offset[q],
// BIG where mask[n] is 0, with t8 the int8 table that ops/adc_i8.py
// quantize_dtable makes (centred per (q, m), one scale per q).  The TPU ran
// the lookup as one-hot int8 matrix products on its matrix unit; here it is
// a lookup into shared memory, on the pattern of csrc/adc.cu's core.
//
// Bound on an H100 SXM at Q = 64, N = 2^20, M = 64, K = 256 (u8): the codes
// (64 MB) and the float32 scores (256 MB) take ~0.10 ms at 3.35 TB/s; the
// Q*N*M = 4.3e9 lookups read 1 byte each, 0.13 ms at 128 B per clock per SM
// (132 SMs at 1.98 GHz) if every bank word served four queries.  What a
// lookup costs is set by bank conflicts: 32 random 4-byte reads of one
// subspace's entries need ~3.5 passes through the 32 banks on average, 16
// random 8-byte reads ~3 (a model; the card's tools cannot count them).
// On an H100 SXM (700 W) the design below reads 0.45 ms at these shapes,
// 3.5x that floor (tiles of 4 queries: 0.53; of 1: 1.35).
//
// The first version held one query per CTA, loaded each code with a 1-byte
// load, read one 1-byte entry per lookup and staged the table byte by byte:
// every code crossed L2 Q times and each (query, row, subspace) cost a global
// and a shared load.  This design:
//   1. Query tiles.  A CTA holds QT queries (1, 4 or 8; ops/adc_i8.py
//      adc_i8_plan balances the tiles) whose tables a small interleave
//      kernel first lays out as [tile][m][kp][QT] bytes, biased to u8
//      (t8 + 128, i.e. t8 ^ 0x80; padded queries and codewords hold the
//      neutral 0x80).  One 4-byte (QT = 4) or 8-byte (QT = 8) shared read
//      then serves the whole tile, and the codes cross L2 Q / QT times.  The
//      grid runs the query tile fastest, so the tiles of one row range read
//      the same codes from L2 at about the same time.
//   2. Wide code loads: a thread owns 4 neighbouring rows and reads their
//      codes for one subspace in one 32-bit (u8) or 64-bit (u16) load
//      (lookup.cuh Codes4), 8 subspaces' words in flight before the lookups.
//   3. The table arrives by one cp.async.bulk copy on an mbarrier and stays
//      for all the CTA's rows when the tile's table fits (Q = 64, K = 256:
//      QT = 8, 128 KB); otherwise it streams in chunks of mc subspaces for
//      each tile of 2048 rows (a barrier of the CTA between chunks).  Only
//      the codewords a code can name are staged (256 for u8 codes, 65,536
//      for u16), so K up to MAX_I8_CLUSTERS always fits at QT = 1.
//   4. Packed accumulation.  A table word holds 4 biased entries; its even
//      and odd bytes are split into two words of two 16-bit lanes and added
//      with plain 32-bit adds, two queries per add.  A lane stays exact for
//      256 subspaces (255 * 256 < 65,536); every 256 subspaces, and at the
//      end of each chunk, the lanes are folded into 32-bit sums.  At QT = 1 a
//      1-byte entry is added to a 32-bit sum directly.
// Exactness: integer sums are exact in any order; 128 * M is subtracted at
// the end, and the epilogue is __fadd_rn(__fmul_rn((float)acc, scale),
// offset), the plain version's two roundings, so the two are bit-equal.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookup.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;                      // rows per thread: one Codes4 word
constexpr int kTileRows = kThreads * kRows;   // rows per pass of the CTA
constexpr int kBatch = 8;                     // subspaces whose code words load at once
constexpr int kFlush = 256;                   // subspaces a 16-bit lane sums exactly
constexpr int kBias = 128;                    // t8 + 128 is the stored u8 entry
constexpr int kMaxSmem = 232448;              // 227 KB: a block's shared memory limit
constexpr int kBarBytes = 16;                 // the mbarrier after the table

// CTAs per SM each tile width is compiled for (ops/adc_i8.py CTAS_PER_SM)
template <int QT>
struct Fit {
  static constexpr int kCtas = QT == 8 ? 1 : 2;
};

struct Args {
  const uint8_t* tab;     // interleaved biased tables [tiles, m, kp, qt]
  const void* codes;      // [m, ld]
  const int8_t* mask;     // [ld]
  const float* scale;     // [nq]
  const float* offset;    // [nq]
  float* out;             // [nq, n]
  int nq, m, kp, n, ld;
  int tiles, mc, nchunks, rows_per_cta;  // the plan (qt is the template's)
};

// tab[t, mm, kk, j] = t8[t * QT + j, mm, kk] ^ 0x80 for a real query and
// codeword (kk < kr, the codewords a code can name), else 0x80.  One thread
// per entry of QT bytes, stored in one access.
template <int QT>
__global__ void __launch_bounds__(256) interleave_kernel(const int8_t* __restrict__ t8,
                                                         uint8_t* __restrict__ tab, int nq,
                                                         int m, int k, int kr, int kp,
                                                         size_t entries) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  const int kk = (int)(e % kp);
  const size_t tm = e / kp;
  const int mm = (int)(tm % m);
  const int t = (int)(tm / m);
  uint8_t v[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int q = t * QT + j;
    v[j] = (q < nq && kk < kr) ? (uint8_t)t8[((size_t)q * m + mm) * k + kk] ^ 0x80u : 0x80u;
  }
  if constexpr (QT == 1) {
    tab[e] = v[0];
  } else {
    uint32_t w[QT / 4];
#pragma unroll
    for (int h = 0; h < QT / 4; ++h) {
      w[h] = (uint32_t)v[4 * h] | ((uint32_t)v[4 * h + 1] << 8) |
             ((uint32_t)v[4 * h + 2] << 16) | ((uint32_t)v[4 * h + 3] << 24);
    }
    if constexpr (QT == 4) {
      reinterpret_cast<uint32_t*>(tab)[e] = w[0];
    } else {
      reinterpret_cast<uint2*>(tab)[e] = make_uint2(w[0], w[1]);
    }
  }
}

// Chunk c of the tile's table into shared memory, completing on `bar`.
__device__ __forceinline__ void stage(const Args& a, const uint8_t* gtab, uint8_t* tab,
                                      uint64_t* bar, int c, size_t per_m) {
  const int m0 = c * a.mc;
  const uint32_t bytes = (uint32_t)(min(a.mc, a.m - m0) * per_m);
  wg::mbar_expect_tx(bar, bytes);
  wg::bulk_load(tab, gtab + (size_t)m0 * per_m, bytes, bar);
}

// Add the entries of shared address `addr` into this row's sums: QT = 1 into
// the 32-bit sum, else each word's even and odd bytes into two words of
// 16-bit lanes (queries 4h, 4h+2 and 4h+1, 4h+3).  Volatile: the reads stay
// after the mbarrier wait that makes the chunk visible.
template <int QT>
__device__ __forceinline__ void lookup_add(uint32_t addr, uint32_t (&pk)[QT == 1 ? 1 : QT / 2],
                                           uint32_t (&tot)[QT]) {
  if constexpr (QT == 1) {
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
    tot[0] += v;
  } else if constexpr (QT == 4) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    pk[0] += v & 0x00FF00FFu;
    pk[1] += __byte_perm(v, 0u, 0x4341u);
  } else {
    uint32_t v0, v1;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v0), "=r"(v1) : "r"(addr));
    pk[0] += v0 & 0x00FF00FFu;
    pk[1] += __byte_perm(v0, 0u, 0x4341u);
    pk[2] += v1 & 0x00FF00FFu;
    pk[3] += __byte_perm(v1, 0u, 0x4341u);
  }
}

// The packed lanes into the 32-bit sums; the lanes start again at 0.
template <int QT>
__device__ __forceinline__ void fold(uint32_t (&pk)[QT == 1 ? 1 : QT / 2], uint32_t (&tot)[QT]) {
  if constexpr (QT > 1) {
#pragma unroll
    for (int h = 0; h < QT / 4; ++h) {
      tot[4 * h] += pk[2 * h] & 0xFFFFu;
      tot[4 * h + 2] += pk[2 * h] >> 16;
      tot[4 * h + 1] += pk[2 * h + 1] & 0xFFFFu;
      tot[4 * h + 3] += pk[2 * h + 1] >> 16;
      pk[2 * h] = 0u;
      pk[2 * h + 1] = 0u;
    }
  }
}

// blockIdx.x = range * tiles + tile (the tile fastest).  Thread t takes rows
// r0 + 4t .. +3 of each pass r0 over the CTA's range, for the tile's QT
// queries.
template <typename CodeT, int QT>
__global__ void __launch_bounds__(kThreads, Fit<QT>::kCtas) adc_i8_kernel(const Args a) {
  using C4 = Codes4<CodeT>;
  constexpr int QP = QT == 1 ? 1 : QT / 2;
  extern __shared__ __align__(16) uint8_t tab[];  // [mc][kp][QT], then the mbarrier
  const size_t per_m = (size_t)a.kp * QT;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tab + (size_t)a.mc * per_m);
  const int tile = blockIdx.x % a.tiles;
  const int lo = (blockIdx.x / a.tiles) * a.rows_per_cta;
  const int hi = min(a.ld, lo + a.rows_per_cta);
  const uint8_t* gtab = a.tab + (size_t)tile * a.m * per_m;
  const CodeT* codes = static_cast<const CodeT*>(a.codes);
  const bool resident = a.nchunks == 1;
  const uint32_t tab_u32 = wg::smem_u32(tab);

  if (threadIdx.x == 0) {
    wg::mbar_init(bar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();  // the barrier is initialised before the copy
  if (resident) {
    if (threadIdx.x == 0) stage(a, gtab, tab, bar, 0, per_m);
    wg::mbar_wait(bar, 0u);
  }
  uint32_t phase = 0;

  for (int r0 = lo; r0 < hi; r0 += kTileRows) {
    const int row = r0 + threadIdx.x * kRows;
    const bool ok = row < hi;
    uint32_t tot[kRows][QT];
    uint32_t pk[kRows][QP];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < QT; ++j) tot[r][j] = 0u;
#pragma unroll
      for (int p = 0; p < QP; ++p) pk[r][p] = 0u;
    }
    for (int c = 0; c < a.nchunks; ++c) {
      if (!resident) {
        __syncthreads();  // every thread is done with the previous chunk
        if (threadIdx.x == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          stage(a, gtab, tab, bar, c, per_m);
        }
        wg::mbar_wait(bar, phase);
        phase ^= 1u;
      }
      const int m0 = c * a.mc;
      const int mcur = min(a.mc, a.m - m0);
      const CodeT* cp = codes + (size_t)m0 * a.ld + row;
      for (int s0 = 0; s0 < mcur; s0 += kFlush) {
        const int s1 = min(mcur, s0 + kFlush);
        int mm = s0;
        for (; mm + kBatch <= s1; mm += kBatch) {
          typename C4::Word w[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            w[u] = ok ? C4::load(cp + (size_t)(mm + u) * a.ld) : C4::zero();
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const uint32_t t = tab_u32 + (uint32_t)((mm + u) * per_m);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              lookup_add<QT>(t + C4::at(w[u], r) * QT, pk[r], tot[r]);
            }
          }
        }
        for (; mm < s1; ++mm) {
          const typename C4::Word w = ok ? C4::load(cp + (size_t)mm * a.ld) : C4::zero();
          const uint32_t t = tab_u32 + (uint32_t)(mm * per_m);
#pragma unroll
          for (int r = 0; r < kRows; ++r) lookup_add<QT>(t + C4::at(w, r) * QT, pk[r], tot[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) fold<QT>(pk[r], tot[r]);
      }
    }
    if (!ok) continue;
    // epilogue: the rows below n of this thread's four, each query of the tile
    const uint32_t keep4 = __ldg(reinterpret_cast<const uint32_t*>(a.mask + row));
    const int unbias = kBias * a.m;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const int q = tile * QT + j;
      if (q >= a.nq) break;
      const float sc = __ldg(a.scale + q);
      const float off = __ldg(a.offset + q);
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool keep = (int8_t)((keep4 >> (8 * r)) & 0xFFu) > 0;
        const int acc = (int)tot[r][j] - unbias;
        v[r] = keep ? __fadd_rn(__fmul_rn((float)acc, sc), off) : kBig;
      }
      float* o = a.out + (size_t)q * a.n + row;
      if ((a.n & 3) == 0) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (row + r < a.n) o[r] = v[r];
        }
      }
    }
  }
}

template <typename CodeT, int QT>
int launch(const void* t8, Args a, int k, int kr, cudaStream_t st) {
  const size_t entries = (size_t)a.tiles * a.m * a.kp;
  interleave_kernel<QT><<<(unsigned)((entries + 255) / 256), 256, 0, st>>>(
      (const int8_t*)t8, const_cast<uint8_t*>(a.tab), a.nq, a.m, k, kr, a.kp, entries);
  const size_t smem = (size_t)a.mc * a.kp * QT + kBarBytes;
  auto kern = adc_i8_kernel<CodeT, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ranges = (a.ld + a.rows_per_cta - 1) / a.rows_per_cta;
  kern<<<(unsigned)((long long)ranges * a.tiles), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename CodeT>
int launch_qt(int qt, const void* t8, const Args& a, int k, int kr, cudaStream_t st) {
  if (qt == 1) return launch<CodeT, 1>(t8, a, k, kr, st);
  if (qt == 4) return launch<CodeT, 4>(t8, a, k, kr, st);
  if (qt == 8) return launch<CodeT, 8>(t8, a, k, kr, st);
  return (int)cudaErrorInvalidValue;
}

template <typename CodeT>
cudaError_t attributes(int qt, cudaFuncAttributes* fa) {
  if (qt == 1) return cudaFuncGetAttributes(fa, adc_i8_kernel<CodeT, 1>);
  if (qt == 4) return cudaFuncGetAttributes(fa, adc_i8_kernel<CodeT, 4>);
  if (qt == 8) return cudaFuncGetAttributes(fa, adc_i8_kernel<CodeT, 8>);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K9: out[q, n] from t8 [nq, m, k] int8, codes_t [m, ld] (u8 when code_bytes
// == 1, u16 when 2; ld a multiple of 4, 8-byte aligned), mask [ld] int8
// (4-byte aligned), scale and offset [nq] float32, through `tab`, room for
// the interleaved tables [tiles, m, kp, qt].  plan = {qt, tiles, kp, mc,
// rows_per_cta} (ops/adc_i8.py adc_i8_plan).  Launches the interleave and
// the scores on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry it does not take).
int annlite_adc_i8_scores(const void* t8, const void* codes_t, const void* mask,
                          const void* scale, const void* offset, void* out, void* tab, int nq,
                          int m, int k, int n, int ld, int code_bytes, const int* plan,
                          void* stream) {
  const int qt = plan[0];
  Args a{(const uint8_t*)tab, codes_t, (const int8_t*)mask, (const float*)scale,
         (const float*)offset, (float*)out, nq, m, plan[2], n, ld,
         plan[1], plan[3], 0, plan[4]};
  const int named = code_bytes == 1 ? 256 : 65536;  // codewords a code can name
  const int kr = k < named ? k : named;
  if (nq < 1 || nq > 65535 || m < 1 || k < 1 || n < 1 || ld < n || ld % 4 != 0 ||
      (code_bytes != 1 && code_bytes != 2) || a.kp % 16 != 0 || a.kp < kr || a.mc < 1 ||
      a.rows_per_cta < 1 || a.rows_per_cta % 4 != 0 || a.tiles * qt < nq ||
      (size_t)a.mc * a.kp * qt + kBarBytes > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  a.nchunks = (m + a.mc - 1) / a.mc;
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1) return launch_qt<uint8_t>(qt, t8, a, k, kr, st);
  return launch_qt<uint16_t>(qt, t8, a, k, kr, st);
}

// Registers and spilled bytes per thread of the scores kernel for a tile of
// qt queries and codes of code_bytes.
int annlite_adc_i8_info(int code_bytes, int qt, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t e =
      code_bytes == 1 ? attributes<uint8_t>(qt, &fa) : attributes<uint16_t>(qt, &fa);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return 0;
}

}  // extern "C"
