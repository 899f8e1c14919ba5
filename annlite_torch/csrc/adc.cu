// ADC (asymmetric distance computation) scans for Hopper (sm_90a).
//
// Replaces four Pallas kernels of the JAX package, which share one body, the
// table-lookup sum  score[q, n] = sum_m dtable[q, m, codes[m, n]]:
//   * annlite_tpu/ops/adc.py:67  _adc_kernel   (K5) -> adc_scores here: the
//     full [Q, N] score matrix, BIG where the mask is 0;
//   * annlite_tpu/ops/adc.py:169 _adc_kernel8  (K4) -> adc_block_top2 here,
//     then lane8_merge (csrc/fused_scan.cu): per block of rows the best two
//     of each (query, row mod 128) bucket, then a running top-8 per lane
//     class;
//   * annlite_tpu/ops/ivf.py:31  _ivf_kernel   (K7) -> ivf_scores here: the
//     probed code blocks named by a device array of block ids, [S, Q, BS];
//   * annlite_tpu/ops/ivf.py:78  _ivf_kernel8  (K6) -> ivf_block_top2 here,
//     then lane8_merge: K7's scores plus the slot-mask bias and BIG for pad
//     selections, bucketed top-2 with provenance j * BS + slot.
// The TPU kernels turn the lookup into a one-hot matrix product with a bf16
// table, a device for the TPU's matrix unit.  Here the lookup is what it is:
// each CTA stages one query's float32 table in shared memory, and each
// thread reads one code per (row, subspace) -- codes are transposed [M, N],
// so neighbouring threads read neighbouring bytes -- and adds the table entry
// into a float32 register, over m in order 0..M-1.
//
// Shared memory.  A query's table is M*K*4 bytes: 64 KB at M = 64, K = 256
// (three CTAs per SM), 256 KB at K = 1024.  When it fits the 227 KB a block
// may use it is loaded once.  When it does not, the table is tiled over
// subspaces: a thread scores kRowBatch rows at a time, and for each chunk of
// subspaces the CTA loads the chunk and adds it into every row's accumulator
// before it takes the next chunk.  One subspace must fit: K <= 58,112.
// A CTA holds one query: a version that held two queries' tables (128 KB,
// one CTA per SM) ran slower on the card at the PQ path's shape.
//
// Geometry.  A thread owns one lane (row mod 128) of a row block and walks
// its groups (rows lane, lane + 128, ...) in ascending order; a CTA holds
// NG row blocks (128 * NG threads) for one query.  The grid is 1-D with
// the query fastest, so the CTAs that read one row block's codes run
// side by side and share them through L2.  The host lowers NG from 4 until
// there are at least 264 CTAs (2 per SM), if it can.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on the CUDA cores):
// at Q = 64, N = 2^20, M = 64 the codes are 64 MB (0.02 ms) and the Q*N*M
// table additions 4.3e9 (0.064 ms): bound by operations.  Each addition also
// reads one table entry from shared memory at a data-dependent address, so
// bank conflicts (random codes spread over 32 banks) set this version's
// rate; making it fast is later work.
//
// Exactness.  Every score is 0 + t_0 + t_1 + ... + t_{M-1} in float32, in
// that order, as the plain versions in annlite_torch/ops/adc.py and ivf.py
// compute it: the scores are bit-equal to them.  Selection is sequential in
// ascending group order with strict '<', the rule of _bucket_top2 (lowest
// group wins a tie; the second group is clamped to groups - 1).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;          // row r of a row block is in lane r % 128
constexpr int kRowBatch = 4;         // groups a thread scores per table pass
constexpr int kMaxSmem = 232448;     // 227 KB: a block's shared memory limit
constexpr int kMaxBlocksPerCta = 4;  // NG, row blocks per CTA
// CTAs per SM the registers must allow: three 64 KB tables (M = 64, K = 256)
// share an SM's shared memory, and without this cap the compiler takes more
// registers than three 512-thread CTAs may hold, so one or two ran per SM
constexpr int kMinCtasPerSm = 3;
constexpr float kBig = 3.4e38f;      // BIG of the Python side, in float32

enum Epi { kScores = 0, kBlockTop2 = 1, kIvfScores = 2, kIvfTop2 = 3 };

struct Args {
  const float* dtable;     // [nq, m, k]
  const void* codes;       // dense: [m, ld]; ivf: [blocks, m, bn]
  const int8_t* mask;      // dense: [n]; ivf: [blocks, bn]
  const int* block_ids;    // ivf: [n_rb], -1 = pad
  float* s_out;            // see the epilogues
  int* r_out;
  int nq, m, k;
  int n;                   // dense: valid rows; ivf: unused
  int ld;                  // dense: row stride of codes_t
  int bn;                  // rows per row block (ivf: the block size)
  int n_rb;                // row blocks (ivf: selections)
  int mc;                  // subspaces per staged chunk
};

__device__ __forceinline__ void top2_insert(float v, int g, float& mn1, int& g1,
                                            float& mn2, int& g2) {
  if (v < mn1) {
    mn2 = mn1;
    g2 = g1;
    mn1 = v;
    g1 = g;
  } else if (v < mn2) {
    mn2 = v;
    g2 = g;
  }
}

template <typename CodeT, int EPI>
__global__ void __launch_bounds__(kLanes * kMaxBlocksPerCta, kMinCtasPerSm)
adc_kernel(const Args a) {
  extern __shared__ float tab[];  // [mc][k]
  constexpr bool kIvf = EPI == kIvfScores || EPI == kIvfTop2;
  constexpr bool kTop2 = EPI == kBlockTop2 || EPI == kIvfTop2;
  const int q = blockIdx.x % a.nq;
  const int lane = threadIdx.x % kLanes;
  const int ng = blockDim.x / kLanes;
  const int rb = (blockIdx.x / a.nq) * ng + threadIdx.x / kLanes;
  const bool active = rb < a.n_rb;
  const int groups = a.bn / kLanes;
  const int nchunks = (a.m + a.mc - 1) / a.mc;

  // where this row block's codes start and the stride between subspaces
  const CodeT* codes = static_cast<const CodeT*>(a.codes);
  size_t cbase;
  size_t ld;
  int blk = 0;
  bool valid = true;
  if (kIvf) {
    const int id = active ? a.block_ids[rb] : 0;
    valid = id >= 0;
    blk = max(id, 0);  // a pad selection scores block 0, as the reference
    cbase = (size_t)blk * a.m * a.bn;
    ld = (size_t)a.bn;
  } else {
    cbase = (size_t)rb * a.bn;
    ld = (size_t)a.ld;
  }

  float mn1 = __int_as_float(0x7f800000);  // +inf
  float mn2 = __int_as_float(0x7f800000);
  int g1 = 0, g2 = 0;

  for (int gb = 0; gb < groups; gb += kRowBatch) {
    bool ok[kRowBatch];
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      const int g = gb + r;
      ok[r] = active && g < groups;
      if (!kIvf) ok[r] = ok[r] && (size_t)rb * a.bn + (size_t)g * kLanes + lane < (size_t)a.n;
    }
    float acc[kRowBatch];
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) acc[r] = 0.0f;

    for (int ch = 0; ch < nchunks; ++ch) {
      const int m0 = ch * a.mc;
      const int mcur = min(a.mc, a.m - m0);
      // stage the chunk: once for the whole kernel when it holds every m
      if (nchunks > 1 || gb == 0) {
        if (nchunks > 1) __syncthreads();
        const float* src = a.dtable + ((size_t)q * a.m + m0) * a.k;
        for (int i = threadIdx.x; i < mcur * a.k; i += blockDim.x) tab[i] = __ldg(src + i);
        __syncthreads();
      }
      const CodeT* cp = codes + cbase + (size_t)m0 * ld + (size_t)gb * kLanes + lane;
      for (int mm = 0; mm < mcur; ++mm) {
        int c[kRowBatch];
#pragma unroll
        for (int r = 0; r < kRowBatch; ++r)
          c[r] = ok[r] ? (int)__ldg(cp + (size_t)mm * ld + r * kLanes) : 0;
        const float* t = tab + mm * a.k;
#pragma unroll
        for (int r = 0; r < kRowBatch; ++r) acc[r] = __fadd_rn(acc[r], t[c[r]]);
      }
    }

    // epilogue of this batch of rows
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      if (!ok[r]) continue;
      const int g = gb + r;
      const int row = g * kLanes + lane;  // row within the row block
      if (EPI == kScores) {
        const size_t grow = (size_t)rb * a.bn + row;
        a.s_out[(size_t)q * a.n + grow] = __ldg(a.mask + grow) > 0 ? acc[r] : kBig;
      } else if (EPI == kIvfScores) {
        a.s_out[((size_t)rb * a.nq + q) * a.bn + row] = acc[r];
      } else if (EPI == kBlockTop2) {
        const bool keep = __ldg(a.mask + (size_t)rb * a.bn + row) > 0;
        top2_insert(keep ? acc[r] : kBig, g, mn1, g1, mn2, g2);
      } else {  // kIvfTop2: (acc + slot bias) + pad bias, the reference's order
        const float bias = __ldg(a.mask + (size_t)blk * a.bn + row) > 0 ? 0.0f : kBig;
        const float pad = valid ? 0.0f : kBig;
        top2_insert(__fadd_rn(__fadd_rn(acc[r], bias), pad), g, mn1, g1, mn2, g2);
      }
    }
  }

  if (kTop2 && active) {
    const int base = rb * a.bn;  // global row (K4) or provenance j * BS (K6)
    const size_t o = (size_t)q * a.n_rb * 256 + (size_t)rb * 256;
    a.s_out[o + lane] = mn1;
    a.s_out[o + kLanes + lane] = mn2;
    a.r_out[o + lane] = base + g1 * kLanes + lane;
    a.r_out[o + kLanes + lane] = base + min(g2, groups - 1) * kLanes + lane;
  }
}

// ----- host side: plan the launch, pick the instantiation -----

// Subspaces per staged chunk, NG and the dynamic shared memory; false if
// one subspace's table does not fit.
bool plan(Args& a, int* ng, size_t* smem) {
  const size_t per_m = (size_t)a.k * sizeof(float);
  const size_t mc = (size_t)kMaxSmem / per_m;
  if (mc < 1) return false;
  a.mc = (int)(mc < (size_t)a.m ? mc : (size_t)a.m);
  int n = kMaxBlocksPerCta;
  while (n > 1 && (size_t)a.nq * ((a.n_rb + n - 1) / n) < 264) n /= 2;
  *ng = n;
  *smem = (size_t)a.mc * per_m;
  return true;
}

template <typename CodeT, int EPI>
int launch_one(const Args& a, int ng, size_t smem, cudaStream_t st) {
  auto kern = adc_kernel<CodeT, EPI>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)a.nq * (unsigned)((a.n_rb + ng - 1) / ng);
  kern<<<grid, kLanes * ng, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch(Args a, int code_bytes, void* stream) {
  if (a.nq < 1 || a.m < 1 || a.k < 1 || a.bn < kLanes || a.bn % kLanes != 0 ||
      a.n_rb < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int ng;
  size_t smem;
  if (!plan(a, &ng, &smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1) return launch_one<uint8_t, EPI>(a, ng, smem, st);
  if (code_bytes == 2) return launch_one<uint16_t, EPI>(a, ng, smem, st);
  return (int)cudaErrorInvalidValue;
}

Args dense_args(const void* dtable, const void* codes, const void* mask, void* s_out,
                void* r_out, int nq, int m, int k, int n, int ld, int bn) {
  Args a{};
  a.dtable = (const float*)dtable;
  a.codes = codes;
  a.mask = (const int8_t*)mask;
  a.s_out = (float*)s_out;
  a.r_out = (int*)r_out;
  a.nq = nq;
  a.m = m;
  a.k = k;
  a.n = n;
  a.ld = ld;
  a.bn = bn;
  a.n_rb = bn > 0 ? (n + bn - 1) / bn : 0;
  return a;
}

Args ivf_args(const void* block_ids, const void* dtable, const void* codes,
              const void* mask, void* s_out, void* r_out, int n_sel, int nq, int m,
              int k, int bs) {
  Args a{};
  a.dtable = (const float*)dtable;
  a.codes = codes;
  a.mask = (const int8_t*)mask;
  a.block_ids = (const int*)block_ids;
  a.s_out = (float*)s_out;
  a.r_out = (int*)r_out;
  a.nq = nq;
  a.m = m;
  a.k = k;
  a.bn = bs;
  a.n_rb = n_sel;
  return a;
}

}  // namespace

extern "C" {

// Each entry point checks its geometry, launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a geometry it does not take).
// code_bytes is 1 (u8 codes) or 2 (u16).

// K5: out[q, n] (ld = row stride of codes_t [m, ld], n <= ld) for any n.
int annlite_adc_scores(const void* dtable, const void* codes_t, const void* mask,
                       void* out, int nq, int m, int k, int n, int ld,
                       int code_bytes, void* stream) {
  if (n < 1 || ld < n) return (int)cudaErrorInvalidValue;
  return launch<kScores>(dense_args(dtable, codes_t, mask, out, nullptr, nq, m, k, n, ld, 4096),
                         code_bytes, stream);
}

// K4's block pass: s_out/r_out [nq, n / block_n * 256]; n % block_n == 0.
int annlite_adc_block_top2(const void* dtable, const void* codes_t, const void* mask,
                           void* s_out, void* r_out, int nq, int m, int k, int n,
                           int ld, int block_n, int code_bytes, void* stream) {
  if (block_n < kLanes || n < block_n || n % block_n != 0 || ld < n) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<kBlockTop2>(
      dense_args(dtable, codes_t, mask, s_out, r_out, nq, m, k, n, ld, block_n), code_bytes,
      stream);
}

// K7: out[j, q, slot] for the blocks block_ids[j] (a pad -1 scores block 0).
int annlite_ivf_scores(const void* block_ids, const void* dtable, const void* codes_blocks,
                       void* out, int n_sel, int nq, int m, int k, int bs, int code_bytes,
                       void* stream) {
  return launch<kIvfScores>(
      ivf_args(block_ids, dtable, codes_blocks, nullptr, out, nullptr, n_sel, nq, m, k, bs),
      code_bytes, stream);
}

// K6's block pass: s_out/r_out [nq, n_sel * 256], rows as j * bs + slot.
int annlite_ivf_block_top2(const void* block_ids, const void* dtable,
                           const void* codes_blocks, const void* mask_blocks, void* s_out,
                           void* r_out, int n_sel, int nq, int m, int k, int bs,
                           int code_bytes, void* stream) {
  return launch<kIvfTop2>(ivf_args(block_ids, dtable, codes_blocks, mask_blocks, s_out,
                                   r_out, n_sel, nq, m, k, bs),
                          code_bytes, stream);
}

}  // extern "C"
