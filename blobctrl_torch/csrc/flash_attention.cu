// Flash attention forward (non-causal, unmasked) for NVIDIA Hopper (sm_90a):
// o = softmax(q k^T * scale) v over (BH, S, D) tensors, one pass, the S x S
// scores never leaving the chip.
//
// Replaces: blobctrl_tpu/ops/flash_attention.py `_flash_kernel_fixed_max`
// (the static softmax shift p = exp(s - FM) in place of the running max,
// exact while the logits stay within (FM - 87, FM + 88)) and, with the
// running-max mode, `_flash_kernel` (alpha-rescaled online softmax), and,
// with the exp2-folded mode, `_flash_kernel_fixed_max2` (`:55`): q arrives
// pre-scaled by scale * log2(e) and the shift -fixed_max * log2(e) comes as
// one scalar, so each score takes one add and one exp2 (p = 2^(q'.k +
// shift)). The TPU kernel carries the shift in an extra contraction lane
// d + 1 of q and k; here it is added to the fp32 dot product instead, the
// same math up to the order of one addition, and no lane is built in
// device memory. One kernel covers the three modes, selected by a template
// parameter.
//
// What bounds it on the H100: 4*BH*Sq*Skv*D operations against
// (q + k + v + o) bytes, thousands of operations per byte at the production
// shapes (S = 8192 with D = 40, S = 2048 with D = 80), so arithmetic bounds
// it: the two products on the tensor cores (989 TFLOP/s bf16) and one
// exponential per score on the special-function units (16 MUFU.EX2 per clock
// per SM, about 4.2e12/s on 132 SMs at 1.98 GHz). At D = 40 the exponentials
// bound it first: 16 * 8192^2 of them cost ~0.26 ms per top-level call
// against ~0.17 ms for the two products.
//
// Two kernels, chosen by dtype in the C entry point (never one as a
// fallback of the other):
//
// bf16: `flash_kernel_tc`, FA2-style on the tensor cores. A 256-thread block
// owns 128 query rows, 16 per warp. Q is copied to shared memory once and
// its mma A fragments stay in registers for the whole key loop. K and V
// tiles of 64 keys stream through a three-stage shared-memory ring by
// cp.async (16-byte copies, zero-filled past the ragged tail): two tiles
// are in flight under each tile's math, and one barrier per tile suffices. S = Q K^T runs on mma.sync m16n8k16 (bf16 -> fp32;
// K's B fragments by ldmatrix), p is formed in registers in fp32 and rounded
// to bf16 straight into the A fragments of P.V (the TPU kernel's
// `p.astype(v.dtype)`), while the row sum l takes the fp32 p; V's B fragments
// come from ldmatrix.trans on row-major V. Each p is one FFMA and one
// MUFU.EX2: mode 1 computes exp(s*scale - FM) as 2^(s*(scale*log2 e) -
// FM*log2 e), mode 0 keeps its running max in the log2 domain and rescales
// l and the accumulators by alpha = 2^(m_old - m_new) per tile, mode 2 is
// 2^(s + shift). D is padded to a multiple of 16 for q.k^T in shared memory
// only (zero-filled columns), never in device memory. The template is
// specialised on (padded D for q.k^T, columns of P.V): (48, 40) serves every
// D <= 40 (the top level's 40), (80, 80) every D in 41..80 and (160, 160)
// every D in 81..160; with three modes that is nine bf16 instantiations.
// Rows whose bytes are not a multiple of 16 (D % 8 != 0) or pointers that
// are not 16-byte aligned take masked 2-byte loads instead of cp.async.
// Left for later: wgmma with TMA, warp specialisation (a producer warp and
// consumer warpgroups), persistent blocks, and moving a share of the
// exponentials onto the FMA pipe as a polynomial to get past the MUFU bound
// at D = 40.
//
// fp32: `flash_kernel`, the first version, SIMT, kept for the fp32 checks.
// One 256-thread block owns 64 query rows and walks the keys in 64-row tiles
// through shared memory; scores, softmax and the P.V update run on the CUDA
// cores in fp32 (each thread owns a 4 x 4 block of scores and 4 rows x
// ceil(D/16) columns of the output); shared rows use an odd stride so the
// column walks are free of bank conflicts.
//
// Both: no padding in device memory and no divisibility (the ragged key tail
// is masked, the ragged query tail is not stored); the row sum l uses the
// fp32 p while P.V takes p rounded to the input dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // key rows per tile
constexpr int NT = 256;      // threads: 16 (tx) x 16 (ty)
constexpr int MAX_DJ = 10;   // output columns per thread: D <= 16 * MAX_DJ = 160
constexpr float NEG_BIG = -1e30f;  // initial running max, as in the TPU kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Reduce over the 16 lanes that share a score row (one half warp).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int D) {
  const int ld = D | 1;
  return sizeof(float) * ((size_t)BQ * ld + (size_t)BKV * ld + (size_t)BKV * D +
                          (size_t)BQ * (BKV + 1));
}

// MODE: 0 = running max, 1 = fixed max exp(s * scale - fixed_max),
// 2 = exp2-folded exp2(s + fixed_max) (fixed_max holds the shift).
constexpr int RUNNING_MAX = 0, FIXED_MAX = 1, EXP2_FOLD = 2;

template <typename T, int MODE>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Skv, int D, float scale, float fixed_max) {
  extern __shared__ float smem[];
  const int ld = D | 1;                // odd stride for Q and K rows
  float* Qs = smem;                    // [BQ][ld]
  float* Ks = Qs + BQ * ld;            // [BKV][ld]
  float* Vs = Ks + BKV * ld;           // [BKV][D]
  float* Ps = Vs + BKV * D;            // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // score columns tx + 16*j; output columns tx + 16*j
  const int ty = tid / 16;   // rows ty*4 + i
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;
  T* ob = o + bh * Sq * D;
  const int nj = (D + 15) / 16;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[r * ld + d] = q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float m_run[4], l_run[4], acc[4][MAX_DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_BIG;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BKV * D; e += NT) {
      const int r = e / D, d = e % D;
      const bool ok = kv0 + r < Skv;
      const size_t g = (size_t)(kv0 + r) * D + d;
      Ks[r * ld + d] = ok ? to_f32(kb[g]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kv0 + tx + 16 * j < Skv;
        if (MODE == EXP2_FOLD)
          s[i][j] = ok ? s[i][j] + fixed_max : -INFINITY;
        else
          s[i][j] = ok ? s[i][j] * scale : -INFINITY;
      }
      float shift = fixed_max;
      if (MODE == RUNNING_MAX) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        const float m_new = fmaxf(m_run[i], half_warp_max(mx));
        const float alpha = expf(m_run[i] - m_new);
        l_run[i] *= alpha;
#pragma unroll
        for (int j = 0; j < MAX_DJ; ++j) acc[i][j] *= alpha;
        m_run[i] = m_new;
        shift = m_new;
      }
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = MODE == EXP2_FOLD ? exp2f(s[i][j]) : expf(s[i][j] - shift);
        psum += p;
        Ps[(ty * 4 + i) * (BKV + 1) + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
      l_run[i] += half_warp_sum(psum);
    }
    __syncthreads();

    const int kv_n = min(BKV, Skv - kv0);
    for (int kk = 0; kk < kv_n; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < MAX_DJ; ++j) {
        if (j < nj) {
          const int d = tx + 16 * j;
          const float vv = d < D ? Vs[kk * D + d] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j) {
      const int d = tx + 16 * j;
      if (j < nj && d < D) ob[(size_t)r * D + d] = from_f32<T>(acc[i][j] / l_run[i]);
    }
  }
}

template <typename T, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Skv, int D, float scale, float fixed_max,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)BH);
  flash_kernel<T, MODE><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, D, scale, fixed_max);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 8;
constexpr int TC_NT = 32 * TC_WARPS;  // threads
constexpr int TC_BQ = 16 * TC_WARPS;  // query rows per block, 16 per warp
constexpr int TC_BKV = 64;            // keys per tile
constexpr int TC_STAGES = 3;          // K/V tiles in flight: one barrier per tile
constexpr float LOG2E = 1.4426950408889634f;

// Q [TC_BQ][DK + 8], then K and V, each [TC_STAGES][TC_BKV][DK + 8]. The
// pad of 8 makes each row an odd number of 16-byte units, so the eight rows
// one ldmatrix reads fall in distinct banks.
size_t tc_smem_bytes(int DK) {
  return sizeof(bf16) * (size_t)(TC_BQ + 2 * TC_STAGES * TC_BKV) * (DK + 8);
}

// Rows [row0, row0 + ROWS) of a row-major (n_rows, D) matrix into shared
// rows of DK + 8 elements, zeros past n_rows and past column D.
template <int DK, int ROWS>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, int row0,
                                          int n_rows, int D, bool vec) {
  constexpr int LD = DK + 8;
  if (vec) {  // D % 8 == 0, g 16-byte aligned: asynchronous 16-byte copies
    constexpr int CH = DK / 8;
    for (int e = threadIdx.x; e < ROWS * CH; e += TC_NT) {
      const int r = e / CH, c = e % CH;
      const bool ok = row0 + r < n_rows && c * 8 < D;
      tc::cp_async16(tc::smem_addr(sm + r * LD + c * 8),
                     ok ? g + (size_t)(row0 + r) * D + c * 8 : g, ok ? 16 : 0);
    }
  } else {  // masked 2-byte loads
    for (int e = threadIdx.x; e < ROWS * DK; e += TC_NT) {
      const int r = e / DK, d = e % DK;
      sm[r * LD + d] = row0 + r < n_rows && d < D
                           ? g[(size_t)(row0 + r) * D + d]
                           : __float2bfloat16(0.f);
    }
  }
}

// Scores to the exponent x, p = 2^(x - m): mode 0 x = s * c1 (c1 = scale *
// log2 e) with m the running row max of x; mode 1 x = s * c1 + c0 (c0 = -FM
// * log2 e), m = 0; mode 2 x = s + c0 (c0 = the shift), m = 0.
// DK: q.k^T depth (D padded to 16); DN: P.V columns (D padded to 8).
template <int MODE, int DK, int DN>
__global__ void __launch_bounds__(TC_NT) flash_kernel_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv, int D,
    float c1, float c0, int vec) {
  static_assert(DK % 16 == 0 && DN % 8 == 0 && DN <= DK, "tile shapes");
  constexpr int LD = DK + 8;
  constexpr int NJ = TC_BKV / 8;  // score n-tiles of a warp
  constexpr int NO = DN / 8;      // output n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TC_BQ * LD;
  bf16* Vs = Ks + TC_STAGES * TC_BKV * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * TC_BQ;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * Sq * D;
  const bf16* kb = k + bh * Skv * D;
  const bf16* vb = v + bh * Skv * D;
  bf16* ob = o + bh * Sq * D;
  const int n_tiles = (Skv + TC_BKV - 1) / TC_BKV;

  // one copy group per tile, the first with Q; tiles 0 and 1 in flight
  load_rows<DK, TC_BQ>(Qs, qb, q0, Sq, D, vec);
  for (int t = 0; t < 2 && t < n_tiles; ++t) {
    load_rows<DK, TC_BKV>(Ks + t * TC_BKV * LD, kb, t * TC_BKV, Skv, D, vec);
    load_rows<DK, TC_BKV>(Vs + t * TC_BKV * LD, vb, t * TC_BKV, Skv, D, vec);
    tc::cp_async_commit();
  }

  uint32_t qf[DK / 16][4];  // this warp's 16 rows of Q as A fragments
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows g = lane / 4 (h = 0: fragment elements 0, 1) and g + 8 (h = 1: 2, 3)
  float m_run[2] = {NEG_BIG, NEG_BIG}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % TC_STAGES;
    if (t + 1 < n_tiles)
      tc::cp_async_wait<1>();  // tile t has landed; t + 1 may be in flight
    else
      tc::cp_async_wait<0>();
    // tile t is visible to all, and every warp is done with tile t - 1,
    // whose stage tile t + 2 takes: its copy runs under two tiles' math
    __syncthreads();
    if (t + 2 < n_tiles) {
      const int s2 = (t + 2) % TC_STAGES;
      load_rows<DK, TC_BKV>(Ks + s2 * TC_BKV * LD, kb, (t + 2) * TC_BKV, Skv, D, vec);
      load_rows<DK, TC_BKV>(Vs + s2 * TC_BKV * LD, vb, (t + 2) * TC_BKV, Skv, D, vec);
      tc::cp_async_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        tc::ldmatrix_x4(qf[kk], tc::smem_addr(Qs + (warp * 16 + (lane & 15)) * LD +
                                              kk * 16 + (lane >> 4) * 8));
    }
    const bf16* Kt = Ks + st * TC_BKV * LD;
    const bf16* Vt = Vs + st * TC_BKV * LD;

    // S = Q K^T: K's rows are the columns of B, so ldmatrix without .trans
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t b[4];
        tc::ldmatrix_x4(b, tc::smem_addr(
                               Kt + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8));
        tc::mma_bf16(s[j], qf[kk], b[0], b[1]);
        tc::mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
      }
    }

    const int kv0 = t * TC_BKV;
    const bool ragged = kv0 + TC_BKV > Skv;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = MODE == EXP2_FOLD ? s[j][e] + c0
                  : MODE == FIXED_MAX ? fmaf(s[j][e], c1, c0)
                                      : s[j][e] * c1;
        if (ragged && kv0 + j * 8 + 2 * (lane & 3) + (e & 1) >= Skv) x = -INFINITY;
        s[j][e] = x;
      }
    if (MODE == RUNNING_MAX) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx);
        const float alpha = tc::ex2(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= alpha;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          acc[j][2 * h] *= alpha;
          acc[j][2 * h + 1] *= alpha;
        }
      }
    }
    // p in fp32 for l, rounded to bf16 straight into P.V's A fragments:
    // k-step kk covers score tiles 2kk (a0, a1) and 2kk + 1 (a2, a3)
    uint32_t pa[TC_BKV / 16][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = tc::ex2(MODE == RUNNING_MAX ? s[j][e] - m_run[e >> 1] : s[j][e]);
      l_run[0] += p[0] + p[1];
      l_run[1] += p[2] + p[3];
      pa[j / 2][(j & 1) * 2] = tc::pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = tc::pack_bf16(p[2], p[3]);
    }

    // O += P V: V's rows are the k of B, so ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TC_BKV / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];  // n-tiles j and j + 1 (past DN: zero columns, unused)
        tc::ldmatrix_x4_trans(b, tc::smem_addr(
                                     Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                     j * 8 + (lane >> 4) * 8));
        tc::mma_bf16(acc[j], pa[kk], b[0], b[1]);
        if (j + 1 < NO) tc::mma_bf16(acc[j + 1 < NO ? j + 1 : j], pa[kk], b[2], b[3]);
      }
    }
  }

  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = q0 + warp * 16 + g + 8 * h;
    if (r >= Sq) continue;
    bf16* orow = ob + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = j * 8 + c;
      const float y0 = acc[j][2 * h] / l, y1 = acc[j][2 * h + 1] / l;
      if (vec && d + 1 < D) {  // D % 8 == 0: an aligned pair
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(y0, y1);
      } else {
        if (d < D) orow[d] = __float2bfloat16(y0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16(y1);
      }
    }
  }
}

template <int MODE, int DK, int DN>
int launch_tc_d(const void* q, const void* k, const void* v, void* o, int BH,
                int Sq, int Skv, int D, float c1, float c0, int vec,
                cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(DK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_tc<MODE, DK, DN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + TC_BQ - 1) / TC_BQ), (unsigned)BH);
  flash_kernel_tc<MODE, DK, DN><<<grid, TC_NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Sq, Skv, D, c1,
      c0, vec);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH,
              int Sq, int Skv, int D, float scale, float fixed_max,
              cudaStream_t stream) {
  const float c1 = scale * LOG2E;
  const float c0 = MODE == EXP2_FOLD ? fixed_max
                   : MODE == FIXED_MAX ? -fixed_max * LOG2E : 0.f;
  const int vec = D % 8 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) == 0;
  if (D <= 40)
    return launch_tc_d<MODE, 48, 40>(q, k, v, o, BH, Sq, Skv, D, c1, c0, vec, stream);
  if (D <= 80)
    return launch_tc_d<MODE, 80, 80>(q, k, v, o, BH, Sq, Skv, D, c1, c0, vec, stream);
  return launch_tc_d<MODE, 160, 160>(q, k, v, o, BH, Sq, Skv, D, c1, c0, vec, stream);
}

}  // namespace

// q: (BH, Sq, D), k/v: (BH, Skv, D), o: (BH, Sq, D), all contiguous, D <= 160.
// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel). mode: 0 = running max, 1 = static shift fixed_max, 2 =
// exp2-folded (q pre-scaled by scale * log2 e, fixed_max holds the shift
// -FM * log2 e, scale is unused). On a launch without error, *design (when
// not null) is set to the kernel that ran: 0 = SIMT, 1 = tensor cores.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int BH, int Sq, int Skv, int D,
                                   float scale, int mode, float fixed_max,
                                   int dtype, void* stream, int* design) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (D < 1 || D > 16 * MAX_DJ || (dtype != 0 && dtype != 1) || mode < 0 ||
      mode > EXP2_FOLD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0) {
    rc = mode == RUNNING_MAX ? launch<float, RUNNING_MAX>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s)
         : mode == FIXED_MAX ? launch<float, FIXED_MAX>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s)
                             : launch<float, EXP2_FOLD>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s);
  } else {
    rc = mode == RUNNING_MAX ? launch_tc<RUNNING_MAX>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s)
         : mode == FIXED_MAX ? launch_tc<FIXED_MAX>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s)
                             : launch_tc<EXP2_FOLD>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s);
  }
  if (rc == 0 && design != nullptr) *design = dtype;
  return rc;
}
