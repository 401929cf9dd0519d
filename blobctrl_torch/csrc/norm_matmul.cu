// Normalize-prologue GEMM for NVIDIA Hopper (sm_90a): y = a(x) @ W + bias
// [+ residual] over rows of x, where a() is a normalization applied as x is
// loaded, so the normalized activation never goes to device memory.
//
// Replaces:
//   * blobctrl_tpu/ops/gn_matmul.py `_affine_matmul_kernel` (`:64`) and
//     `_affine_matmul_res_kernel` (`:85`): the GroupNorm apply of a
//     Transformer2D folded into its 1x1 proj_in (or proj_out + residual).
//     a(x) = round_to_x_dtype(x * s[b, c] + t[b, c]), b = row / (H*W); the
//     per-(batch, channel) s and t come from the fp32 GroupNorm statistics,
//     computed outside the kernel (as they are computed in XLA outside the
//     Pallas kernel). The residual mode adds residual[row, n] after the
//     bias; its affine=False variant (`matmul_residual`) skips a().
//   * blobctrl_tpu/ops/ln_matmul.py `_ln_matmul_kernel` (`:38`): the
//     pre-LayerNorm of a transformer block fused into the projection after
//     it (self-attention QKV, cross-attention to_q, GEGLU proj_in). From
//     each row's fp32 mean and two-pass variance over C, a(x) =
//     round_to_x_dtype(((x - mean) * rsqrt(var + eps)) * gamma[c] + beta[c])
//     is applied as x is loaded.
// The three prologues (none, affine, LayerNorm) and the two epilogues
// (plain, residual) share one template in each of the two kernels below.
//
// What bounds it on the H100: 2*M*C*N operations against x + W + y bytes
// (+ residual). At the main path's shapes (M = 16384 rows of C = 320 into
// N = 320..2560, down to M = 128 rows of C = 1280 into N = 10240) that is
// hundreds of operations per byte, so it is bound by arithmetic, whose rate
// on this card is the bf16 tensor-core peak; the smallest calls (M = 128)
// are a few microseconds of work, so launches and filling 132 SMs count.
//
// Two kernels, chosen by dtype in the C entry points (never one as a
// fallback of the other):
//
// bf16: `norm_matmul_kernel_tc`, on the tensor cores through the shared
// mainloop of csrc/gemm_bf16.cuh. A block owns 128 rows x 256 columns (8
// warps, one block an SM) where N % 256 == 0, else x 128 (4 warps, two
// blocks an SM): each x element is normalized once per column block, so
// the wider block halves that work and a quarter of the copies per
// product. K slices of x and of W (64 channels in 3 stages for the wide
// block, 32 in 4 for the narrow one) stream through two cp.async rings,
// zero-filled past M, C and N; each thread applies the prologue once per
// element, in place, to the chunks of x it copied; the products run on
// mma.sync. (Staging a slice's parameters beside it, copied by a few
// threads, bought no time on the card and would need a barrier between
// those copies and the other threads' prologue.) The LayerNorm statistics
// are computed ONCE per row by a small kernel before the GEMM
// (`ln_stats_kernel`, one warp per row, the same fp32 sum and two-pass
// variance as below) into an (M, 2) fp32 mean and rstd that the GEMM's
// prologue reads (the SIMT kernel recomputes them in each of the N / 64
// column blocks: 40 times a row for GEGLU's proj_in). A stats pass rather
// than a block that walks every N tile: the small-M calls (M = 128) need
// their N tiles spread over the SMs. Where the row and column blocks are
// fewer than the SMs, the wrapper splits C across blocks (grid z,
// `ops/gn_matmul.launch_config`); a second kernel adds the fp32 partial
// sums in order with the bias and residual. Left for later: wgmma with
// TMA, and staging the output tile through shared memory.
//
// fp32: `norm_matmul_kernel`, the first version, SIMT, kept for the fp32
// checks: 64 x 64 output tile per 256-thread block, 4 x 4 outputs per
// thread, K walked in 16-channel slices through shared memory, converting
// to fp32 on load and accumulating on the CUDA cores; each block reduces
// its rows' LayerNorm statistics itself, and the prologue is recomputed for
// each 64-column tile of the output.
//
// Any M, C and N (ragged tails masked): unlike the TPU kernel's block-size
// fallback, rows of an h*w that is no multiple of 8 are computed like any
// other. The prologues use explicit _rn intrinsics (no FMA contraction), so
// they round as the plain versions do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemm_bf16.cuh"

namespace {

constexpr int BM = 64;    // rows per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 16;    // input channels per K slice
constexpr int NT = 256;   // threads per block (16 x 16, 4x4 outputs each)
constexpr int A_PER_THREAD = BM * BK / NT;   // 4
constexpr int B_PER_THREAD = BK * BN / NT;   // 4

constexpr int PRO_NONE = 0, PRO_AFFINE = 1, PRO_LAYERNORM = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// p0/p1: the affine's (B, C) s and t, or LayerNorm's (C,) gamma and beta.
template <typename T, int PRO, bool RES>
__global__ void __launch_bounds__(NT) norm_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ p0,
    const float* __restrict__ p1, const T* __restrict__ res,
    T* __restrict__ y, int M, int HW, int C, int N, float eps) {
  // A is stored k-major with an odd row stride: the 16 threads that store
  // one row's 16-channel slice hit 16 different banks.
  __shared__ float As[BK][BM + 1];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float row_mean[BM], row_rstd[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // output column group: n = tx*4 + j
  const int ty = tid / 16;   // output row group:    m = ty*4 + i
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  if (PRO == PRO_LAYERNORM) {
    // one warp per row: mean, then the two-pass variance, over C
    const int lane = tid % 32, warp = tid / 32;
    for (int r = warp; r < BM; r += NT / 32) {
      const long long m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < M) {
        const T* xr = x + m * C;
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
        mean = __fdiv_rn(warp_sum(s), (float)C);
        float ss = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float d = __fsub_rn(to_f32(xr[c]), mean);
          ss = __fadd_rn(ss, __fmul_rn(d, d));
        }
        rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)C), eps));
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  // A loads: thread loads channel a_k of rows a_row + 16*i.
  const int a_k = tid % BK;
  const int a_row = tid / BK;
  bool a_ok[A_PER_THREAD];
  int a_b[A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const long long m = m0 + a_row + 16 * i;
    a_ok[i] = m < M;
    a_b[i] = PRO == PRO_AFFINE && a_ok[i] ? (int)(m / HW) : 0;
  }
  // B loads: thread loads output column b_n of K rows b_k + 4*i.
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool b_ok = n0 + b_n < N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    const int c = c0 + a_k;
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int r = a_row + 16 * i;
      float v = 0.f;
      if (a_ok[i] && c < C) {
        v = to_f32(x[(m0 + r) * C + c]);
        if (PRO == PRO_AFFINE) {
          const long long bc = (long long)a_b[i] * C + c;
          v = to_f32(from_f32<T>(__fadd_rn(__fmul_rn(v, p0[bc]), p1[bc])));
        } else if (PRO == PRO_LAYERNORM) {
          v = __fmul_rn(__fsub_rn(v, row_mean[r]), row_rstd[r]);
          v = to_f32(from_f32<T>(__fadd_rn(__fmul_rn(v, p0[c]), p1[c])));
        }
      }
      As[a_k][r] = v;
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int k = b_k + 4 * i;
      const int cc = c0 + k;
      float v = 0.f;
      if (b_ok && cc < C) v = to_f32(w[(long long)cc * N + n0 + b_n]);
      Bs[k][b_n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = __fadd_rn(acc[i][j], bias[n]);
      if (RES) v = __fadd_rn(v, to_f32(res[m * N + n]));
      y[m * N + n] = from_f32<T>(v);
    }
  }
}

template <typename T, int PRO, bool RES>
int launch(const void* x, const void* w, const float* bias, const float* p0,
           const float* p1, const void* res, void* y, int M, int HW, int C,
           int N, float eps, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  norm_matmul_kernel<T, PRO, RES><<<grid, NT, 0, stream>>>(
      (const T*)x, (const T*)w, bias, p0, p1, (const T*)res, (T*)y, M, HW, C,
      N, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_affine(const void* x, const void* w, const float* bias,
                  const float* s, const float* t, const void* res, void* y,
                  int M, int HW, int C, int N, cudaStream_t stream) {
  if (s != nullptr)
    return res != nullptr
               ? launch<T, PRO_AFFINE, true>(x, w, bias, s, t, res, y, M, HW, C, N, 0.f, stream)
               : launch<T, PRO_AFFINE, false>(x, w, bias, s, t, res, y, M, HW, C, N, 0.f, stream);
  return res != nullptr
             ? launch<T, PRO_NONE, true>(x, w, bias, s, t, res, y, M, HW, C, N, 0.f, stream)
             : launch<T, PRO_NONE, false>(x, w, bias, s, t, res, y, M, HW, C, N, 0.f, stream);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
// The block's columns: 256 (8 warps, one block an SM) where N % 256 == 0,
// else 128 (4 warps, two blocks an SM); ops/gn_matmul.launch_config mirrors.
// Each takes its own K slice and ring depth (measured on the card: the
// narrow block runs faster on 32-channel slices in 4 stages, the wide one
// on 64-channel slices in 3).
constexpr int WIDE_BN = 256, NARROW_BN = 128;
constexpr int WIDE_BK = 64, WIDE_STAGES = 3;
constexpr int NARROW_BK = 32, NARROW_STAGES = 4;

template <int BN>
struct Shape {
  static constexpr int BK = BN == WIDE_BN ? WIDE_BK : NARROW_BK;          // channels a slice
  static constexpr int STAGES = BN == WIDE_BN ? WIDE_STAGES : NARROW_STAGES;  // both rings
  static constexpr int A_LD = BK + 8;  // x rows in shared memory
};

// per stage: the x slice and the W slice; then the rows' LayerNorm mean
// and rstd
template <int BN>
constexpr int tc_smem() {
  using S = Shape<BN>;
  return (int)sizeof(bf16) * S::STAGES *
             (gemm::BM * S::A_LD + S::BK * gemm::Tile<BN>::B_LD) +
         (int)sizeof(float) * 2 * gemm::BM;
}
static_assert(tc_smem<WIDE_BN>() <= 232448, "shared memory of one block");

// mean and rstd of each row of x (M, C) into stats (M, 2): one warp a row,
// the SIMT kernel's arithmetic.
__global__ void ln_stats_kernel(const bf16* __restrict__ x,
                                float* __restrict__ stats, int M, int C,
                                float eps) {
  const int lane = threadIdx.x % 32;
  const long long m = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;  // the whole warp
  const bf16* xr = x + m * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
  const float mean = __fdiv_rn(warp_sum(s), (float)C);
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = __fsub_rn(__bfloat162float(xr[c]), mean);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)C), eps));
  if (lane == 0) {
    stats[2 * m] = mean;
    stats[2 * m + 1] = rstd;
  }
}

// The A operand of the mainloop: 128 rows of x, one K slice at a time.
// Thread t of NT copies the 16-byte chunk t % (BK / 8) (8 channels) of
// rows t / (BK / 8) + (8 NT / BK) i, and runs the prologue on exactly those
// chunks, so it waits for no other thread's copies. The parameters come from device
// memory (a slice's are a few hundred bytes, L1-resident for the block);
// the rows' LayerNorm mean and rstd from shared memory (row_stats, staged by
// the kernel before the mainloop).
// p0/p1: the affine's (B, C) s and t, or LayerNorm's (C,) gamma and beta.
template <int PRO, int NT, int BK, int STAGES>
struct RowLoader {
  static constexpr int TAPS = 1, ROWS = gemm::BM, A_STAGES = STAGES;
  static constexpr int A_LD = BK + 8;
  static constexpr int CPR = BK / 8;  // chunks a row
  static constexpr int NCH = ROWS * CPR / NT;
  static constexpr int STAGE_ELEMS = ROWS * A_LD;
  static_assert(ROWS * CPR % NT == 0, "whole chunks a thread");
  const bf16* x;
  const float* p0;
  const float* p1;
  const float* row_stats;  // shared: the block's rows' (mean, rstd) (LayerNorm)
  long long m0;            // the block's first row
  int M, HW, C, c_end;
  bool x_vec;              // 16-byte copies: C % 8 == 0 and x aligned

  __device__ __forceinline__ int a_row(int row, int) const { return row; }

  // a(x) on the first n of the 8 channels [c, c + 8) of row r of the
  // block, 0 on the others; g, bt: LayerNorm's gamma and beta at c, or the
  // affine's s and t of batch cb at c (reloaded when row r lies in another)
  __device__ __forceinline__ uint4 apply(uint4 v, int r, int c, int n,
                                         float (&g)[8], float (&bt)[8],
                                         int& cb) const {
    float f[8];
    gemm::unpack8(v, f);
    if (PRO == PRO_AFFINE) {
      const int b = ((int)m0 + r) / HW;
      if (b != cb) {
        cb = b;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          g[e] = e < n ? p0[(size_t)b * C + c + e] : 0.f;
          bt[e] = e < n ? p1[(size_t)b * C + c + e] : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = e < n ? __fadd_rn(__fmul_rn(f[e], g[e]), bt[e]) : 0.f;
    } else {
      const float mean = row_stats[2 * r], rstd = row_stats[2 * r + 1];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xn = __fmul_rn(__fsub_rn(f[e], mean), rstd);
        f[e] = e < n ? __fadd_rn(__fmul_rn(xn, g[e]), bt[e]) : 0.f;
      }
    }
    return gemm::pack8(f);
  }

  __device__ __forceinline__ void load_gamma_beta(int c, float (&g)[8],
                                                  float (&bt)[8]) const {
    if (PRO == PRO_LAYERNORM) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        g[e] = c + e < c_end ? p0[c + e] : 0.f;
        bt[e] = c + e < c_end ? p1[c + e] : 0.f;
      }
    }
  }

  // slice c0 into stage as: 16-byte copies (zeros past M and c_end), or,
  // without them, 2-byte loads through the prologue
  __device__ __forceinline__ void issue(bf16* as, int c0) const {
    const int c = c0 + (threadIdx.x % CPR) * 8;
    bf16* dst = as + (threadIdx.x % CPR) * 8;
    float g[8], bt[8];
    int cb = -1;
    if (!x_vec) load_gamma_beta(c, g, bt);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int r = threadIdx.x / CPR + i * (NT / CPR);
      const long long m = m0 + r;
      const bool in = m < M && c < c_end;
      if (x_vec) {
        tc::cp_async16(tc::smem_addr(dst + r * A_LD), in ? x + m * C + c : x,
                       in ? 16 : 0);
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (in) {
          v = gemm::load8_masked(x + m * C + c, c, c_end);
          if (PRO != PRO_NONE) v = apply(v, r, c, c_end - c, g, bt, cb);
        }
        *reinterpret_cast<uint4*>(dst + r * A_LD) = v;
      }
    }
  }

  // the prologue in place on the chunks this thread copied; rows past M
  // and channels past c_end stay 0
  __device__ __forceinline__ void prologue(bf16* as, int c0) const {
    if (PRO == PRO_NONE || !x_vec) return;
    const int c = c0 + (threadIdx.x % CPR) * 8;
    if (c >= c_end) return;
    bf16* dst = as + (threadIdx.x % CPR) * 8;
    float g[8], bt[8];
    int cb = -1;
    load_gamma_beta(c, g, bt);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int r = threadIdx.x / CPR + i * (NT / CPR);
      if (m0 + r >= M) continue;
      uint4* p = reinterpret_cast<uint4*>(dst + r * A_LD);
      *p = apply(*p, r, c, 8, g, bt, cb);
    }
  }
};

// grid: (row blocks, column blocks, splits); channels [c_begin, c_end) of C
// for split blockIdx.z. ws null: y = a(x) W + bias [+ res] in bf16; else
// the fp32 product of this split into ws[blockIdx.z].
template <int PRO, bool RES, int BN>
__global__ void __launch_bounds__(gemm::Tile<BN>::NT, BN == NARROW_BN ? 2 : 1) norm_matmul_kernel_tc(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ p0,
    const float* __restrict__ p1, const float* __restrict__ stats,
    const bf16* __restrict__ res, bf16* __restrict__ y, float* __restrict__ ws,
    int M, int HW, int C, int N, int c_per, int x_vec, int w_vec) {
  using T = gemm::Tile<BN>;
  using S = Shape<BN>;
  using L = RowLoader<PRO, T::NT, S::BK, S::STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [S::STAGES][BM][S::A_LD]
  bf16* Bs = As + S::STAGES * L::STAGE_ELEMS;     // [S::STAGES][S::BK][T::B_LD]
  float* row_stats = reinterpret_cast<float*>(Bs + S::STAGES * S::BK * T::B_LD);  // [BM][2]
  const long long m0 = (long long)blockIdx.x * gemm::BM;
  const int n0 = blockIdx.y * BN;
  const int c_begin = blockIdx.z * c_per;
  const int c_end = min(C, c_begin + c_per);
  if (PRO == PRO_LAYERNORM) {
    for (int r = threadIdx.x; r < gemm::BM; r += T::NT) {
      const bool in = m0 + r < M;
      row_stats[2 * r] = in ? stats[2 * (m0 + r)] : 0.f;
      row_stats[2 * r + 1] = in ? stats[2 * (m0 + r) + 1] : 0.f;
    }
    __syncthreads();
  }

  L ld;
  ld.x = x;
  ld.p0 = p0;
  ld.p1 = p1;
  ld.row_stats = row_stats;
  ld.m0 = m0;
  ld.M = M;
  ld.HW = HW;
  ld.C = C;
  ld.c_end = c_end;
  ld.x_vec = x_vec;

  float acc[gemm::MT][gemm::NJ][4];
#pragma unroll
  for (int mt = 0; mt < gemm::MT; ++mt)
#pragma unroll
    for (int j = 0; j < gemm::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  gemm::mainloop<T, S::BK, S::STAGES>(ld, w, 0, N, n0, c_begin, c_end, w_vec,
                                      As, Bs, acc);

  float* wsz = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * M * N;
  gemm::for_each_pair<T>(acc, [&](int row, int col, float v0, float v1) {
    const long long m = m0 + row;
    const int n = n0 + col;
    if (m < M && n < N)
      gemm::store_pair((size_t)m * N + n, n, N, v0, v1, bias, RES ? res : nullptr,
                       y, wsz);
  });
}

template <int PRO, bool RES, int BN>
int launch_tc_bn(const void* x, const void* w, const float* bias,
                 const float* p0, const float* p1, const float* stats,
                 const void* res, void* y, float* ws, int M, int HW, int C,
                 int N, int splits, cudaStream_t stream) {
  constexpr int smem = tc_smem<BN>();
  constexpr int BK = Shape<BN>::BK;
  const int slices = (C + BK - 1) / BK;
  const int c_per = (slices + splits - 1) / splits * BK;
  const int x_vec = C % 8 == 0 && ((uintptr_t)x & 15) == 0;
  const int w_vec = N % 8 == 0 && ((uintptr_t)w & 15) == 0;
  static bool smem_set = false;
  cudaError_t err = gemm::allow_smem(norm_matmul_kernel_tc<PRO, RES, BN>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + gemm::BM - 1) / gemm::BM),
                  (unsigned)((N + BN - 1) / BN), (unsigned)splits);
  norm_matmul_kernel_tc<PRO, RES, BN><<<grid, gemm::Tile<BN>::NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, bias, p0, p1, stats, (const bf16*)res,
      (bf16*)y, splits > 1 ? ws : nullptr, M, HW, C, N, c_per, x_vec, w_vec);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)gemm::split_sum(ws, bias, (const bf16*)res, (bf16*)y,
                                (long long)M * N, N, splits, stream);
  }
  return (int)cudaGetLastError();
}

template <int PRO, bool RES>
int launch_tc(const void* x, const void* w, const float* bias, const float* p0,
              const float* p1, const float* stats, const void* res, void* y,
              float* ws, int M, int HW, int C, int N, int splits,
              cudaStream_t stream) {
  return N % WIDE_BN == 0
             ? launch_tc_bn<PRO, RES, WIDE_BN>(x, w, bias, p0, p1, stats, res, y, ws, M, HW, C, N, splits, stream)
             : launch_tc_bn<PRO, RES, NARROW_BN>(x, w, bias, p0, p1, stats, res, y, ws, M, HW, C, N, splits, stream);
}

template <int PRO>
int launch_tc_epilogue(const void* x, const void* w, const float* bias,
                       const float* p0, const float* p1, const float* stats,
                       const void* res, void* y, float* ws, int M, int HW,
                       int C, int N, int splits, cudaStream_t stream) {
  return res != nullptr
             ? launch_tc<PRO, true>(x, w, bias, p0, p1, stats, res, y, ws, M, HW, C, N, splits, stream)
             : launch_tc<PRO, false>(x, w, bias, p0, p1, stats, res, y, ws, M, HW, C, N, splits, stream);
}

}  // namespace

// K10. x: (M, C) rows of B images of HW pixels each (M = B * HW); w: (C, N);
// y, res: (M, N); all contiguous, of one dtype (0 = float32, the SIMT
// kernel; 1 = bfloat16, the tensor-core kernel). bias: (N,) fp32. s, t:
// (B, C) fp32, or both null for no affine. res: null for the plain
// epilogue. splits (bf16 only; 1 for fp32): the number of blocks C is split
// across, with ws an fp32 (splits, M, N) workspace when splits > 1. On a
// launch without error, *design (when not null) is set to the kernel that
// ran: 0 = SIMT, 1 = tensor cores. Returns cudaGetLastError() after the
// launch.
extern "C" int affine_matmul_fwd(const void* x, const void* w, const void* bias,
                                 const void* s, const void* t, const void* res,
                                 void* y, int M, int HW, int C, int N, int dtype,
                                 int splits, void* ws, void* stream,
                                 int* design) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (M < 1 || HW < 1 || C < 1 || N < 1 || (s == nullptr) != (t == nullptr) ||
      splits < 1 || splits > 65535 || (splits > 1 && (dtype != 1 || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 0)
    rc = launch_affine<float>(x, w, (const float*)bias, (const float*)s,
                              (const float*)t, res, y, M, HW, C, N, st);
  else if (dtype == 1 && s != nullptr)
    rc = launch_tc_epilogue<PRO_AFFINE>(x, w, (const float*)bias, (const float*)s,
                                        (const float*)t, nullptr, res, y, (float*)ws,
                                        M, HW, C, N, splits, st);
  else if (dtype == 1)
    rc = launch_tc_epilogue<PRO_NONE>(x, w, (const float*)bias, nullptr, nullptr,
                                      nullptr, res, y, (float*)ws, M, HW, C, N,
                                      splits, st);
  if (rc == 0 && design != nullptr) *design = dtype;
  return rc;
}

// K11. x: (M, C); w: (C, N); y: (M, N); all contiguous, of one dtype
// (0 = float32, the SIMT kernel; 1 = bfloat16, the tensor-core kernel).
// bias: (N,) fp32; gamma, beta: (C,) fp32. stats (bf16): an fp32 (M, 2)
// workspace for the rows' mean and rstd. splits and ws as for K10; design
// likewise. Returns cudaGetLastError() after the launches.
extern "C" int ln_matmul_fwd(const void* x, const void* w, const void* bias,
                             const void* gamma, const void* beta, void* y,
                             int M, int C, int N, float eps, int dtype,
                             int splits, void* ws, void* stats, void* stream,
                             int* design) {
  cudaGetLastError();
  if (M < 1 || C < 1 || N < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && (dtype != 1 || ws == nullptr)) ||
      (dtype == 1 && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = launch<float, PRO_LAYERNORM, false>(
        x, w, (const float*)bias, (const float*)gamma, (const float*)beta,
        nullptr, y, M, 1, C, N, eps, st);
  } else if (dtype == 1) {
    constexpr int ROWS_A_BLOCK = 8;  // ln_stats_kernel: one warp a row
    ln_stats_kernel<<<(unsigned)((M + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK), 32 * ROWS_A_BLOCK, 0,
                      st>>>((const bf16*)x, (float*)stats, M, C, eps);
    rc = (int)cudaGetLastError();
    if (rc == 0)
      rc = launch_tc<PRO_LAYERNORM, false>(
          x, w, (const float*)bias, (const float*)gamma, (const float*)beta,
          (const float*)stats, nullptr, y, (float*)ws, M, 1, C, N, splits, st);
  }
  if (rc == 0 && design != nullptr) *design = dtype;
  return rc;
}
