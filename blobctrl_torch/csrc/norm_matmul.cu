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
//     it (self-attention QKV, cross-attention to_q, GEGLU proj_in). Each
//     block first reduces its rows' fp32 mean and two-pass variance over C
//     into shared memory, then applies a(x) = round_to_x_dtype(((x - mean) *
//     rsqrt(var + eps)) * gamma[c] + beta[c]) as it loads x.
// One template covers the three prologues (none, affine, LayerNorm) and the
// two epilogues (plain, residual).
//
// What bounds it on the H100: 2*M*C*N operations against x + W + y bytes
// (+ residual). At the main path's shapes (M = 16384 rows of C = 320 into
// N = 320..2560, down to M = 1024 rows of C = 1280) that is hundreds of
// operations per byte, so it is bound by arithmetic, whose rate on this card
// is the bf16 tensor-core peak.
//
// What this first version does about it: the prologue costs no extra pass
// over device memory; the product is a plain register-tiled SIMT GEMM
// (64 x 64 output tile per 256-thread block, 4 x 4 outputs per thread, K
// walked in 16-channel slices through shared memory), converting to fp32
// on load and accumulating in fp32 on the CUDA cores. The prologue is
// recomputed for each 64-column tile of the output, and the LayerNorm
// statistics with it: x is small next to the product. Any M, C and N
// (ragged tails masked): unlike the TPU kernel's block-size fallback, rows
// of an h*w that is no multiple of 8 are computed like any other.
// The prologue uses explicit _rn intrinsics (no FMA contraction), so it
// rounds as the plain version does. wgmma tiles are the known next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

}  // namespace

// K10. x: (M, C) rows of B images of HW pixels each (M = B * HW); w: (C, N);
// y, res: (M, N); all contiguous, of one dtype (0 = float32, 1 = bfloat16).
// bias: (N,) fp32. s, t: (B, C) fp32, or both null for no affine. res: null
// for the plain epilogue. Returns cudaGetLastError() after the launch.
extern "C" int affine_matmul_fwd(const void* x, const void* w, const void* bias,
                                 const void* s, const void* t, const void* res,
                                 void* y, int M, int HW, int C, int N, int dtype,
                                 void* stream) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (M < 1 || HW < 1 || C < 1 || N < 1 || (s == nullptr) != (t == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_affine<float>(x, w, (const float*)bias, (const float*)s,
                                (const float*)t, res, y, M, HW, C, N, st);
  if (dtype == 1)
    return launch_affine<__nv_bfloat16>(x, w, (const float*)bias, (const float*)s,
                                        (const float*)t, res, y, M, HW, C, N, st);
  return (int)cudaErrorInvalidValue;
}

// K11. x: (M, C); w: (C, N); y: (M, N); all contiguous, of one dtype
// (0 = float32, 1 = bfloat16). bias: (N,) fp32; gamma, beta: (C,) fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int ln_matmul_fwd(const void* x, const void* w, const void* bias,
                             const void* gamma, const void* beta, void* y,
                             int M, int C, int N, float eps, int dtype,
                             void* stream) {
  cudaGetLastError();
  if (M < 1 || C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, PRO_LAYERNORM, false>(
        x, w, (const float*)bias, (const float*)gamma, (const float*)beta,
        nullptr, y, M, 1, C, N, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, PRO_LAYERNORM, false>(
        x, w, (const float*)bias, (const float*)gamma, (const float*)beta,
        nullptr, y, M, 1, C, N, eps, st);
  return (int)cudaErrorInvalidValue;
}
