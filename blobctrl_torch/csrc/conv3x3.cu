// 3x3 stride-1 "same" convolution, NHWC x HWIO -> NHWC, with an optional
// fused GroupNorm+SiLU prologue, for NVIDIA Hopper (sm_90a).
//
// Replaces: blobctrl_tpu/ops/conv3x3.py `_conv3x3_kernel_halo` (the Pallas
// kernel the resnet stacks of the UNet, BlobNet and VAE run through) and its
// "views3" twin `_conv3x3_kernel`, which computes the same function.
//
// What it computes: y[b,h,w,n] = bias[n] + sum_{kh,kw,c} a(x[b,h+kh-1,w+kw-1,c])
// * wgt[kh,kw,c,n], where a(v) = round_to_input_dtype(silu(v*scale[b,c] +
// shift[b,c])) when a prologue is given (identity otherwise), and taps that
// fall outside the image contribute 0 -- the activation is applied before
// the zero padding, exactly as the JAX package pads after its prologue.
//
// What bounds it on the H100: at the production shapes (C, Co >= 128) it is
// an implicit GEMM with M = B*H*W, N = Co, K = 9*C, i.e. 2*M*N*K operations
// against (x + w + y) bytes: hundreds of operations per byte, so it is bound
// by arithmetic, and the card's rate for that is the bf16 tensor-core peak.
//
// What this first version does about it: nothing clever yet. It is a plain
// register-tiled SIMT GEMM (64x64 output tile per 256-thread block, 4x4 per
// thread, K walked tap by tap in 16-channel slices through shared memory),
// converting bf16 to fp32 on load and accumulating in fp32 on the CUDA
// cores. It takes any C (odd C such as the 1029-channel BlobNet conv_in
// breaks vector loads, so loads are scalar and masked), any Co (no tile
// multiple needed; 320 is ragged) and any H, W. The TPU version's VMEM
// contraction split (two bf16 partial sums) is deliberately not ported:
// here K is one fp32 accumulation. wgmma tiles fed by TMA are the known next
// step for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 16;    // input channels per K slice
constexpr int NT = 256;   // threads per block (16 x 16, 4x4 outputs each)
constexpr int A_PER_THREAD = BM * BK / NT;   // 4
constexpr int B_PER_THREAD = BK * BN / NT;   // 4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <typename T, bool PROLOGUE>
__global__ void __launch_bounds__(NT) conv3x3_kernel(
    const T* __restrict__ x, const T* __restrict__ wgt,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ y,
    int B, int H, int W, int C, int Co) {
  // A is stored k-major with an odd row stride: the 16 threads that store
  // one pixel's 16-channel slice hit 16 different banks.
  __shared__ float As[BK][BM + 1];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // output channel group: n = tx*4 + j
  const int ty = tid / 16;   // output pixel group:   m = ty*4 + i
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: thread loads channel a_k of pixel rows a_row + 16*i.
  const int a_k = tid % BK;
  const int a_row = tid / BK;
  int a_b[A_PER_THREAD], a_h[A_PER_THREAD], a_w[A_PER_THREAD];
  bool a_ok[A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const long long m = m0 + a_row + 16 * i;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    a_b[i] = (int)(mm / ((long long)H * W));
    const int rem = (int)(mm % ((long long)H * W));
    a_h[i] = rem / W;
    a_w[i] = rem % W;
  }
  // B loads: thread loads output channel b_n of K rows b_k + 4*i.
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool b_ok = n0 + b_n < Co;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1;
    const int dw = tap % 3 - 1;
    long long a_off[A_PER_THREAD];
    bool a_in[A_PER_THREAD];
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int ih = a_h[i] + dh, iw = a_w[i] + dw;
      a_in[i] = a_ok[i] && ih >= 0 && ih < H && iw >= 0 && iw < W;
      a_off[i] = (((long long)a_b[i] * H + ih) * W + iw) * C;
    }
    const T* wtap = wgt + (long long)tap * C * Co;

    for (int c0 = 0; c0 < C; c0 += BK) {
      const int c = c0 + a_k;
#pragma unroll
      for (int i = 0; i < A_PER_THREAD; ++i) {
        float v = 0.f;
        if (a_in[i] && c < C) {
          v = to_f32(x[a_off[i] + c]);
          if (PROLOGUE) {
            const long long bc = (long long)a_b[i] * C + c;
            v = v * scale[bc] + shift[bc];
            v = v / (1.f + expf(-v));
            v = to_f32(from_f32<T>(v));  // the activation is rounded to x's dtype
          }
        }
        As[a_k][a_row + 16 * i] = v;
      }
#pragma unroll
      for (int i = 0; i < B_PER_THREAD; ++i) {
        const int k = b_k + 4 * i;
        const int cc = c0 + k;
        float v = 0.f;
        if (b_ok && cc < C) v = to_f32(wtap[(long long)cc * Co + n0 + b_n]);
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Co) y[m * Co + n] = from_f32<T>(acc[i][j] + bias[n]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const float* bias,
            const float* scale, const float* shift, void* y,
            int B, int H, int W, int C, int Co, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  if (scale != nullptr)
    conv3x3_kernel<T, true><<<grid, NT, 0, stream>>>(
        (const T*)x, (const T*)w, bias, scale, shift, (T*)y, B, H, W, C, Co);
  else
    conv3x3_kernel<T, false><<<grid, NT, 0, stream>>>(
        (const T*)x, (const T*)w, bias, scale, shift, (T*)y, B, H, W, C, Co);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scale/shift: (B, C) fp32, or both null
// for no prologue. bias: (Co,) fp32. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int conv3x3_fwd(const void* x, const void* w, const void* bias,
                           const void* scale, const void* shift, void* y,
                           int B, int H, int W, int C, int Co, int dtype,
                           void* stream) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float>(x, w, (const float*)bias, (const float*)scale,
                  (const float*)shift, y, B, H, W, C, Co, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w, (const float*)bias, (const float*)scale,
                          (const float*)shift, y, B, H, W, C, Co, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
