// int8 3x3 stride-1 "same" convolution, NHWC x HWIO -> NHWC, with an
// optional fused GroupNorm+SiLU prologue and the activation quantize applied
// as x is loaded, for NVIDIA Hopper (sm_90a).
//
// Replaces: blobctrl_tpu/ops/conv3x3.py `_conv3x3_kernel_halo_i8`, the conv
// of the opt-in int8-everything mode (together with the quantize that the
// JAX package runs as an XLA fusion in front of it).
//
// What it computes, with xs = *xs_ptr the ONE activation scale of the call:
//   a(v)  = round_to_x_dtype(silu(v * scale[b,c] + shift[b,c]))  (prologue)
//           or v                                                  (none)
//   q(v)  = clip(rint(a(v) / xs), -127, 127)    true fp32 division, ties even
//   acc   = sum_{kh,kw,c} q(x[b,h+kh-1,w+kw-1,c]) * wq[kh,kw,c,n]  in int32,
//           taps outside the image contributing 0 (padding after the
//           prologue and the quantize)
//   y     = float(acc) * (xs * ws[n]) + bias[n]  in fp32, in that order
// The elementwise steps use explicit round-to-nearest intrinsics so that
// nvcc's FMA contraction cannot change a rounding the plain PyTorch version
// (ops/conv3x3.py `conv3x3_int8_reference`) makes separately: in fp32 the
// two agree bit for bit up to expf.
//
// What bounds it on the H100: 2*M*N*K integer operations (M = B*H*W,
// N = Co, K = 9*C) against x + w + y bytes, hundreds of operations per
// byte at the production shapes, so operations bound it; the card's rate
// for them is the int8 tensor-core peak.
//
// What this first version does about it: nothing clever yet. A register-
// tiled SIMT GEMM (64x64 output tile per 256-thread block, 4x4 outputs a
// thread) whose K walk goes tap by tap in 32-channel slices; activations
// and weights are packed four int8 to a 32-bit word in shared memory and
// multiplied with __dp4a (4 MACs per instruction, int32 accumulate). Loads
// are scalar and masked, so any C (the 1029-channel BlobNet conv_in has
// rows that are not 4-byte aligned), any Co and any H, W work. int32 cannot
// overflow: 9 * 2560 * 127^2 < 2^31. The TPU's VMEM contraction split is
// not ported: K is one int32 accumulation. s8 wgmma tiles fed by TMA are
// the known next step for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output pixels per block
constexpr int BN = 64;          // output channels per block
constexpr int BKW = 8;          // packed 4-channel words per K slice (32 ch)
constexpr int NT = 256;         // threads per block (16 x 16, 4x4 outputs each)
constexpr int A_LD = BM + 4;    // word stride of As: stores hit 32 banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// One activation, prologued and quantized, as the low byte of an int.
template <typename T, bool PROLOGUE>
__device__ __forceinline__ uint32_t quantize(T raw, float sc, float sh, float xs) {
  float v = to_f32(raw);
  if (PROLOGUE) {
    v = __fadd_rn(__fmul_rn(v, sc), sh);
    v = v / (1.f + expf(-v));     // silu as PyTorch computes it
    v = to_f32(from_f32<T>(v));   // rounded to x's dtype before the quantize
  }
  const float r = rintf(fminf(fmaxf(__fdiv_rn(v, xs), -127.f), 127.f));
  return (uint32_t)((int)r & 0xff);
}

template <typename T, bool PROLOGUE>
__global__ void __launch_bounds__(NT) conv3x3_int8_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ xs_ptr, T* __restrict__ y,
    int B, int H, int W, int C, int Co) {
  __shared__ __align__(16) int As[BKW][A_LD];   // [word of K][pixel]
  __shared__ __align__(16) int Bs[BKW][BN];     // [word of K][out channel]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // output channel group: n = tx*4 + j
  const int ty = tid / 16;   // output pixel group:   m = ty*4 + i
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const float xs = *xs_ptr;

  // A loads: thread packs word a_kw of pixel rows a_row and a_row + 32.
  const int a_kw = tid % BKW;
  const int a_row = tid / BKW;
  int a_b[2], a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + a_row + 32 * i;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    a_b[i] = (int)(mm / ((long long)H * W));
    const int rem = (int)(mm % ((long long)H * W));
    a_h[i] = rem / W;
    a_w[i] = rem % W;
  }
  // B loads: thread packs output channel b_n of words b_kw and b_kw + 4.
  const int b_n = tid % BN;
  const int b_kw = tid / BN;
  const bool b_ok = n0 + b_n < Co;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1;
    const int dw = tap % 3 - 1;
    long long a_off[2];
    bool a_in[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ih = a_h[i] + dh, iw = a_w[i] + dw;
      a_in[i] = a_ok[i] && ih >= 0 && ih < H && iw >= 0 && iw < W;
      a_off[i] = (((long long)a_b[i] * H + ih) * W + iw) * C;
    }
    const int8_t* wtap = wq + (long long)tap * C * Co;

    for (int c0 = 0; c0 < C; c0 += 4 * BKW) {
      const int ca = c0 + 4 * a_kw;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t word = 0;
        if (a_in[i]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = ca + e;
            if (c < C) {
              const long long bc = (long long)a_b[i] * C + c;
              word |= quantize<T, PROLOGUE>(x[a_off[i] + c],
                                            PROLOGUE ? scale[bc] : 0.f,
                                            PROLOGUE ? shift[bc] : 0.f, xs)
                      << (8 * e);
            }
          }
        }
        As[a_kw][a_row + 32 * i] = (int)word;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kw = b_kw + 4 * i;
        uint32_t word = 0;
        if (b_ok) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 4 * kw + e;
            if (c < C)
              word |= (uint32_t)(uint8_t)wtap[(long long)c * Co + n0 + b_n] << (8 * e);
          }
        }
        Bs[kw][b_n] = (int)word;
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < BKW; ++kw) {
        const int4 av = *reinterpret_cast<const int4*>(&As[kw][ty * 4]);
        const int4 bv = *reinterpret_cast<const int4*>(&Bs[kw][tx * 4]);
        const int a[4] = {av.x, av.y, av.z, av.w};
        const int b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= Co) continue;
    const float rescale = __fmul_rn(xs, ws[n]);
    const float bn = bias[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ty * 4 + i;
      if (m < M)
        y[m * Co + n] = from_f32<T>(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), rescale), bn));
    }
  }
}

template <typename T>
void launch(const void* x, const int8_t* wq, const float* ws, const float* bias,
            const float* scale, const float* shift, const float* xs, void* y,
            int B, int H, int W, int C, int Co, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  if (scale != nullptr)
    conv3x3_int8_kernel<T, true><<<grid, NT, 0, stream>>>(
        (const T*)x, wq, ws, bias, scale, shift, xs, (T*)y, B, H, W, C, Co);
  else
    conv3x3_int8_kernel<T, false><<<grid, NT, 0, stream>>>(
        (const T*)x, wq, ws, bias, scale, shift, xs, (T*)y, B, H, W, C, Co);
}

}  // namespace

// x: (B, H, W, C) in dtype (0 = float32, 1 = bfloat16); wq: (3, 3, C, Co)
// int8; ws, bias: (Co,) fp32; scale/shift: (B, C) fp32, or both null for no
// prologue; xs: one fp32 on the device, the activation scale. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int conv3x3_int8_fwd(const void* x, const void* wq, const void* ws,
                                const void* bias, const void* scale,
                                const void* shift, const void* xs, void* y,
                                int B, int H, int W, int C, int Co, int dtype,
                                void* stream) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* w8 = (const int8_t*)wq;
  if (dtype == 0)
    launch<float>(x, w8, (const float*)ws, (const float*)bias,
                  (const float*)scale, (const float*)shift, (const float*)xs,
                  y, B, H, W, C, Co, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w8, (const float*)ws, (const float*)bias,
                          (const float*)scale, (const float*)shift,
                          (const float*)xs, y, B, H, W, C, Co, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
