// Winograd F(2x2, 3x3) stride-1 "same" convolution, NHWC x (16, C, Co) ->
// NHWC, with an optional fused GroupNorm+SiLU prologue, for NVIDIA Hopper
// (sm_90a). Even H and W only.
//
// Replaces: blobctrl_tpu/ops/winograd.py `_winograd_kernel` (`:85`), the
// opt-in (`set_winograd`) alternative to the implicit-GEMM conv3x3.
//
// What it computes: each 2x2 output tile (tile row p, column q) reads the
// 4x4 input tile d at padded rows 2p..2p+3 and columns 2q..2q+3, where
// d = round_to_x_dtype(silu(x * scale[b,c] + shift[b,c])) when a prologue is
// given (x otherwise), with zero padding applied AFTER the prologue (taps
// outside the image are 0, as in csrc/conv3x3.cu; the JAX package runs the
// prologue in XLA before its kernel and pads after it, the same math).
//   V = B^T d B in fp32 (rows, then columns), rounded to x's dtype;
//   M[i][j] = sum_c V[i][j][c] * U[i][j][c][n] in fp32, U = G g G^T in x's
//             dtype (transformed once outside, ops/winograd.py);
//   Y = A^T M A in fp32, + bias[n], cast to x's dtype;
// with B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] and
// A^T = [[1,1,1,0],[0,1,-1,-1]], the +/- sums in the TPU kernel's order.
//
// What bounds it on the H100: 16 MACs per 2x2 tile per (C, Co) pair, i.e.
// 4*C*Co MACs per output pixel (the direct conv's 9*C*Co, cut 2.25x),
// against x + U + y bytes: at the main path's shapes (C, Co >= 128) that
// is hundreds of operations per byte, so it is bound by arithmetic, whose
// rate on this card is the bf16 tensor-core peak.
//
// What this first version does about it: the transformed tiles V and M
// stay in shared memory and registers, never in device memory, so the
// traffic is the direct conv's. One 256-thread block owns 16 output tiles
// (64 pixels) x 32 output channels. For each 16-channel slice of C, each
// thread loads one (tile, channel) 4x4 patch (applying the prologue on
// load), transforms it and stores its 16 V values; the 16 products then
// run as 16 small SIMT GEMMs, one per Winograd position, 16 threads each,
// every thread owning 4 tiles x 8 channels in fp32 registers. At the end
// M goes through shared memory so that each thread can apply A^T M A to
// whole tiles. Any C (the 1029-channel BlobNet conv_in is masked, as are
// the ragged tile and Co tails). The TPU kernel's contraction split
// (two halves summed in x's dtype when its VMEM estimate passes 14 MiB) is
// deliberately not ported: K is one fp32 accumulation. Neighbouring tiles
// overlap by two rows and columns, so each input is loaded and its
// prologue computed four times; tensor-core tiles for the 16 products and
// a shared input halo are the known next steps for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BT = 16;    // output tiles (2x2 pixels each) per block
constexpr int BN = 32;    // output channels per block
constexpr int BK = 16;    // input channels per K slice
constexpr int NT = 256;   // threads: 16 Winograd positions x 16
constexpr int VLD = BT + 1;  // V row stride in shared memory (odd: fewer bank conflicts)
// shared floats: V [16][BK][VLD] + U [16][BK][BN]; M [16][BT][BN] reuses them
constexpr int SMEM_FLOATS = 16 * BK * VLD + 16 * BK * BN;
static_assert(16 * BT * BN <= SMEM_FLOATS, "M must fit in the V + U space");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, bool PROLOGUE>
__global__ void __launch_bounds__(NT) winograd_kernel(
    const T* __restrict__ x, const T* __restrict__ u,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ y,
    int B, int H, int W, int C, int Co) {
  extern __shared__ float smem[];
  float* Vs = smem;                    // [16][BK][VLD]
  float* Us = smem + 16 * BK * VLD;    // [16][BK][BN]
  float* Ms = smem;                    // [16][BT][BN], after the K loop

  const int tid = threadIdx.x;
  const int TH = H / 2, TW = W / 2;
  const long long n_tiles = (long long)B * TH * TW;
  const long long t0 = (long long)blockIdx.x * BT;
  const int n0 = blockIdx.y * BN;

  // transform role: one (tile, channel) pair per thread, channel fastest
  const int tk = tid % BK;
  const int tt = tid / BK;
  const long long tile = t0 + tt;
  const bool t_ok = tile < n_tiles;
  int tb = 0, th = 0, tw = 0;
  if (t_ok) {
    tb = (int)(tile / ((long long)TH * TW));
    const int rem = (int)(tile % ((long long)TH * TW));
    th = rem / TW;
    tw = rem % TW;
  }
  // GEMM role: Winograd position gp, tiles gt*4 + i, channels gc*8 + j
  const int gp = tid / 16;
  const int gt = (tid % 16) / 4;
  const int gc = tid % 4;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    // V = B^T d B of this thread's (tile, channel), rounded to x's dtype
    {
      const int c = c0 + tk;
      float d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ih = 2 * th - 1 + r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int iw = 2 * tw - 1 + s;
          float v = 0.f;
          if (t_ok && c < C && ih >= 0 && ih < H && iw >= 0 && iw < W) {
            v = to_f32(x[(((long long)tb * H + ih) * W + iw) * C + c]);
            if (PROLOGUE) {
              const long long bc = (long long)tb * C + c;
              v = __fadd_rn(__fmul_rn(v, scale[bc]), shift[bc]);
              v = v / (1.f + expf(-v));  // silu as PyTorch computes it
              v = round_to<T>(v);        // the activation in x's dtype
            }
          }
          d[r][s] = v;
        }
      }
      float t[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        t[0][s] = d[0][s] - d[2][s];
        t[1][s] = d[1][s] + d[2][s];
        t[2][s] = d[2][s] - d[1][s];
        t[3][s] = d[1][s] - d[3][s];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* vrow = Vs + (4 * i) * BK * VLD + tk * VLD + tt;
        vrow[0 * BK * VLD] = round_to<T>(t[i][0] - t[i][2]);
        vrow[1 * BK * VLD] = round_to<T>(t[i][1] + t[i][2]);
        vrow[2 * BK * VLD] = round_to<T>(t[i][2] - t[i][1]);
        vrow[3 * BK * VLD] = round_to<T>(t[i][1] - t[i][3]);
      }
    }
    // U slice: [16][BK][BN] from u (16, C, Co)
    for (int e = tid; e < 16 * BK * BN; e += NT) {
      const int n = e % BN;
      const int k = (e / BN) % BK;
      const int p = e / (BN * BK);
      const int c = c0 + k;
      float v = 0.f;
      if (c < C && n0 + n < Co) v = to_f32(u[((long long)p * C + c) * Co + n0 + n]);
      Us[e] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float* vk = Vs + (gp * BK + k) * VLD + gt * 4;
      const float a[4] = {vk[0], vk[1], vk[2], vk[3]};
      const float4* uk = reinterpret_cast<const float4*>(Us + (gp * BK + k) * BN + gc * 8);
      const float4 b0 = uk[0], b1 = uk[1];
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // M to shared memory, then Y = A^T M A + bias per (tile, channel)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Ms[(gp * BT + gt * 4 + i) * BN + gc * 8 + j] = acc[i][j];
  __syncthreads();

  for (int e = tid; e < BT * BN; e += NT) {
    const int n = e % BN;
    const int ot = e / BN;
    const long long otile = t0 + ot;
    if (otile >= n_tiles || n0 + n >= Co) continue;
    float m[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) m[p] = Ms[(p * BT + ot) * BN + n];
    float p0[4], p1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p0[j] = (m[0 + j] + m[4 + j]) + m[8 + j];
      p1[j] = (m[4 + j] - m[8 + j]) - m[12 + j];
    }
    const float bn = bias[n0 + n];
    const int ob = (int)(otile / ((long long)TH * TW));
    const int orem = (int)(otile % ((long long)TH * TW));
    const int oh = 2 * (orem / TW), ow = 2 * (orem % TW);
    T* yp = y + (((long long)ob * H + oh) * W + ow) * Co + n0 + n;
    yp[0] = from_f32<T>(((p0[0] + p0[1]) + p0[2]) + bn);
    yp[Co] = from_f32<T>(((p0[1] - p0[2]) - p0[3]) + bn);
    yp[(long long)W * Co] = from_f32<T>(((p1[0] + p1[1]) + p1[2]) + bn);
    yp[(long long)W * Co + Co] = from_f32<T>(((p1[1] - p1[2]) - p1[3]) + bn);
  }
}

template <typename T>
int launch(const void* x, const void* u, const float* bias, const float* scale,
           const float* shift, void* y, int B, int H, int W, int C, int Co,
           cudaStream_t stream) {
  const long long n_tiles = (long long)B * (H / 2) * (W / 2);
  const dim3 grid((unsigned)((n_tiles + BT - 1) / BT), (unsigned)((Co + BN - 1) / BN));
  const int smem = (int)(SMEM_FLOATS * sizeof(float));
  if (scale != nullptr) {
    cudaError_t err = cudaFuncSetAttribute(
        winograd_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    winograd_kernel<T, true><<<grid, NT, smem, stream>>>(
        (const T*)x, (const T*)u, bias, scale, shift, (T*)y, B, H, W, C, Co);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        winograd_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    winograd_kernel<T, false><<<grid, NT, smem, stream>>>(
        (const T*)x, (const T*)u, bias, scale, shift, (T*)y, B, H, W, C, Co);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) NHWC, H and W even; u: (16, C, Co) Winograd-domain
// weights; y: (B, H, W, Co); all contiguous, of one dtype (0 = float32,
// 1 = bfloat16). bias: (Co,) fp32. scale/shift: (B, C) fp32, or both null
// for no prologue. Returns cudaGetLastError() after the launch.
extern "C" int winograd_fwd(const void* x, const void* u, const void* bias,
                            const void* scale, const void* shift, void* y,
                            int B, int H, int W, int C, int Co, int dtype,
                            void* stream) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C < 1 || Co < 1 ||
      (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, u, (const float*)bias, (const float*)scale,
                         (const float*)shift, y, B, H, W, C, Co, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, u, (const float*)bias, (const float*)scale,
                                 (const float*)shift, y, B, H, W, C, Co, s);
  return (int)cudaErrorInvalidValue;
}
