// int8 3x3 stride-1 "same" convolution, NHWC x HWIO -> NHWC, with an
// optional fused GroupNorm+SiLU prologue and the activation quantize, for
// NVIDIA Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces: blobctrl_tpu/ops/conv3x3.py `_conv3x3_kernel_halo_i8`, the conv
// of the opt-in int8-everything mode, together with the quantize that the
// JAX package runs as an XLA fusion in front of it.
//
// What it computes, with xs = *xs_ptr the ONE activation scale of the call:
//   a(v)  = round_to_x_dtype(silu(v * scale[b,c] + shift[b,c]))  (prologue)
//           or v                                                  (none)
//   q(v)  = clip(rint(a(v) / xs), -127, 127)    true fp32 division, ties even
//   acc   = sum_{kh,kw,c} q(x[b,h+kh-1,w+kw-1,c]) * wq[kh,kw,c,n]  in int32,
//           taps outside the image contributing 0 (padding after the
//           prologue and the quantize)
//   y     = float(acc) * (xs * ws[n]) + bias[n]  in fp32, in that order
// The elementwise steps are the first SIMT kernel's: explicit round-to-
// nearest intrinsics, the accurate expf and a true division (never
// tanh.approx or ex2.approx), so nvcc's FMA contraction cannot change a
// rounding the plain PyTorch version (ops/conv3x3.py
// `conv3x3_int8_reference`) makes separately; acc is an exact int32 sum in
// any order (9 * 2560 * 127^2 < 2^31). So without a prologue the output is
// bit-equal to the plain version, and with one it differs only where expf
// does.
//
// What bounds it on the H100: 2*M*N*K integer operations (M = B*H*W,
// N = Co, K = 9*C) against x + w + y bytes, hundreds of operations per
// byte at the production shapes, so operations bound it; the card's rate
// for them is the int8 tensor-core peak.
//
// The design: two kernels, one launch each, for bf16 and fp32 x alike (the
// products are int8 in both).
//   1. `quantize_kernel`, as the TPU package's quantize in front of its
//      kernel: the prologue and the quantize once per element, into int8
//      rows of Cp = C rounded up to 16 bytes (zeros past C), so that every
//      pixel row takes 16-byte copies (C = 1029, BlobNet's conv_in, has
//      2058-byte bf16 rows). Done inside the conv's blocks instead, once per
//      element and 128-wide Co block, its true division, clamp, round and
//      pack took 2.5 times the products' instructions and made the conv
//      1.3-1.9x slower than the bf16 conv (K6) at the same shapes (PERF.md
//      section 6).
//   2. `conv3x3_int8_kernel_tc`, an implicit GEMM over the TPU kernel's
//      own halo window, built like the bf16 conv's mainloop
//      (csrc/gemm_bf16.cuh) on s8 operands. A 128-thread block owns an
//      8 x 16 patch of output pixels (the GEMM's 128 rows) x 128 output
//      channels, 4 warps of 64 x 64, int32 accumulators. Per 64-channel K
//      slice the patch's 10 x 18 int8 halo arrives once by cp.async
//      (zero-filled outside the image: the padding comes after the
//      quantize) into one of two stages, a slice ahead; the 9 taps are 9
//      shifted ldmatrix views of it, each two mma.sync m16n8k32 s8 steps
//      against its tap's 128 x 64 weight slice, which streams through a
//      4-stage cp.async ring. One barrier a step.
// The weights come K-major, (9, Co, Cp) int8 with C zero-padded to Cp
// (`kmajor_weights` in the wrapper, cached beside the HWIO kernel_q and
// outside the parameter tree): the s8 B fragment needs 4 consecutive
// channels of one output channel, which ldmatrix gives from rows along C
// without a transpose (ldmatrix.trans moves 16-bit elements and cannot
// transpose int8), and every row takes 16-byte cp.async. Where the patches
// and Co blocks are fewer than the SMs, the wrapper splits C across blocks
// (grid z, `ops/conv3x3.launch_config_int8`): each writes its int32 partial
// sums to a workspace that a third kernel adds in split order before the
// epilogue, so the output stays bit-equal and deterministic. Left for
// later: wgmma with TMA and warp-specialised producers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int PATCH_H = 8, PATCH_W = 16;      // output pixels of a block
constexpr int BM = PATCH_H * PATCH_W;         // the GEMM's rows
constexpr int BN = 128;                       // output channels of a block
constexpr int WM = 64, WN = 64;               // a warp's output tile
constexpr int MT = WM / 16, NJ = WN / 8;
constexpr int WARPS_N = BN / WN;
constexpr int NT = (BM / WM) * WARPS_N * 32;  // 128 threads
constexpr int BK = 64;                        // input channels per K slice
constexpr int STAGES = 4;                     // the weight ring
constexpr int TAPS = 9;
constexpr int HALO_W = PATCH_W + 2;
constexpr int HALO_ROWS = (PATCH_H + 2) * HALO_W;  // the input halo, 10 x 18 pixels
// int8 rows of BK + 16 bytes: an odd count of 16-byte units, so the 8 rows
// of an ldmatrix hit 8 different bank groups
constexpr int Q_LD = BK + 16;                 // a halo pixel
constexpr int B_LD = BK + 16;                 // a weight row (one output channel)
constexpr int Q_STAGES = 2;
constexpr int SMEM = Q_STAGES * HALO_ROWS * Q_LD + STAGES * BN * B_LD;
// two blocks an SM (233472 bytes, 1 KB of them reserved per block)
static_assert(2 * (SMEM + 1024) <= 233472, "shared memory of two blocks");
// a slice's halo goes to the stage its last reader left a slice ago
static_assert(STAGES >= 3 && STAGES - 1 < TAPS, "the rings");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// One activation, prologued and quantized, as the low byte of a word.
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

// q8[p, c] = q(x[p, c]) for c < C, 0 for C <= c < Cp: one thread a word of
// 4 channels, pixels p of B*H*W, HW of them an image.
template <typename T, bool PROLOGUE>
__global__ void quantize_kernel(const T* __restrict__ x,
                                const float* __restrict__ scale,
                                const float* __restrict__ shift,
                                const float* __restrict__ xs_ptr,
                                uint32_t* __restrict__ q8, long long pixels,
                                int HW, int C, int Cp) {
  const float xs = *xs_ptr;
  const int wpr = Cp / 4;  // words a pixel row
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < pixels * wpr; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / wpr;
    const int c0 = (int)(i % wpr) * 4;
    const T* xp = x + p * C;
    const size_t bc = (size_t)(p / HW) * C;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      if (c < C)
        word |= quantize<T, PROLOGUE>(xp[c], PROLOGUE ? scale[bc + c] : 0.f,
                                      PROLOGUE ? shift[bc + c] : 0.f, xs)
                << (8 * e);
    }
    q8[i] = word;
  }
}

// tile row (pixel py * PATCH_W + px of the patch) at tap (kh, kw) = halo
// pixel (py + kh, px + kw)
__device__ __forceinline__ int a_row(int row, int tap) {
  return (row / PATCH_W + tap / 3) * HALO_W + row % PATCH_W + tap % 3;
}

// Channels [c0, c0 + BK) of the patch's int8 halo into one stage: zeros
// outside the image and at c >= c_lim (Cp, or the end of this split).
__device__ __forceinline__ void load_halo(int8_t* qs, const int8_t* qb, int H, int W,
                                          int Cp, int ih0, int iw0, int c0, int c_lim) {
  constexpr int CPR = BK / 16;  // 16-byte chunks a pixel
  for (int e = threadIdx.x; e < HALO_ROWS * CPR; e += NT) {
    const int pix = e / CPR, cc = e % CPR;
    const int ih = ih0 + pix / HALO_W, iw = iw0 + pix % HALO_W;
    const int c = c0 + cc * 16;
    const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W && c < c_lim;
    tc::cp_async16(tc::smem_addr(qs + pix * Q_LD + cc * 16),
                   ok ? qb + ((size_t)ih * W + iw) * Cp + c : qb, ok ? 16 : 0);
  }
}

// BK channels [c0, c0 + BK) of output channels [n0, n0 + BN) of tap t of
// the K-major (9, Co, Cp) weights into one B stage, zeros past Cp and Co.
__device__ __forceinline__ void load_b(int8_t* bs, const int8_t* wt, int tap, int Co,
                                       int Cp, int n0, int c0) {
  constexpr int CPR = BK / 16;
  static_assert(BN * CPR % NT == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < BN * CPR / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CPR, cc = e % CPR;
    const int n = n0 + r, c = c0 + cc * 16;
    const bool ok = n < Co && c < Cp;
    tc::cp_async16(tc::smem_addr(bs + r * B_LD + cc * 16),
                   ok ? wt + ((size_t)tap * Co + n) * Cp + c : wt, ok ? 16 : 0);
  }
}

// y = float(acc) * (xs * ws[n]) + bias[n] in x's dtype, in the SIMT
// kernel's order of roundings
template <typename T>
__device__ __forceinline__ T epilogue(int acc, float xs, float wsn, float bn) {
  return from_f32<T>(__fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(xs, wsn)), bn));
}

// grid: (B * patches, Co blocks, splits); channels [c_begin, c_begin +
// c_per) of Cp for split blockIdx.z. q8: (B, H, W, Cp) int8. work null: y =
// the conv in x's dtype; else this split's int32 sums into work[blockIdx.z].
template <typename T>
__global__ void __launch_bounds__(NT, 2) conv3x3_int8_kernel_tc(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ wt,
    const float* __restrict__ ws, const float* __restrict__ bias,
    const float* __restrict__ xs_ptr, T* __restrict__ y, int* __restrict__ work,
    int B, int H, int W, int C, int Co, int c_per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_raw);  // [Q_STAGES][HALO_ROWS][Q_LD]
  int8_t* Bs = Qs + Q_STAGES * HALO_ROWS * Q_LD;      // [STAGES][BN][B_LD]

  const int PH = (H + PATCH_H - 1) / PATCH_H, PW = (W + PATCH_W - 1) / PATCH_W;
  const int b = blockIdx.x / (PH * PW), prem = blockIdx.x % (PH * PW);
  const int h0 = (prem / PW) * PATCH_H, w0 = (prem % PW) * PATCH_W;
  const int n0 = blockIdx.y * BN;
  const int Cp = (C + 15) / 16 * 16;
  const int c_begin = blockIdx.z * c_per;
  const int c_lim = min(Cp, c_begin + c_per);
  const int8_t* qb = q8 + (size_t)b * H * W * Cp;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const bool live = n0 + wn * WN < Co;  // warps past Co skip the products

  int acc[MT][NJ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  const int n_slices = c_lim > c_begin ? (c_lim - c_begin + BK - 1) / BK : 0;
  const int n_steps = n_slices * TAPS;
  // step (s, t) = slice s, tap t: one commit group a step, empty past the
  // end; a slice's halo copies go with its first tap's weights
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int s = step / TAPS, t = step - s * TAPS;
      if (t == 0)
        load_halo(Qs + (s % Q_STAGES) * HALO_ROWS * Q_LD, qb, H, W, Cp, h0 - 1, w0 - 1,
                  c_begin + s * BK, c_lim);
      load_b(Bs + (step % STAGES) * BN * B_LD, wt, t, Co, Cp, n0, c_begin + s * BK);
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) issue(st);

  // Step (s, t): wait for this thread's copies of the step; one barrier
  // (the step's weights and the slice's halo are visible to all, the stages
  // read a step ago are free); copy step + STAGES - 1; the products, 32
  // channels at a time.
  int s = 0, t = 0;
  for (int step = 0; step < n_steps; ++step) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(step + STAGES - 1);
    if (live) {
      const int8_t* qs = Qs + (s % Q_STAGES) * HALO_ROWS * Q_LD;
      const int8_t* bs = Bs + (step % STAGES) * BN * B_LD;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        uint32_t bf[NJ][2], af[MT][4];
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t r[4];  // channels j*8.. (b0, b1), then (j+1)*8.. (b0, b1)
          tc::ldmatrix_x4(r, tc::smem_addr(bs + (wn * WN + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * B_LD +
                                           kk * 32 + ((lane >> 3) & 1) * 16));
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::ldmatrix_x4(af[mt], tc::smem_addr(qs + a_row(wm * WM + mt * 16 + (lane & 15), t) * Q_LD +
                                                kk * 32 + (lane >> 4) * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NJ; ++j) tc::mma_s8(acc[mt][j], af[mt], bf[j][0], bf[j][1]);
      }
    }
    if (++t == TAPS) {
      t = 0;
      ++s;
    }
  }

  const float xs = *xs_ptr;
  const int g = lane >> 2, tq = (lane & 3) * 2;
  int* wz = work == nullptr ? nullptr : work + (size_t)blockIdx.z * B * H * W * Co;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wm * WM + mt * 16 + g + 8 * hh;
        const int h = h0 + row / PATCH_W, w = w0 + row % PATCH_W;
        const int n = n0 + wn * WN + j * 8 + tq;
        if (h >= H || w >= W || n >= Co) continue;
        const size_t o = (((size_t)b * H + h) * W + w) * Co + n;
        const int v0 = acc[mt][j][2 * hh], v1 = acc[mt][j][2 * hh + 1];
        const bool two = n + 1 < Co;
        if (wz != nullptr) {
          wz[o] = v0;
          if (two) wz[o + 1] = v1;
        } else {
          y[o] = epilogue<T>(v0, xs, ws[n], bias[n]);
          if (two) y[o + 1] = epilogue<T>(v1, xs, ws[n + 1], bias[n + 1]);
        }
      }
}

// y = the epilogue of the int32 sum over the splits of work (exact in any
// order), n outputs of Co columns each.
template <typename T>
__global__ void split_sum_kernel(const int* __restrict__ work,
                                 const float* __restrict__ ws,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ xs_ptr,
                                 T* __restrict__ y, long long n, int Co,
                                 int splits) {
  const float xs = *xs_ptr;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    int s = work[i];
    for (int z = 1; z < splits; ++z) s += work[z * n + i];
    const int c = (int)(i % Co);
    y[i] = epilogue<T>(s, xs, ws[c], bias[c]);
  }
}

// A grid-stride launch over n items: at most 16 blocks of 256 an SM.
inline unsigned stride_blocks(long long n) {
  const long long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
int launch(const void* x, const int8_t* wt, const float* ws, const float* bias,
           const float* scale, const float* shift, const float* xs, void* q8,
           void* y, int* work, int B, int H, int W, int C, int Co, int splits,
           cudaStream_t stream) {
  const int Cp = (C + 15) / 16 * 16;
  const long long pixels = (long long)B * H * W;
  const long long words = pixels * (Cp / 4);
  if (scale != nullptr)
    quantize_kernel<T, true><<<stride_blocks(words), 256, 0, stream>>>(
        (const T*)x, scale, shift, xs, (uint32_t*)q8, pixels, H * W, C, Cp);
  else
    quantize_kernel<T, false><<<stride_blocks(words), 256, 0, stream>>>(
        (const T*)x, nullptr, nullptr, xs, (uint32_t*)q8, pixels, H * W, C, Cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(conv3x3_int8_kernel_tc<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const long long patches = (long long)B * ((H + PATCH_H - 1) / PATCH_H) *
                            ((W + PATCH_W - 1) / PATCH_W);
  const int slices = (C + BK - 1) / BK;
  const int c_per = (slices + splits - 1) / splits * BK;
  const dim3 grid((unsigned)patches, (unsigned)((Co + BN - 1) / BN), (unsigned)splits);
  conv3x3_int8_kernel_tc<T><<<grid, NT, SMEM, stream>>>(
      (const int8_t*)q8, wt, ws, bias, xs, (T*)y, splits > 1 ? work : nullptr, B, H,
      W, C, Co, c_per);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = pixels * Co;
    split_sum_kernel<T><<<stride_blocks(n), 256, 0, stream>>>(work, ws, bias, xs,
                                                              (T*)y, n, Co, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) in dtype (0 = float32, 1 = bfloat16); wt: the K-major
// int8 weights (9, Co, Cp), Cp = C rounded up to 16, zeros past C; ws,
// bias: (Co,) fp32; scale/shift: (B, C) fp32, or both null for no
// prologue; xs: one fp32 on the device, the activation scale; q8: an int8
// (B, H, W, Cp) workspace for the quantized activations; wt and q8 16-byte
// aligned. splits: the number of blocks C is split across, with work an
// int32 (splits, B, H, W, Co) workspace when splits > 1. On a launch
// without error, *design (when not null) is set to 1: both dtypes run on
// the tensor cores. Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int conv3x3_int8_fwd(const void* x, const void* wt, const void* ws,
                                const void* bias, const void* scale,
                                const void* shift, const void* xs, void* q8,
                                void* y, int B, int H, int W, int C, int Co,
                                int dtype, int splits, void* work, void* stream,
                                int* design) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (B < 1 || H < 1 || W < 1 || C < 1 || Co < 1 ||
      (scale == nullptr) != (shift == nullptr) || splits < 1 || splits > 65535 ||
      (splits > 1 && work == nullptr) || q8 == nullptr ||
      (((uintptr_t)wt | (uintptr_t)q8) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* w8 = (const int8_t*)wt;
  int rc;
  if (dtype == 0)
    rc = launch<float>(x, w8, (const float*)ws, (const float*)bias,
                       (const float*)scale, (const float*)shift, (const float*)xs,
                       q8, y, (int*)work, B, H, W, C, Co, splits, s);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16>(x, w8, (const float*)ws, (const float*)bias,
                               (const float*)scale, (const float*)shift,
                               (const float*)xs, q8, y, (int*)work, B, H, W, C,
                               Co, splits, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc == 0 && design != nullptr) *design = 1;
  return rc;
}
