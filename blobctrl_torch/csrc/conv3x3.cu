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
// Two kernels, chosen by dtype in the C entry point (never one as a
// fallback of the other):
//
// bf16: `conv3x3_kernel_tc`, on the tensor cores through the shared
// mainloop of csrc/gemm_bf16.cuh, with the TPU kernel's own halo window. A
// 128-thread block owns an 8 x 16 patch of output pixels (the GEMM's 128
// rows) x 128 output channels. Per 64-channel K slice the patch's 10 x 18
// input halo arrives once by cp.async, a slice ahead (or, masked 2-byte
// loads where C % 8 != 0, as for the 1029-channel BlobNet conv_in whose
// 2058-byte pixel rows break 16-byte alignment), goes through the GN+SiLU
// prologue once per element (SiLU as t/2 + t/2 tanh(t/2) on MUFU.TANH, as
// in csrc/winograd.cu) and lands in shared memory in bf16, with 0 for
// every tap outside the image. The 9 taps are then 9 shifted ldmatrix views
// of that one slab, each a K step against its tap's 64 x 128 weight slice,
// which streams through a 3-stage cp.async ring. So each input element's
// prologue runs once per 128-wide Co block (the SIMT kernel ran it 9 times
// per 64-wide block: 180 times at Co = 1280), and the halo's next slice
// loads under the current slice's 9 steps. Where the patches and Co blocks
// are fewer than the SMs (the 8 x 16 and 16 x 32 maps), the wrapper splits
// C across blocks (grid z, `ops/conv3x3.launch_config`): each writes fp32
// partial sums to a workspace that a second kernel adds in order with the
// bias. Ragged patches, Co blocks and C slices are masked. Left for later:
// wgmma with TMA and warp-specialised producers, a persistent schedule, and
// staging the output tile through shared memory for wider stores.
//
// fp32: `conv3x3_kernel`, the first version, SIMT, kept for the fp32
// checks: a register-tiled GEMM (64x64 output tile per 256-thread block,
// 4x4 per thread, K walked tap by tap in 16-channel slices through shared
// memory), accumulating in fp32 on the CUDA cores, the prologue recomputed
// for every tap. Any C (loads are scalar and masked), any Co, any H, W.
//
// The TPU version's VMEM contraction split (two bf16 partial sums) is
// deliberately not ported: here K is one fp32 accumulation (or one per
// split, summed in fp32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemm_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using CT = gemm::Tile<128>;               // 128 x 128 output blocks, 4 warps
constexpr int PATCH_H = 8, PATCH_W = 16;  // output pixels of a block: the GEMM's BM rows
constexpr int TC_BK = 64;                 // input channels per K slice
constexpr int TC_STAGES = 3;              // the weight ring
constexpr int HALO_W = PATCH_W + 2;
constexpr int HALO_ROWS = (PATCH_H + 2) * HALO_W;  // the input halo, 10 x 18 pixels
constexpr int A_LD = TC_BK + 8;                    // halo pixel stride in shared memory
constexpr int HALO_STAGES = 2;                     // halo slices in flight
constexpr int TC_SMEM = (int)sizeof(bf16) * (HALO_STAGES * HALO_ROWS * A_LD +
                                             TC_STAGES * TC_BK * CT::B_LD);
static_assert(PATCH_H * PATCH_W == gemm::BM, "a patch is the block's rows");
static_assert(TC_SMEM <= 232448, "shared memory of one block");

// bf16(silu(v * sc + sh)) on the first n of the 8 channels of a chunk, 0 on
// the others; SiLU as t/2 + t/2 * tanh(t/2) on MUFU.TANH.
__device__ __forceinline__ uint4 gn_silu8(uint4 v, const float (&sc)[8],
                                          const float (&sh)[8], int n) {
  float f[8];
  gemm::unpack8(v, f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = __fadd_rn(__fmul_rn(f[e], sc[e]), sh[e]);
    const float half = 0.5f * t;
    f[e] = e < n ? fmaf(half, tc::tanh_approx(half), half) : 0.f;
  }
  return gemm::pack8(f);
}

// The A operand of the mainloop: the patch's input halo, one K slice at a
// time. Thread t copies the 16-byte chunk t % 8 (8 channels) of halo
// pixels t / 8 + 16 i and runs the prologue on exactly those chunks, so it
// waits for no other thread's copies; the slice's scale and shift come from
// device memory.
template <bool PROLOGUE>
struct HaloLoader {
  static constexpr int TAPS = 9, ROWS = HALO_ROWS, A_STAGES = HALO_STAGES;
  static constexpr int CPR = TC_BK / 8;  // chunks a pixel
  static constexpr int NCH = (ROWS * CPR + CT::NT - 1) / CT::NT;
  static constexpr int STAGE_ELEMS = HALO_ROWS * A_LD;
  const bf16* xb;     // the block's image
  const float* scb;   // its prologue scale and shift (PROLOGUE)
  const float* shb;
  int H, W, C, ih0, iw0, c_end;
  bool x_vec;         // 16-byte copies: C % 8 == 0 and x aligned

  // tile row (pixel py * PATCH_W + px of the patch) at tap (kh, kw) = halo
  // pixel (py + kh, px + kw)
  __device__ __forceinline__ int a_row(int row, int tap) const {
    return (row / PATCH_W + tap / 3) * HALO_W + row % PATCH_W + tap % 3;
  }

  // chunk i of this thread: its halo pixel, and the offset of its first
  // channel c in the image when the pixel lies inside it and c < c_end
  __device__ __forceinline__ bool chunk(int i, int c, int& pix, size_t& off) const {
    pix = threadIdx.x / CPR + i * (CT::NT / CPR);
    const int ih = ih0 + pix / HALO_W, iw = iw0 + pix % HALO_W;
    const bool in = pix < ROWS && ih >= 0 && ih < H && iw >= 0 && iw < W && c < c_end;
    off = in ? ((size_t)ih * W + iw) * C + c : 0;
    return in;
  }

  __device__ __forceinline__ void load_ss(int c, float (&sc)[8], float (&sh)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[e] = c + e < c_end ? scb[c + e] : 0.f;
      sh[e] = c + e < c_end ? shb[c + e] : 0.f;
    }
  }

  // slice c0 into stage as: 16-byte copies (zeros outside the image and
  // past c_end), or, without them, 2-byte loads through the prologue
  __device__ __forceinline__ void issue(bf16* as, int c0) const {
    const int c = c0 + (threadIdx.x % CPR) * 8;
    bf16* dst = as + (threadIdx.x % CPR) * 8;
    if (x_vec) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        int pix;
        size_t off;
        const bool in = chunk(i, c, pix, off);
        if (pix < ROWS)
          tc::cp_async16(tc::smem_addr(dst + pix * A_LD), xb + off, in ? 16 : 0);
      }
      return;
    }
    float sc[8], sh[8];
    if (PROLOGUE) load_ss(c, sc, sh);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      int pix;
      size_t off;
      const bool in = chunk(i, c, pix, off);
      if (pix >= ROWS) continue;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        v = gemm::load8_masked(xb + off, c, c_end);
        if (PROLOGUE) v = gn_silu8(v, sc, sh, c_end - c);
      }
      *reinterpret_cast<uint4*>(dst + pix * A_LD) = v;
    }
  }

  // the prologue in place on the chunks this thread copied; the padding
  // stays 0
  __device__ __forceinline__ void prologue(bf16* as, int c0) const {
    if (!PROLOGUE || !x_vec) return;
    const int c = c0 + (threadIdx.x % CPR) * 8;
    bf16* dst = as + (threadIdx.x % CPR) * 8;
    float sc[8], sh[8];
    load_ss(c, sc, sh);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      int pix;
      size_t off;
      if (!chunk(i, c, pix, off)) continue;
      uint4* p = reinterpret_cast<uint4*>(dst + pix * A_LD);
      *p = gn_silu8(*p, sc, sh, 8);
    }
  }
};

// grid: (B * patches, Co blocks, splits); channels [c_begin, c_end) of C
// for split blockIdx.z. ws null: y = conv + bias in bf16; else the fp32
// conv of this split into ws[blockIdx.z] (no bias).
template <bool PROLOGUE>
__global__ void __launch_bounds__(CT::NT, 2) conv3x3_kernel_tc(
    const bf16* __restrict__ x, const bf16* __restrict__ wgt,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, bf16* __restrict__ y,
    float* __restrict__ ws, int B, int H, int W, int C, int Co, int c_per,
    int x_vec, int w_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [HALO_STAGES][HALO_ROWS][A_LD]
  bf16* Bs = As + HALO_STAGES * HALO_ROWS * A_LD; // [TC_STAGES][TC_BK][CT::B_LD]

  const int PH = (H + PATCH_H - 1) / PATCH_H, PW = (W + PATCH_W - 1) / PATCH_W;
  const int b = blockIdx.x / (PH * PW), prem = blockIdx.x % (PH * PW);
  const int h0 = (prem / PW) * PATCH_H, w0 = (prem % PW) * PATCH_W;
  const int n0 = blockIdx.y * CT::BN;
  const int c_begin = blockIdx.z * c_per;
  const int c_end = min(C, c_begin + c_per);

  HaloLoader<PROLOGUE> ld;
  ld.xb = x + (size_t)b * H * W * C;
  ld.scb = PROLOGUE ? scale + (size_t)b * C : nullptr;
  ld.shb = PROLOGUE ? shift + (size_t)b * C : nullptr;
  ld.H = H;
  ld.W = W;
  ld.C = C;
  ld.ih0 = h0 - 1;
  ld.iw0 = w0 - 1;
  ld.c_end = c_end;
  ld.x_vec = x_vec;

  float acc[gemm::MT][gemm::NJ][4];
#pragma unroll
  for (int mt = 0; mt < gemm::MT; ++mt)
#pragma unroll
    for (int j = 0; j < gemm::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  gemm::mainloop<CT, TC_BK, TC_STAGES>(ld, wgt, (size_t)C * Co, Co, n0, c_begin,
                                   c_end, w_vec, As, Bs, acc);

  float* wsz = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * B * H * W * Co;
  gemm::for_each_pair<CT>(acc, [&](int row, int col, float v0, float v1) {
    const int h = h0 + row / PATCH_W, w = w0 + row % PATCH_W, n = n0 + col;
    if (h < H && w < W && n < Co)
      gemm::store_pair((((size_t)b * H + h) * W + w) * Co + n, n, Co, v0, v1,
                       bias, nullptr, y, wsz);
  });
}

template <bool PROLOGUE>
int launch_tc(const void* x, const void* w, const float* bias,
              const float* scale, const float* shift, void* y, float* ws,
              int B, int H, int W, int C, int Co, int splits,
              cudaStream_t stream) {
  const long long patches = (long long)B * ((H + PATCH_H - 1) / PATCH_H) *
                            ((W + PATCH_W - 1) / PATCH_W);
  const int slices = (C + TC_BK - 1) / TC_BK;
  const int c_per = (slices + splits - 1) / splits * TC_BK;
  const int x_vec = C % 8 == 0 && ((uintptr_t)x & 15) == 0;
  const int w_vec = Co % 8 == 0 && ((uintptr_t)w & 15) == 0;
  static bool smem_set = false;
  cudaError_t err = gemm::allow_smem(conv3x3_kernel_tc<PROLOGUE>, TC_SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)patches, (unsigned)((Co + CT::BN - 1) / CT::BN),
                  (unsigned)splits);
  conv3x3_kernel_tc<PROLOGUE><<<grid, CT::NT, TC_SMEM, stream>>>(
      (const bf16*)x, (const bf16*)w, bias, scale, shift, (bf16*)y,
      splits > 1 ? ws : nullptr, B, H, W, C, Co, c_per, x_vec, w_vec);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)gemm::split_sum(ws, bias, nullptr, (bf16*)y,
                                (long long)B * H * W * Co, Co, splits, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel). scale/shift: (B, C) fp32, or both null for no prologue. bias:
// (Co,) fp32. splits (bf16 only; 1 for fp32): the number of blocks C is
// split across, with ws an fp32 (splits, B, H, W, Co) workspace when
// splits > 1. On a launch without error, *design (when not null) is set to
// the kernel that ran: 0 = SIMT, 1 = tensor cores. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int conv3x3_fwd(const void* x, const void* w, const void* bias,
                           const void* scale, const void* shift, void* y,
                           int B, int H, int W, int C, int Co, int dtype,
                           int splits, void* ws, void* stream, int* design) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (B < 1 || H < 1 || W < 1 || C < 1 || Co < 1 ||
      (scale == nullptr) != (shift == nullptr) || splits < 1 || splits > 65535 ||
      (splits > 1 && (dtype != 1 || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float>(x, w, (const float*)bias, (const float*)scale,
                  (const float*)shift, y, B, H, W, C, Co, s);
    rc = (int)cudaGetLastError();
  } else if (dtype == 1 && scale != nullptr) {
    rc = launch_tc<true>(x, w, (const float*)bias, (const float*)scale,
                         (const float*)shift, y, (float*)ws, B, H, W, C, Co, splits, s);
  } else if (dtype == 1) {
    rc = launch_tc<false>(x, w, (const float*)bias, nullptr, nullptr, y,
                          (float*)ws, B, H, W, C, Co, splits, s);
  }
  if (rc == 0 && design != nullptr) *design = dtype;
  return rc;
}
