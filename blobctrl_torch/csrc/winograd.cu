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
// rate on this card is the bf16 tensor-core peak. Beside the products, the
// input transform (and the GN+SiLU prologue) costs a few dozen CUDA-core
// instructions per (tile, channel) for every Co block, which at a 64-wide
// Co block is of the same order as the tile's share of the mma work.
//
// Two kernels, chosen by dtype in the C entry point (never one as a
// fallback of the other). Both keep V and M in shared memory and
// registers, never in device memory, so the traffic is the direct conv's.
//
// bf16: `winograd_kernel_tc`, the 16 products on the tensor cores. A
// 256-thread block owns a 4 x 8 patch of output tiles (32 tiles, an 8 x 16
// pixel patch) x 64 output channels. Per 32-channel K slice its 10 x 18
// input halo arrives in shared memory once by cp.async (16-byte copies,
// zeros outside the image and past C), the GN+SiLU prologue is applied once
// per element in place (prologue -> bf16 rounding; padding stays zero, as
// before; SiLU as t/2 + t/2 tanh(t/2) on MUFU.TANH), and each (tile, channel pair) is transformed once, V = B^T d B in
// fp32, rounded to bf16 into a [16][tile][channel] array: the A operand.
// The U slice ([16][channel][64], the B operand) streams through a
// two-stage shared-memory ring in 16-byte asynchronous copies beside the
// halo, so slice s + 1 arrives under slice s's math: a slice costs two
// barriers, one after its transform and one after its products, which share
// their interval with the next slice's copies and prologue (each thread
// applies the prologue to the chunks it copied itself). Warp w runs the
// products of positions 2w and 2w + 1 on mma.sync m16n8k16 (A by ldmatrix,
// B by ldmatrix.trans), its 2 x 32 x 64 M accumulators in fp32 registers
// (128 a thread). M goes through shared memory for Y = A^T M A + bias in
// fp32, in the order of the +/- sums below. Where the patches and Co blocks
// are fewer than the SMs (the 8 x 16 maps at C = 1280-2560, the 4-channel
// UNet conv_out), the wrapper splits C across blocks (grid z): each writes
// its fp32 A^T M A to a workspace, and a second kernel sums the splits in
// order, adds the bias and rounds. C % 8 != 0 (the 1029-channel BlobNet
// conv_in) or an unaligned x takes masked 2-byte halo loads, Co % 8 != 0
// (3, 4) 2-byte U loads; ragged patches and Co blocks are masked. Left for
// later: wgmma with TMA, warp specialisation (transform warps feeding mma
// warps), persistent blocks, and a wider Co block to spread the transform.
//
// fp32: `winograd_kernel`, the first version, SIMT, kept for the fp32
// checks. One 256-thread block owns 16 output tiles
// (64 pixels) x 32 output channels. For each 16-channel slice of C, each
// thread loads one (tile, channel) 4x4 patch (applying the prologue on
// load), transforms it and stores its 16 V values; the 16 products then
// run as 16 small SIMT GEMMs, one per Winograd position, 16 threads each,
// every thread owning 4 tiles x 8 channels in fp32 registers. At the end
// M goes through shared memory so that each thread can apply A^T M A to
// whole tiles. Any C (the 1029-channel BlobNet conv_in is masked, as are
// the ragged tile and Co tails). The TPU kernel's contraction split
// (two halves summed in x's dtype when its VMEM estimate passes 14 MiB) is
// deliberately not ported: K is accumulated in fp32 (one accumulation, or
// one per split summed in fp32). Neighbouring tiles overlap by two rows and
// columns, so the SIMT kernel loads each input and computes its prologue
// four times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TP_H = 4, TP_W = 8;  // output tiles of a block: a 4 x 8 patch
constexpr int TN = 64;             // output channels of a block
constexpr int TM = TP_H * TP_W;    // 32 tiles, the M of the 16 products
constexpr int MT = TM / 16, NJ = TN / 8;  // m16 and n8 tiles of a position
constexpr int TK = 32;             // input channels per K slice
constexpr int TNT = 256;           // threads: 8 warps, 2 Winograd positions each
constexpr int HH = 2 * TP_H + 2, HW = 2 * TP_W + 2;  // the input halo, 10 x 18
constexpr int H_LD = TK + 16;  // halo pixel stride: tiles a pair of lanes apart hit other banks
constexpr int V_LD = TK + 8;   // V rows [16][TM][V_LD]: odd 16-byte units for ldmatrix
constexpr int U_LD = TN + 8;   // U rows [16][TK][U_LD]: the same
constexpr int M_LD = TN + 4;   // M staging [16][TM][M_LD], fp32
constexpr int HALO_ELEMS = HH * HW * H_LD;
constexpr int U_ELEMS = 16 * TK * U_LD;
constexpr int V_ELEMS = 16 * TM * V_LD;
constexpr int SS_FLOATS = 2 * TK;  // a slice's prologue scale, then shift
// two U stages, two halo stages, V, two scale/shift stages; M reuses the U
// ring after the K loop
constexpr int TC_SMEM = (int)sizeof(bf16) * (2 * U_ELEMS + 2 * HALO_ELEMS + V_ELEMS) +
                        (int)sizeof(float) * 2 * SS_FLOATS;
static_assert(TC_SMEM <= 232448, "shared memory of one block");
static_assert(16 * TM * M_LD * sizeof(float) <= 2 * U_ELEMS * sizeof(bf16),
              "M must fit in the U ring");
static_assert(TNT / NJ == TK, "one U row chunk per thread and position");

// The halo slice of K slice c0 (TK channels of HH x HW input pixels, zeros
// outside the image and past c_end) into one ring stage. Thread t copies
// the 16-byte chunk t % 4 of pixels t / 4, t / 4 + 64, ...: the prologue
// pass takes the same chunks.
__device__ __forceinline__ void load_halo(bf16* hs, const bf16* x,
                                          const bf16* xb, int H, int W, int C,
                                          int ih0, int iw0, int c0, int c_end,
                                          bool x_vec) {
  const int tid = threadIdx.x;
  if (x_vec) {  // C % 8 == 0: 16-byte asynchronous copies, 8 channels each
    constexpr int CH = TK / 8;
    const int c = c0 + (tid % CH) * 8;
    for (int pix = tid / CH; pix < HH * HW; pix += TNT / CH) {
      const int ih = ih0 + pix / HW, iw = iw0 + pix % HW;
      const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W && c < c_end;
      tc::cp_async16(tc::smem_addr(hs + pix * H_LD + (tid % CH) * 8),
                     ok ? xb + ((size_t)ih * W + iw) * C + c : x, ok ? 16 : 0);
    }
  } else {  // masked 2-byte loads
    for (int e = tid; e < HH * HW * TK; e += TNT) {
      const int kc = e % TK, pix = e / TK;
      const int ih = ih0 + pix / HW, iw = iw0 + pix % HW, c = c0 + kc;
      const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W && c < c_end;
      hs[pix * H_LD + kc] = ok ? xb[((size_t)ih * W + iw) * C + c] : __float2bfloat16(0.f);
    }
  }
}

// The U slice of K slice c0 (16 x TK x TN, zeros past c_end and Co) into
// one ring stage.
__device__ __forceinline__ void load_u(bf16* us, const bf16* u, int C, int Co,
                                       int n0, int c0, int c_end, bool u_vec) {
  const int tid = threadIdx.x;
  if (u_vec) {  // Co % 8 == 0: channel tid / NJ, columns (tid % NJ) * 8, all 16 positions
    const int k = tid / NJ, n = n0 + (tid % NJ) * 8;
    const bool ok = c0 + k < c_end && n < Co;
    const bf16* src = ok ? u + (size_t)(c0 + k) * Co + n : u;
    const size_t p_stride = ok ? (size_t)C * Co : 0;
    const uint32_t dst = tc::smem_addr(us + k * U_LD + (tid % NJ) * 8);
#pragma unroll
    for (int p = 0; p < 16; ++p)
      tc::cp_async16(dst + p * TK * U_LD * (int)sizeof(bf16), src + p * p_stride,
                     ok ? 16 : 0);
  } else {  // 2-byte loads of the columns below Co; the others stay zero
    const int nn = min(TN, Co - n0);
    for (int e = tid; e < 16 * TK * nn; e += TNT) {
      const int j = e % nn, row = e / nn;
      const int c = c0 + row % TK;
      us[row * U_LD + j] = c < c_end ? u[((size_t)(row / TK) * C + c) * Co + n0 + j]
                                     : __float2bfloat16(0.f);
    }
  }
}

// The prologue's scale and shift of K slice c0 (zeros past c_end).
__device__ __forceinline__ void load_scale_shift(float* ss, const float* scb,
                                                 const float* shb, int c0,
                                                 int c_end, bool ss_vec) {
  const int tid = threadIdx.x;
  if (ss_vec) {  // 16 threads: 4 channels of scale or shift each
    if (tid < SS_FLOATS / 4) {
      const int c = c0 + 4 * (tid % (TK / 4));
      const float* src = tid < TK / 4 ? scb : shb;
      tc::cp_async16(tc::smem_addr(ss + 4 * tid), c < c_end ? src + c : src,
                     c < c_end ? 16 : 0);
    }
  } else {
    for (int e = tid; e < SS_FLOATS; e += TNT) {
      const int c = c0 + e % TK;
      ss[e] = c < c_end ? (e < TK ? scb : shb)[c] : 0.f;
    }
  }
}

// grid: (B * patches, Co blocks, splits); K slices [c_begin, c_end) of C for
// split blockIdx.z. ws null: y = A^T M A + bias in bf16; else the fp32
// A^T M A of this split into ws[blockIdx.z] (no bias).
template <bool PROLOGUE>
__global__ void __launch_bounds__(TNT) winograd_kernel_tc(
    const bf16* __restrict__ x, const bf16* __restrict__ u,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, bf16* __restrict__ y,
    float* __restrict__ ws, int B, int H, int W, int C, int Co, int c_per,
    int x_vec, int u_vec, int ss_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Us = reinterpret_cast<bf16*>(smem_raw);  // [2][16][TK][U_LD]
  bf16* Hs = Us + 2 * U_ELEMS;                    // [2][HH * HW][H_LD]
  bf16* Vs = Hs + 2 * HALO_ELEMS;                 // [16][TM][V_LD]
  float* SS = reinterpret_cast<float*>(Vs + V_ELEMS);  // [2][SS_FLOATS]
  float* Ms = reinterpret_cast<float*>(smem_raw); // [16][TM][M_LD], after the loop

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int TH = H / 2, TW = W / 2;
  const int PH = (TH + TP_H - 1) / TP_H, PW = (TW + TP_W - 1) / TP_W;
  const int b = blockIdx.x / (PH * PW);
  const int prem = blockIdx.x % (PH * PW);
  const int ty0 = (prem / PW) * TP_H, tx0 = (prem % PW) * TP_W;
  const int ih0 = 2 * ty0 - 1, iw0 = 2 * tx0 - 1;  // the halo's first input pixel
  const int n0 = blockIdx.y * TN;
  const int c_begin = blockIdx.z * c_per;
  const int c_end = min(C, c_begin + c_per);
  const int n_slices = c_end > c_begin ? (c_end - c_begin + TK - 1) / TK : 0;
  const bf16* xb = x + (size_t)b * H * W * C;
  const float* scb = PROLOGUE ? scale + (size_t)b * C : nullptr;
  const float* shb = PROLOGUE ? shift + (size_t)b * C : nullptr;

  if (!u_vec) {  // the U columns past Co are zeros, once for both stages
    for (int e = tid; e < 2 * U_ELEMS; e += TNT) Us[e] = __float2bfloat16(0.f);
    __syncthreads();
  }

  float acc[2][MT][NJ][4];  // [position 2w + pp][m16 tile][n8 tile]
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pp][mt][j][e] = 0.f;

  // d = bf16(silu(x * scale + shift)) inside the image, once per element,
  // in place; each thread takes the 16-byte chunks it copied (load_halo)
  auto prologue = [&](bf16* hs, const float* ss_stage, int c0) {
    constexpr int CH = TK / 8;  // 8 channels (16 bytes) per thread and pixel
    constexpr int NPIX = (HH * HW + TNT / CH - 1) / (TNT / CH);  // pixels a thread
    const float* ss = ss_stage + (tid % CH) * 8;
    const int n_ok = c_end - (c0 + (tid % CH) * 8);  // channels below c_end
    uint4 raw[NPIX];
    bool ok[NPIX];
#pragma unroll
    for (int q = 0; q < NPIX; ++q) {  // all loads first, then all the math
      const int pix = tid / CH + q * (TNT / CH);
      const int ih = ih0 + pix / HW, iw = iw0 + pix % HW;
      ok[q] = pix < HH * HW && ih >= 0 && ih < H && iw >= 0 && iw < W && n_ok > 0;
      if (ok[q]) raw[q] = *reinterpret_cast<const uint4*>(hs + pix * H_LD + (tid % CH) * 8);
    }
#pragma unroll
    for (int q = 0; q < NPIX; ++q) {
      if (!ok[q]) continue;  // padding stays 0
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw[q]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[i]));
        float r[2] = {f.x, f.y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * i + h >= n_ok) continue;
          const float t = __fadd_rn(__fmul_rn(r[h], ss[2 * i + h]), ss[TK + 2 * i + h]);
          const float half = 0.5f * t;  // silu(t) = t/2 + t/2 * tanh(t/2)
          r[h] = fmaf(half, tc::tanh_approx(half), half);
        }
        w[i] = tc::pack_bf16(r[0], r[1]);
      }
      *reinterpret_cast<uint4*>(hs + (tid / CH + q * (TNT / CH)) * H_LD + (tid % CH) * 8) =
          raw[q];
    }
  };

  // Per slice s, two barriers: [transform s; wait for U of s] | [copy
  // s + 1; products of s; wait for the halo of s + 1; its prologue] |. The
  // products and the next slice's copies and prologue share one barrier
  // interval, so tensor cores, copies and CUDA cores overlap across warps;
  // U, copied last, has until the end of the next transform to land. The
  // scale and shift run one slice further ahead, so a barrier always
  // separates their copy from their use.
  const int kp = tid % (TK / 2);  // this thread's channel pair in the transform
  if (n_slices > 0) {
    load_halo(Hs, x, xb, H, W, C, ih0, iw0, c_begin, c_end, x_vec);
    if (PROLOGUE) {
      load_scale_shift(SS, scb, shb, c_begin, c_end, ss_vec);
      if (n_slices > 1)
        load_scale_shift(SS + SS_FLOATS, scb, shb, c_begin + TK, c_end, ss_vec);
    }
    tc::cp_async_commit();
    load_u(Us, u, C, Co, n0, c_begin, c_end, u_vec);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    if (PROLOGUE) {
      prologue(Hs, SS, c_begin);
      __syncthreads();
    }
  }
  for (int s = 0; s < n_slices; ++s) {
    const int st = s & 1;
    const int c0 = c_begin + s * TK;
    const bf16* hs = Hs + st * HALO_ELEMS;
    const bf16* us = Us + st * U_ELEMS;

    // V = B^T d B per (tile, channel pair), rows then columns, in fp32
    for (int tile = tid / (TK / 2); tile < TM; tile += TNT / (TK / 2)) {
      const int ty = tile / TP_W, tx = tile % TP_W;
      float d[2][4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              hs + ((2 * ty + r) * HW + 2 * tx + q) * H_LD + 2 * kp));
          d[0][r][q] = dv.x;
          d[1][r][q] = dv.y;
        }
      float vv[2][16];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        float t[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          t[0][q] = d[ch][0][q] - d[ch][2][q];
          t[1][q] = d[ch][1][q] + d[ch][2][q];
          t[2][q] = d[ch][2][q] - d[ch][1][q];
          t[3][q] = d[ch][1][q] - d[ch][3][q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vv[ch][4 * i + 0] = t[i][0] - t[i][2];
          vv[ch][4 * i + 1] = t[i][1] + t[i][2];
          vv[ch][4 * i + 2] = t[i][2] - t[i][1];
          vv[ch][4 * i + 3] = t[i][1] - t[i][3];
        }
      }
#pragma unroll
      for (int p = 0; p < 16; ++p)
        *reinterpret_cast<uint32_t*>(Vs + (p * TM + tile) * V_LD + 2 * kp) =
            tc::pack_bf16(vv[0][p], vv[1][p]);
    }
    tc::cp_async_wait<0>();  // U of this slice
    __syncthreads();         // V and U are ready; the other stage is free
    if (s + 1 < n_slices) {
      load_halo(Hs + (st ^ 1) * HALO_ELEMS, x, xb, H, W, C, ih0, iw0, c0 + TK, c_end,
                x_vec);
      if (PROLOGUE && s + 2 < n_slices)
        load_scale_shift(SS + st * SS_FLOATS, scb, shb, c0 + 2 * TK, c_end, ss_vec);
      tc::cp_async_commit();
      load_u(Us + (st ^ 1) * U_ELEMS, u, C, Co, n0, c0 + TK, c_end, u_vec);
      tc::cp_async_commit();
    }

    // M_p += V_p U_p for this warp's positions p = 2w, 2w + 1
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int p = warp * 2 + pp;
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::ldmatrix_x4(a[mt], tc::smem_addr(Vs + (p * TM + mt * 16 + (lane & 15)) * V_LD +
                                               kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {  // past Co: zero columns, not stored
          uint32_t bq[4];
          tc::ldmatrix_x4_trans(
              bq, tc::smem_addr(us + (p * TK + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * U_LD +
                                j * 8 + (lane >> 4) * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma_bf16(acc[pp][mt][j], a[mt], bq[0], bq[1]);
            tc::mma_bf16(acc[pp][mt][j + 1], a[mt], bq[2], bq[3]);
          }
        }
      }
    }
    if (s + 1 < n_slices) {
      tc::cp_async_wait<1>();  // the halo of the next slice
      if (PROLOGUE) {
        if (!x_vec) __syncthreads();  // 2-byte halo copies: other threads' stores
        prologue(Hs + (st ^ 1) * HALO_ELEMS, SS + (st ^ 1) * SS_FLOATS, c0 + TK);
      }
    }
    __syncthreads();  // the next halo is ready; V and this stage are free
  }


  // M to shared memory, then Y = A^T M A per (tile, channel)
  const int g = lane >> 2, cc = (lane & 3) * 2;
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float* m = Ms + ((warp * 2 + pp) * TM + mt * 16 + g) * M_LD + j * 8 + cc;
        m[0] = acc[pp][mt][j][0];
        m[1] = acc[pp][mt][j][1];
        m[8 * M_LD] = acc[pp][mt][j][2];
        m[8 * M_LD + 1] = acc[pp][mt][j][3];
      }
  __syncthreads();

  for (int e = tid; e < TM * TN; e += TNT) {
    const int n = e % TN, tile = e / TN;
    const int ty = ty0 + tile / TP_W, tx = tx0 + tile % TP_W;
    if (ty >= TH || tx >= TW || n0 + n >= Co) continue;
    float m[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) m[p] = Ms[(p * TM + tile) * M_LD + n];
    float p0[4], p1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p0[j] = (m[0 + j] + m[4 + j]) + m[8 + j];
      p1[j] = (m[4 + j] - m[8 + j]) - m[12 + j];
    }
    const float y00 = (p0[0] + p0[1]) + p0[2], y01 = (p0[1] - p0[2]) - p0[3];
    const float y10 = (p1[0] + p1[1]) + p1[2], y11 = (p1[1] - p1[2]) - p1[3];
    const size_t o = (((size_t)b * H + 2 * ty) * W + 2 * tx) * Co + n0 + n;
    const size_t dw = Co, dh = (size_t)W * Co;
    if (ws == nullptr) {
      const float bn = bias[n0 + n];
      y[o] = __float2bfloat16(y00 + bn);
      y[o + dw] = __float2bfloat16(y01 + bn);
      y[o + dh] = __float2bfloat16(y10 + bn);
      y[o + dh + dw] = __float2bfloat16(y11 + bn);
    } else {
      float* w = ws + (size_t)blockIdx.z * B * H * W * Co;
      w[o] = y00;
      w[o + dw] = y01;
      w[o + dh] = y10;
      w[o + dh + dw] = y11;
    }
  }
}

// y = bf16(sum over the splits of ws, in order, + bias)
__global__ void split_sum_kernel(const float* __restrict__ ws,
                                 const float* __restrict__ bias,
                                 bf16* __restrict__ y, long long n, int Co,
                                 int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * n + i];
    y[i] = __float2bfloat16(s + bias[i % Co]);
  }
}

template <bool PROLOGUE>
int launch_tc(const void* x, const void* u, const float* bias,
              const float* scale, const float* shift, void* y, float* ws,
              int B, int H, int W, int C, int Co, int splits,
              cudaStream_t stream) {
  const long long patches = (long long)B * ((H / 2 + TP_H - 1) / TP_H) *
                            ((W / 2 + TP_W - 1) / TP_W);
  const int slices = (C + TK - 1) / TK;
  const int c_per = (slices + splits - 1) / splits * TK;
  const int x_vec = C % 8 == 0 && ((uintptr_t)x & 15) == 0;
  const int u_vec = Co % 8 == 0 && ((uintptr_t)u & 15) == 0;
  const int ss_vec = PROLOGUE && C % 4 == 0 && (((uintptr_t)scale | (uintptr_t)shift) & 15) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      winograd_kernel_tc<PROLOGUE>, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)patches, (unsigned)((Co + TN - 1) / TN), (unsigned)splits);
  winograd_kernel_tc<PROLOGUE><<<grid, TNT, TC_SMEM, stream>>>(
      (const bf16*)x, (const bf16*)u, bias, scale, shift, (bf16*)y,
      splits > 1 ? ws : nullptr, B, H, W, C, Co, c_per, x_vec, u_vec, ss_vec);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)B * H * W * Co;
    const long long blocks = (n + 255) / 256;
    split_sum_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(
        ws, bias, (bf16*)y, n, Co, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) NHWC, H and W even; u: (16, C, Co) Winograd-domain
// weights; y: (B, H, W, Co); all contiguous, of one dtype (0 = float32, the
// SIMT kernel; 1 = bfloat16, the tensor-core kernel). bias: (Co,) fp32.
// scale/shift: (B, C) fp32, or both null for no prologue. splits (bf16
// only; 1 for fp32): the number of blocks C is split across, with ws an
// fp32 (splits, B, H, W, Co) workspace when splits > 1. On a launch without
// error, *design (when not null) is set to the kernel that ran: 0 = SIMT,
// 1 = tensor cores. Returns cudaGetLastError() after the launch.
extern "C" int winograd_fwd(const void* x, const void* u, const void* bias,
                            const void* scale, const void* shift, void* y,
                            int B, int H, int W, int C, int Co, int dtype,
                            int splits, void* ws, void* stream, int* design) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C < 1 || Co < 1 ||
      (scale == nullptr) != (shift == nullptr) || splits < 1 || splits > 65535 ||
      (splits > 1 && (dtype != 1 || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 0)
    rc = launch<float>(x, u, (const float*)bias, (const float*)scale,
                       (const float*)shift, y, B, H, W, C, Co, s);
  else if (dtype == 1 && scale != nullptr)
    rc = launch_tc<true>(x, u, (const float*)bias, (const float*)scale,
                         (const float*)shift, y, (float*)ws, B, H, W, C, Co, splits, s);
  else if (dtype == 1)
    rc = launch_tc<false>(x, u, (const float*)bias, nullptr, nullptr, y,
                          (float*)ws, B, H, W, C, Co, splits, s);
  if (rc == 0 && design != nullptr) *design = dtype;
  return rc;
}
