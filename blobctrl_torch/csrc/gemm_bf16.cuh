// The bf16 tensor-core GEMM mainloop shared by csrc/conv3x3.cu (K6/K7: an
// implicit GEMM over a 3x3 halo) and csrc/norm_matmul.cu (K10/K11: a GEMM
// over rows with a normalize prologue), for sm_90a.
//
// A block computes a BM x BN fp32 tile of A . B (the Tile). K is walked in
// BK-channel slices, each slice in Loader::TAPS steps (the conv's 9 taps
// are 9 shifted views of one halo slice; the GEMM has 1). Both operands
// arrive by 16-byte cp.async, issued STAGES - 1 steps ahead, one commit
// group a step:
//   * B, the weights, a row-major (K, N) bf16 matrix per tap, into a ring of
//     STAGES stages (zero-filled past K and N; masked 2-byte stores when
//     N % 8 != 0 or w is unaligned);
//   * A through the Loader, a slice at a time, into a ring of
//     Loader::A_STAGES stages (the copies of a slice go with its first
//     tap's B). Rows and taps outside the data are zero-filled. Before the
//     slice's first step, each thread waits for its own copies and runs the
//     prologue in place on the chunks it copied (Loader::prologue), once per
//     element, rounding to bf16 and leaving the zero-filled chunks 0: the
//     zero padding comes after the prologue, never prologue(0). (Run in
//     parts between the previous step's products instead, it was slower on
//     the card for both kernels.) Where x takes no 16-byte copies
//     (C % 8 != 0), Loader::issue loads, applies the prologue and stores
//     at once, in 2-byte loads.
//   * products: mma.sync m16n8k16 bf16 x bf16 -> fp32, A by ldmatrix (the
//     Loader maps (tile row, tap) to its stage's row), B by ldmatrix.trans,
//     warps as 2 (M) x Tile::WARPS_N (N), 64 x 64 outputs a warp (128
//     fp32 accumulators a thread; per 16-deep k step 8 ldmatrix feed 32
//     mma). Warps whose columns all lie past N skip the products.
// One barrier a step. for_each_pair hands the accumulators to the kernel's
// epilogue; store_pair adds bias (and a residual) in the SIMT kernels'
// order and rounds to bf16, or, where K is split across blocks, writes the
// fp32 partial tile to a workspace that split_sum_kernel adds in order.
//
// mma.sync and not wgmma: mma.sync with ldmatrix reached 1.3x SDPA in the
// flash kernel (csrc/flash_attention.cu) and takes A from any shared rows,
// which the halo's shifted views need; wgmma with TMA and warp-specialised
// producers is left for later.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace gemm {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // the block's rows
constexpr int WM = 64, WN = 64;  // a warp's output tile
constexpr int MT = WM / 16, NJ = WN / 8;

// The block's columns: BN = 128 (4 warps as 2 x 2, two blocks an SM) or 256
// (8 warps as 2 x 4, one block an SM, half the prologue work and a quarter
// less traffic per product).
template <int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = (BM / WM) * WARPS_N * 32;  // threads
  // B rows of BN + 8: an odd count of 16-byte units, so the 8 rows of an
  // ldmatrix hit 8 different bank groups
  static constexpr int B_LD = BN + 8;
  static_assert(BN % WN == 0 && (B_LD / 8) % 2 == 1, "tile");
};

__device__ __forceinline__ uint32_t bf16_bits(bf16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

// BK rows [k0, k0 + BK) x BN columns [n0, n0 + BN) of the row-major (K, N)
// bf16 matrix w into one B stage, zeros at rows >= k_end and columns >= N.
template <class T, int BK>
__device__ __forceinline__ void load_b(bf16* bs, const bf16* w, int N, int n0,
                                       int k0, int k_end, bool vec) {
  if (vec) {  // N % 8 == 0: 8 columns lie wholly inside or outside N
    constexpr int CPR = T::BN / 8;
    static_assert(BK * CPR % T::NT == 0, "whole copies a thread");
#pragma unroll
    for (int i = 0; i < BK * CPR / T::NT; ++i) {
      const int e = threadIdx.x + i * T::NT;
      const int r = e / CPR, cc = e % CPR;
      const int k = k0 + r, n = n0 + cc * 8;
      const bool ok = k < k_end && n < N;
      tc::cp_async16(tc::smem_addr(bs + r * T::B_LD + cc * 8),
                     ok ? w + (size_t)k * N + n : w, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * T::BN; e += T::NT) {
      const int r = e / T::BN, j = e % T::BN;
      const int k = k0 + r, n = n0 + j;
      bs[r * T::B_LD + j] = k < k_end && n < N ? w[(size_t)k * N + n]
                                               : __float2bfloat16(0.f);
    }
  }
}

// acc += A . B over channels [c_begin, c_end) of every tap. w: tap t's B is
// w + t * tap_stride, rows indexed by channel. As: Loader::A_STAGES A
// stages of Loader::STAGE_ELEMS bf16 (Loader::ROWS x (BK + 8)); Bs:
// STAGES B stages of BK x T::B_LD. A Loader's prologue may read only the
// chunks its thread copied: a thread waits for its own copies alone.
template <class T, int BK, int STAGES, class Loader>
__device__ __forceinline__ void mainloop(const Loader& ld, const bf16* w,
                                         size_t tap_stride, int N, int n0,
                                         int c_begin, int c_end, bool w_vec,
                                         bf16* As, bf16* Bs,
                                         float (&acc)[MT][NJ][4]) {
  constexpr int TAPS = Loader::TAPS, A_STAGES = Loader::A_STAGES;
  constexpr int A_LD = BK + 8;  // an odd count of 16-byte units, as B_LD
  constexpr int A_STAGE = Loader::STAGE_ELEMS;
  constexpr int B_LD = T::B_LD, WARPS_N = T::WARPS_N;
  constexpr int B_STAGE = BK * B_LD;
  static_assert(STAGES >= 3, "a ring of at least three B stages");
  // the A stage a slice's copies go to was last read STAGES - 1 steps
  // earlier at the latest, before that step's barrier
  static_assert(A_STAGES >= (STAGES - 2) / TAPS + 2, "A stages");
  const int n_slices = c_end > c_begin ? (c_end - c_begin + BK - 1) / BK : 0;
  const int n_steps = n_slices * TAPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const bool live = n0 + wn * WN < N;
  if (n_steps == 0) return;

  auto issue = [&](int step) {  // one commit group a step, empty past the end
    if (step < n_steps) {
      const int s = step / TAPS, t = step - s * TAPS;
      if (t == 0) ld.issue(As + (s % A_STAGES) * A_STAGE, c_begin + s * BK);
      load_b<T, BK>(Bs + (step % STAGES) * B_STAGE, w + t * tap_stride, N, n0,
                 c_begin + s * BK, c_end, w_vec);
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) issue(st);
  tc::cp_async_wait<STAGES - 2>();
  ld.prologue(As, c_begin);

  // Step (s, t): wait for this thread's copies of the step; one barrier
  // (B of the step and A of the slice are visible, the stages read a step
  // ago are free); copy step + STAGES - 1; the products, 16 channels at a
  // time. After a slice's last tap, the next slice's A has landed (its
  // group is older than the STAGES - 2 newest): its prologue runs in place
  // before the next barrier.
  int s = 0, t = 0;
  for (int step = 0; step < n_steps; ++step) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(step + STAGES - 1);
    if (live) {
      const bf16* as = As + (s % A_STAGES) * A_STAGE;
      const bf16* bs = Bs + (step % STAGES) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t b[NJ][2], a[MT][4];
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t q[4];
          tc::ldmatrix_x4_trans(
              q, tc::smem_addr(bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * B_LD +
                               wn * WN + j * 8 + (lane >> 4) * 8));
          b[j][0] = q[0];
          b[j][1] = q[1];
          b[j + 1][0] = q[2];
          b[j + 1][1] = q[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::ldmatrix_x4(a[mt], tc::smem_addr(as + ld.a_row(wm * WM + mt * 16 + (lane & 15), t) * A_LD +
                                               kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NJ; ++j) tc::mma_bf16(acc[mt][j], a[mt], b[j][0], b[j][1]);
      }
    }
    if (t == TAPS - 1 && s + 1 < n_slices) {
      tc::cp_async_wait<STAGES - 2>();
      ld.prologue(As + ((s + 1) % A_STAGES) * A_STAGE, c_begin + (s + 1) * BK);
    }
    if (++t == TAPS) {
      t = 0;
      ++s;
    }
  }
}

// put(row, col, v0, v1) for each pair of neighbouring outputs (row, col) and
// (row, col + 1) of the block tile that this thread holds (local indices).
template <class T, class Put>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][NJ][4],
                                              Put put) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int g = lane >> 2, tq = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put(wm * WM + mt * 16 + g + 8 * h, wn * WN + j * 8 + tq,
            acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
}

// Outputs n and n + 1 (n < N) of the (rows, N) result at offset o = row * N
// + n. ws not null (a K split): the fp32 sums into ws. Else y = bf16(v +
// bias [+ res]), each add rounded to nearest in that order.
__device__ __forceinline__ void store_pair(size_t o, int n, int N, float v0,
                                           float v1, const float* bias,
                                           const bf16* res, bf16* y,
                                           float* ws) {
  const bool two = n + 1 < N;
  const bool pair = two && N % 2 == 0;  // o even: 8- and 4-byte aligned stores
  if (ws != nullptr) {
    if (pair) {
      *reinterpret_cast<float2*>(ws + o) = make_float2(v0, v1);
    } else {
      ws[o] = v0;
      if (two) ws[o + 1] = v1;
    }
    return;
  }
  v0 = __fadd_rn(v0, bias[n]);
  if (res != nullptr) v0 = __fadd_rn(v0, __bfloat162float(res[o]));
  if (two) {
    v1 = __fadd_rn(v1, bias[n + 1]);
    if (res != nullptr) v1 = __fadd_rn(v1, __bfloat162float(res[o + 1]));
  }
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(y + o) = __floats2bfloat162_rn(v0, v1);
  } else {
    y[o] = __float2bfloat16(v0);
    if (two) y[o + 1] = __float2bfloat16(v1);
  }
}

// y = bf16(sum over the splits of ws, in order, + bias [+ res]), n outputs
// of N columns each row.
__global__ void split_sum_kernel(const float* __restrict__ ws,
                                 const float* __restrict__ bias,
                                 const bf16* __restrict__ res,
                                 bf16* __restrict__ y, long long n, int N,
                                 int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[z * n + i]);
    s = __fadd_rn(s, bias[i % N]);
    if (res != nullptr) s = __fadd_rn(s, __bfloat162float(res[i]));
    y[i] = __float2bfloat16(s);
  }
}

inline cudaError_t split_sum(const float* ws, const float* bias,
                             const bf16* res, bf16* y, long long n, int N,
                             int splits, cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  split_sum_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                     stream>>>(ws, bias, res, y, n, N, splits);
  return cudaGetLastError();
}

// The 8 bf16 of a 16-byte chunk, as floats and back.
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(tc::pack_bf16(f[0], f[1]), tc::pack_bf16(f[2], f[3]),
                    tc::pack_bf16(f[4], f[5]), tc::pack_bf16(f[6], f[7]));
}

// 8 channels [c, c + 8) from src (channel c at src[0]) in 2-byte loads,
// zeros at channels >= c_end.
__device__ __forceinline__ uint4 load8_masked(const bf16* src, int c,
                                              int c_end) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = c + 2 * i < c_end ? bf16_bits(src[2 * i]) : 0u;
    const uint32_t hi = c + 2 * i + 1 < c_end ? bf16_bits(src[2 * i + 1]) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Sets the kernel's dynamic shared memory limit on its first launch.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace gemm
