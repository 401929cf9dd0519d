// Flash attention forward with int8 q.k^T (non-causal, unmasked) for NVIDIA
// Hopper (sm_90a): o = softmax-with-fixed-shift(int8 scores) v over
// (BH, S, D) tensors, one pass, the S x S scores never leaving the chip.
//
// Replaces: blobctrl_tpu/ops/flash_attention.py `_flash_kernel_int8g` (the
// global-k-scale variant of the int8-everything mode) and, as the other
// mode of one template, `_flash_kernel_int8` (per-row k scales, the opt-in
// qk_int8 variant).
//
// What it computes. q and k arrive already quantized to int8 by the wrapper
// (ops/flash_attention.py `int8_operands`, plain torch as in the JAX package
// where they are XLA ops outside the kernel), with fp32 multipliers:
//   s[i,j] = sum_d q8[i,d] * k8[j,d]                      in int32
//   global-k mode:  p = exp2f(float(s) * rm[i] - fm)      fm = fixed_max*log2(e)
//   per-row mode:   p = expf(float(s) * qs[i] * ks[j] - fm)  fm = fixed_max
//   o[i]  = sum_j round_to_v_dtype(p) * v[j] / sum_j p    in fp32
// (rm[i] = qs[i] * scale*log2(e) * ka and qs[i] = qs_row[i] * scale are
// folded by the wrapper.) Each elementwise step uses an explicit
// round-to-nearest intrinsic, so nvcc's FMA contraction cannot change a
// rounding that the plain PyTorch version makes separately; exp2f and expf
// are the accurate library functions, never ex2.approx. int32 sums are
// exact in any order: |s| <= 160 * 127^2.
//
// Rows of q8 and k8: the wrapper hands them over padded with zeros to DP =
// D rounded up to 16 bytes (`int8_rows` in the wrapper). At D = 40 a
// D-byte row is 8-byte aligned only; padded, every row takes 16-byte
// cp.async copies, one path for any D, and the zeros add nothing to an
// integer sum. The padding costs one pass over the int8 q and k (a quarter
// of the bf16 q and k bytes) in the plain-torch pre-pass.
//
// What bounds it on the H100: 2*BH*Sq*Skv*D int8 operations for q.k^T plus
// as many bf16 operations for P.V against (q8 + k8 + v + o) bytes: thousands
// of operations per byte at the production shapes (S = 8192 with D = 40),
// so it is bound by arithmetic: the two products on the tensor cores and
// one accurate exponential per score on the CUDA cores and special-function
// units, which bounds it first at D = 40.
//
// Two kernels, chosen by dtype in the C entry point (never one as a
// fallback of the other):
//
// bf16: `flash_int8_kernel_tc`, built like csrc/flash_attention.cu's
// `flash_kernel_tc`. A 256-thread block owns 128 query rows, 16 a warp. The
// block's q8 tile is copied once and its s8 A fragments stay in registers
// for the whole key loop. k8 tiles (int8) and v tiles (bf16) of 64 keys
// stream through a three-stage cp.async ring, zero-filled past the ragged
// tail, one barrier a tile. S runs on mma.sync m16n8k32 s8 x s8 -> s32, and
// where DK is not a multiple of 32 one m16n8k16 s8 step takes the last 16
// columns (D = 40 pads to 48 in shared memory, D = 80 is 64 + 16). k8 is
// (key, d) row-major, the "col" layout of the B operand, so its fragments
// come from plain ldmatrix over the int8 rows. The s32 accumulator has the
// fp32 C layout of m16n8k16, so p is formed in registers in the SIMT
// kernel's sequence and rounded to bf16 straight into P.V's A fragments
// (mma.sync m16n8k16 bf16, v by ldmatrix.trans); the row sum l takes the
// fp32 p. There is no running max. Per-row mode reads its key scales from
// device memory (L1) with each tile. Specialised on (DK, DN) = (48, 40) for
// D <= 40, (80, 80) for D <= 80 and (160, 160) for D <= 160, two modes each.
// v rows that are not a multiple of 16 bytes take masked 2-byte loads.
//
// fp32: `flash_int8_kernel`, the first version, SIMT, now fp32 only (fp32
// P.V has no tensor-core form that keeps its products exact).
// One 256-thread block owns 64 query rows and walks the keys in 64-row
// tiles; q and k rows sit in shared memory as int8 packed four to a 32-bit
// word, each thread forms a 4 x 4 block of scores with __dp4a, and the
// softmax numerator and P.V run on the CUDA cores in fp32.
//
// Both: the ragged key tail gets p = 0, the ragged query tail is not
// stored.

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

// p of one score in the SIMT kernel's sequence of roundings: r = rm[i]
// (global k) or qs[i] * scale (per row, times the key's scale kscale).
template <bool GLOBAL_K>
__device__ __forceinline__ float score_p(int s, float r, float kscale, float fm) {
  const float sf = __int2float_rn(s);
  if (GLOBAL_K) return exp2f(__fsub_rn(__fmul_rn(sf, r), fm));
  return expf(__fsub_rn(__fmul_rn(__fmul_rn(sf, r), kscale), fm));
}

// Reduce over the 16 lanes that share a score row (one half warp).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Word stride of the packed q and k rows: odd, so that the 16 lanes walking
// 16 different k rows hit 16 different banks.
__host__ __device__ __forceinline__ int word_ld(int D) { return ((D + 3) / 4) | 1; }

size_t smem_bytes(int D) {
  const int ldw = word_ld(D);
  return sizeof(int) * ((size_t)BQ * ldw + (size_t)BKV * ldw) +
         sizeof(float) * ((size_t)BKV * D + (size_t)BQ * (BKV + 1) + BKV);
}

// Pack row r (of n rows starting at row0) of an int8 (rows, DP) matrix into
// words: word w holds d = 4w .. 4w+3, zero beyond D or beyond the last row.
__device__ __forceinline__ void load_packed(int* dst, const int8_t* src, int row0,
                                            int nrows_total, int nrows, int D,
                                            int DP, int ldw, int tid) {
  const int nw = (D + 3) / 4;
  for (int e = tid; e < nrows * nw; e += NT) {
    const int r = e / nw, w = e % nw;
    uint32_t word = 0;
    if (row0 + r < nrows_total) {
      const int8_t* row = src + (size_t)(row0 + r) * DP;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int d = 4 * w + b;
        if (d < D) word |= (uint32_t)(uint8_t)row[d] << (8 * b);
      }
    }
    dst[r * ldw + w] = (int)word;
  }
}

template <bool GLOBAL_K>
__global__ void __launch_bounds__(NT) flash_int8_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ rq,
    const float* __restrict__ ks, float* __restrict__ o, int Sq, int Skv,
    int D, int DP, float fm) {
  extern __shared__ int smem_i[];
  const int ldw = word_ld(D);
  const int nw = (D + 3) / 4;
  int* Qs = smem_i;                                   // [BQ][ldw] packed int8
  int* Ks = Qs + BQ * ldw;                            // [BKV][ldw] packed int8
  float* Vs = reinterpret_cast<float*>(Ks + BKV * ldw);  // [BKV][D]
  float* Ps = Vs + BKV * D;                           // [BQ][BKV + 1]
  float* KSs = Ps + BQ * (BKV + 1);                   // [BKV] per-row k scales

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // score columns tx + 16*j; output columns tx + 16*j
  const int ty = tid / 16;   // rows ty*4 + i
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const int8_t* qb = q + bh * Sq * DP;
  const int8_t* kb = k + bh * Skv * DP;
  const float* vb = v + bh * Skv * D;
  const float* rqb = rq + bh * Sq;
  const float* ksb = GLOBAL_K ? nullptr : ks + bh * Skv;
  float* ob = o + bh * Sq * D;
  const int nj = (D + 15) / 16;

  load_packed(Qs, qb, q0, Sq, BQ, D, DP, ldw, tid);
  float r_mult[4];   // rm[i] (global k) or qs[i]*scale (per row)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    r_mult[i] = r < Sq ? rqb[r] : 0.f;
  }

  float l_run[4], acc[4][MAX_DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    load_packed(Ks, kb, kv0, Skv, BKV, D, DP, ldw, tid);
    for (int e = tid; e < BKV * D; e += NT) {
      const int r = e / D, d = e % D;
      Vs[r * D + d] = kv0 + r < Skv ? vb[(size_t)(kv0 + r) * D + d] : 0.f;
    }
    if (!GLOBAL_K && tid < BKV) KSs[tid] = kv0 + tid < Skv ? ksb[kv0 + tid] : 0.f;
    __syncthreads();

    int s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0;
    for (int w = 0; w < nw; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ldw + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ldw + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __dp4a(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = kv0 + col < Skv
                            ? score_p<GLOBAL_K>(s[i][j], r_mult[i],
                                                GLOBAL_K ? 0.f : KSs[col], fm)
                            : 0.f;
        psum += p;
        Ps[(ty * 4 + i) * (BKV + 1) + col] = p;
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
      if (j < nj && d < D) ob[(size_t)r * D + d] = acc[i][j] / l_run[i];
    }
  }
}

template <bool GLOBAL_K>
int launch(const void* q, const void* k, const void* v, const float* rq,
           const float* ks, void* o, int BH, int Sq, int Skv, int D, int DP,
           float fm, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_int8_kernel<GLOBAL_K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)BH);
  flash_int8_kernel<GLOBAL_K><<<grid, NT, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)k, (const float*)v, rq, ks, (float*)o,
      Sq, Skv, D, DP, fm);
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
constexpr int TC_STAGES = 3;          // k8/v tiles in flight: one barrier per tile

// Shared row strides: an odd count of 16-byte units, so the eight rows one
// ldmatrix reads fall in distinct banks. int8 rows of DK bytes (48, 80: odd
// already; 160 -> 176); bf16 v rows of DN rounded up to 16, plus 8.
__host__ __device__ constexpr int qk_ld(int DK) { return (DK / 16) % 2 ? DK : DK + 16; }
__host__ __device__ constexpr int v_ld(int DN) { return (DN + 15) / 16 * 16 + 8; }

// q8 [TC_BQ][qk_ld], k8 [TC_STAGES][TC_BKV][qk_ld] (bytes), then v
// [TC_STAGES][TC_BKV][v_ld] (bf16)
size_t tc_smem_bytes(int DK, int DN) {
  return (size_t)(TC_BQ + TC_STAGES * TC_BKV) * qk_ld(DK) +
         sizeof(bf16) * (size_t)TC_STAGES * TC_BKV * v_ld(DN);
}

// Rows [row0, row0 + ROWS) of a zero-padded int8 (n_rows, DP) matrix into
// shared rows of LD bytes, DK bytes each: zeros past n_rows and past DP.
template <int DK, int LD, int ROWS>
__device__ __forceinline__ void load_rows_s8(int8_t* sm, const int8_t* g, int row0,
                                             int n_rows, int DP) {
  constexpr int CH = DK / 16;
  for (int e = threadIdx.x; e < ROWS * CH; e += TC_NT) {
    const int r = e / CH, c = e % CH;
    const bool ok = row0 + r < n_rows && c * 16 < DP;
    tc::cp_async16(tc::smem_addr(sm + r * LD + c * 16),
                   ok ? g + (size_t)(row0 + r) * DP + c * 16 : g, ok ? 16 : 0);
  }
}

// Rows of a row-major (n_rows, D) bf16 matrix into shared rows of LD
// elements, COLS (D rounded up to 16) of them, zeros past n_rows and D.
template <int COLS, int LD, int ROWS>
__device__ __forceinline__ void load_rows_bf16(bf16* sm, const bf16* g, int row0,
                                               int n_rows, int D, bool vec) {
  if (vec) {  // D % 8 == 0, g 16-byte aligned: asynchronous 16-byte copies
    constexpr int CH = COLS / 8;
    for (int e = threadIdx.x; e < ROWS * CH; e += TC_NT) {
      const int r = e / CH, c = e % CH;
      const bool ok = row0 + r < n_rows && c * 8 < D;
      tc::cp_async16(tc::smem_addr(sm + r * LD + c * 8),
                     ok ? g + (size_t)(row0 + r) * D + c * 8 : g, ok ? 16 : 0);
    }
  } else {  // masked 2-byte loads
    for (int e = threadIdx.x; e < ROWS * COLS; e += TC_NT) {
      const int r = e / COLS, d = e % COLS;
      sm[r * LD + d] = row0 + r < n_rows && d < D ? g[(size_t)(row0 + r) * D + d]
                                                  : __float2bfloat16(0.f);
    }
  }
}

// DK: q.k^T depth in bytes (D padded to 16); DN: P.V columns (D padded to 8).
template <bool GLOBAL_K, int DK, int DN>
__global__ void __launch_bounds__(TC_NT) flash_int8_kernel_tc(
    const int8_t* __restrict__ q, const int8_t* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ rq,
    const float* __restrict__ ks, bf16* __restrict__ o, int Sq, int Skv,
    int D, int DP, float fm, int v_vec) {
  static_assert(DK % 16 == 0 && DN % 8 == 0 && DN <= DK, "tile shapes");
  constexpr int QLD = qk_ld(DK), VLD = v_ld(DN);
  constexpr int VCOLS = (DN + 15) / 16 * 16;
  constexpr int K32 = DK / 32;               // m16n8k32 steps
  constexpr bool K16 = DK % 32 != 0;         // and a last m16n8k16 step
  constexpr int NJ = TC_BKV / 8;             // score n-tiles of a warp
  constexpr int NO = DN / 8;                 // output n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Ks = Qs + TC_BQ * QLD;
  bf16* Vs = reinterpret_cast<bf16*>(Ks + TC_STAGES * TC_BKV * QLD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = (lane & 3) * 2;
  const int q0 = blockIdx.x * TC_BQ;
  const size_t bh = blockIdx.y;
  const int8_t* qb = q + bh * Sq * DP;
  const int8_t* kb = k + bh * Skv * DP;
  const bf16* vb = v + bh * Skv * D;
  const float* ksb = GLOBAL_K ? nullptr : ks + bh * Skv;
  bf16* ob = o + bh * Sq * D;
  const int n_tiles = (Skv + TC_BKV - 1) / TC_BKV;

  // one copy group per tile, the first with q8; tiles 0 and 1 in flight
  load_rows_s8<DK, QLD, TC_BQ>(Qs, qb, q0, Sq, DP);
  for (int t = 0; t < 2 && t < n_tiles; ++t) {
    load_rows_s8<DK, QLD, TC_BKV>(Ks + t * TC_BKV * QLD, kb, t * TC_BKV, Skv, DP);
    load_rows_bf16<VCOLS, VLD, TC_BKV>(Vs + t * TC_BKV * VLD, vb, t * TC_BKV, Skv, D,
                                       v_vec);
    tc::cp_async_commit();
  }

  // this thread's rows g (h = 0: accumulator elements 0, 1) and g + 8 (h = 1)
  float r_mult[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    r_mult[h] = r < Sq ? rq[bh * Sq + r] : 0.f;
  }
  uint32_t qf[K32 + (K16 ? 1 : 0)][4];  // this warp's 16 rows of q8 as A fragments
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % TC_STAGES;
    if (t + 1 < n_tiles)
      tc::cp_async_wait<1>();  // tile t has landed; t + 1 may be in flight
    else
      tc::cp_async_wait<0>();
    // tile t is visible to all, and every warp is done with tile t - 1,
    // whose stage tile t + 2 takes
    __syncthreads();
    if (t + 2 < n_tiles) {
      const int s2 = (t + 2) % TC_STAGES;
      load_rows_s8<DK, QLD, TC_BKV>(Ks + s2 * TC_BKV * QLD, kb, (t + 2) * TC_BKV, Skv, DP);
      load_rows_bf16<VCOLS, VLD, TC_BKV>(Vs + s2 * TC_BKV * VLD, vb, (t + 2) * TC_BKV,
                                         Skv, D, v_vec);
      tc::cp_async_commit();
    }
    if (t == 0) {
      const int8_t* qw = Qs + (warp * 16 + (lane & 15)) * QLD + (lane >> 4) * 16;
#pragma unroll
      for (int kk = 0; kk < K32; ++kk) tc::ldmatrix_x4(qf[kk], tc::smem_addr(qw + kk * 32));
      if (K16) {  // a0, a1 of the last 16 columns (lanes 16..31 repeat them)
        tc::ldmatrix_x4(qf[K32], tc::smem_addr(Qs + (warp * 16 + (lane & 15)) * QLD +
                                               K32 * 32));
      }
    }
    const int8_t* Kt = Ks + st * TC_BKV * QLD;
    const bf16* Vt = Vs + st * TC_BKV * VLD;

    // S = q8 k8^T: k8's rows are the columns of B, so ldmatrix without .trans
    int s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < K32; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t b[4];  // keys j*8.. (b0, b1), then (j+1)*8.. (b0, b1)
        tc::ldmatrix_x4(b, tc::smem_addr(Kt + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * QLD +
                                         kk * 32 + ((lane >> 3) & 1) * 16));
        tc::mma_s8(s[j], qf[kk], b[0], b[1]);
        tc::mma_s8(s[j + 1], qf[kk], b[2], b[3]);
      }
    }
    if (K16) {
#pragma unroll
      for (int j = 0; j < NJ; j += 4) {
        uint32_t b[4];  // b0 of key tiles j .. j + 3, columns DK - 16 ..
        tc::ldmatrix_x4(b, tc::smem_addr(Kt + (j * 8 + lane) * QLD + K32 * 32));
#pragma unroll
        for (int i = 0; i < 4; ++i) tc::mma_s8_k16(s[j + i], qf[K32][0], qf[K32][1], b[i]);
      }
    }

    // p in fp32 for l, rounded to bf16 straight into P.V's A fragments:
    // k-step kk covers score tiles 2kk (a0, a1) and 2kk + 1 (a2, a3)
    const int kv0 = t * TC_BKV;
    uint32_t pa[TC_BKV / 16][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + tq + (e & 1);
        p[e] = col < Skv ? score_p<GLOBAL_K>(s[j][e], r_mult[e >> 1],
                                             GLOBAL_K ? 0.f : ksb[col], fm)
                         : 0.f;
      }
      l_run[0] += p[0] + p[1];
      l_run[1] += p[2] + p[3];
      pa[j / 2][(j & 1) * 2] = tc::pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = tc::pack_bf16(p[2], p[3]);
    }

    // O += P V: v's rows are the k of B, so ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TC_BKV / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];  // n-tiles j and j + 1 (past DN: zero columns, unused)
        tc::ldmatrix_x4_trans(b, tc::smem_addr(
                                     Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VLD +
                                     j * 8 + (lane >> 4) * 8));
        tc::mma_bf16(acc[j], pa[kk], b[0], b[1]);
        if (j + 1 < NO) tc::mma_bf16(acc[j + 1 < NO ? j + 1 : j], pa[kk], b[2], b[3]);
      }
    }
  }

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
      const int d = j * 8 + tq;
      const float y0 = acc[j][2 * h] / l, y1 = acc[j][2 * h + 1] / l;
      if (v_vec && d + 1 < D) {  // D % 8 == 0: an aligned pair
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(y0, y1);
      } else {
        if (d < D) orow[d] = __float2bfloat16(y0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16(y1);
      }
    }
  }
}

template <bool GLOBAL_K, int DK, int DN>
int launch_tc_d(const void* q, const void* k, const void* v, const float* rq,
                const float* ks, void* o, int BH, int Sq, int Skv, int D, int DP,
                float fm, int v_vec, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(DK, DN);
  cudaError_t err = cudaFuncSetAttribute(
      flash_int8_kernel_tc<GLOBAL_K, DK, DN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + TC_BQ - 1) / TC_BQ), (unsigned)BH);
  flash_int8_kernel_tc<GLOBAL_K, DK, DN><<<grid, TC_NT, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)k, (const bf16*)v, rq, ks, (bf16*)o, Sq,
      Skv, D, DP, fm, v_vec);
  return (int)cudaGetLastError();
}

template <bool GLOBAL_K>
int launch_tc(const void* q, const void* k, const void* v, const float* rq,
              const float* ks, void* o, int BH, int Sq, int Skv, int D, int DP,
              float fm, cudaStream_t s) {
  const int v_vec = D % 8 == 0 && (((uintptr_t)v | (uintptr_t)o) & 15) == 0;
  if (D <= 40)
    return launch_tc_d<GLOBAL_K, 48, 40>(q, k, v, rq, ks, o, BH, Sq, Skv, D, DP, fm, v_vec, s);
  if (D <= 80)
    return launch_tc_d<GLOBAL_K, 80, 80>(q, k, v, rq, ks, o, BH, Sq, Skv, D, DP, fm, v_vec, s);
  return launch_tc_d<GLOBAL_K, 160, 160>(q, k, v, rq, ks, o, BH, Sq, Skv, D, DP, fm, v_vec, s);
}

}  // namespace

// q8: (BH, Sq, DP) and k8: (BH, Skv, DP) int8, DP = D rounded up to 16, the
// columns past D zero; v: (BH, Skv, D) and o: (BH, Sq, D) in dtype (0 =
// float32, the SIMT kernel; 1 = bfloat16, the tensor-core kernel), all
// contiguous, D <= 160, q8 and k8 16-byte aligned. rq: (BH, Sq) fp32
// per-query-row multipliers; ks: (BH, Skv) fp32 per-key-row scales (per-row
// mode) or null (global_k = 1). fm: the shift in the exponent's units
// (fixed_max * log2(e) in global-k mode, fixed_max in per-row mode). On a
// launch without error, *design (when not null) is set to the kernel that
// ran: 0 = SIMT, 1 = tensor cores. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_int8_fwd(const void* q8, const void* k8,
                                        const void* v, const void* rq,
                                        const void* ks, void* o, int BH,
                                        int Sq, int Skv, int D, float fm,
                                        int global_k, int dtype, void* stream,
                                        int* design) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (D < 1 || D > 16 * MAX_DJ || (!global_k && ks == nullptr) ||
      (dtype != 0 && dtype != 1) || (((uintptr_t)q8 | (uintptr_t)k8) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int DP = (D + 15) / 16 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rq;
  const float* kk = (const float*)ks;
  int rc;
  if (dtype == 0)
    rc = global_k ? launch<true>(q8, k8, v, r, kk, o, BH, Sq, Skv, D, DP, fm, s)
                  : launch<false>(q8, k8, v, r, kk, o, BH, Sq, Skv, D, DP, fm, s);
  else
    rc = global_k ? launch_tc<true>(q8, k8, v, r, kk, o, BH, Sq, Skv, D, DP, fm, s)
                  : launch_tc<false>(q8, k8, v, r, kk, o, BH, Sq, Skv, D, DP, fm, s);
  if (rc == 0 && design != nullptr) *design = dtype;
  return rc;
}
