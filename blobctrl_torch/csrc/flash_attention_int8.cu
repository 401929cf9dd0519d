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
// rounding that the plain PyTorch version makes separately.
//
// What bounds it on the H100: 2*BH*Sq*Skv*D int8 operations for q.k^T plus
// as many bf16 operations for P.V against (q8 + k8 + v + o) bytes: thousands
// of operations per byte at the production shapes (S = 8192 with D = 40),
// so it is bound by arithmetic, plus one exp per score on the special-
// function units.
//
// What this first version does about it: it keeps the S x S scores out of
// device memory and is otherwise plain, built like csrc/flash_attention.cu.
// One 256-thread block owns 64 query rows and walks the keys in 64-row
// tiles; q and k rows sit in shared memory as int8 packed four to a 32-bit
// word, and each thread forms a 4 x 4 block of scores with __dp4a
// (4 MACs per instruction, int32 accumulate); the softmax numerator and
// P.V run on the CUDA cores in fp32. No padding of D in device memory: a
// head dim that is not a multiple of 4 leaves zero bytes in the last word.
// The ragged key tail gets p = 0, the ragged query tail is not stored.
// |s| <= D * 127^2 fits int32 for any D <= 160. s8/bf16 mma tiles are the
// known next step for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // key rows per tile
constexpr int NT = 256;      // threads: 16 (tx) x 16 (ty)
constexpr int MAX_DJ = 10;   // output columns per thread: D <= 16 * MAX_DJ = 160

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// Pack row r (of n rows starting at row0) of an int8 (rows, D) matrix into
// words: word w holds d = 4w .. 4w+3, zero beyond D or beyond the last row.
__device__ __forceinline__ void load_packed(int* dst, const int8_t* src, int row0,
                                            int nrows_total, int nrows, int D,
                                            int ldw, int tid) {
  const int nw = (D + 3) / 4;
  for (int e = tid; e < nrows * nw; e += NT) {
    const int r = e / nw, w = e % nw;
    uint32_t word = 0;
    if (row0 + r < nrows_total) {
      const int8_t* row = src + (size_t)(row0 + r) * D;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int d = 4 * w + b;
        if (d < D) word |= (uint32_t)(uint8_t)row[d] << (8 * b);
      }
    }
    dst[r * ldw + w] = (int)word;
  }
}

template <typename T, bool GLOBAL_K>
__global__ void __launch_bounds__(NT) flash_int8_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ rq,
    const float* __restrict__ ks, T* __restrict__ o, int Sq, int Skv, int D,
    float fm) {
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
  const int8_t* qb = q + bh * Sq * D;
  const int8_t* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;
  const float* rqb = rq + bh * Sq;
  const float* ksb = GLOBAL_K ? nullptr : ks + bh * Skv;
  T* ob = o + bh * Sq * D;
  const int nj = (D + 15) / 16;

  load_packed(Qs, qb, q0, Sq, BQ, D, ldw, tid);
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
    load_packed(Ks, kb, kv0, Skv, BKV, D, ldw, tid);
    for (int e = tid; e < BKV * D; e += NT) {
      const int r = e / D, d = e % D;
      Vs[r * D + d] = kv0 + r < Skv ? to_f32(vb[(size_t)(kv0 + r) * D + d]) : 0.f;
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
        float p = 0.f;
        if (kv0 + col < Skv) {
          const float sf = __int2float_rn(s[i][j]);
          if (GLOBAL_K)
            p = exp2f(__fsub_rn(__fmul_rn(sf, r_mult[i]), fm));
          else
            p = expf(__fsub_rn(__fmul_rn(__fmul_rn(sf, r_mult[i]), KSs[col]), fm));
        }
        psum += p;
        Ps[(ty * 4 + i) * (BKV + 1) + col] = to_f32(from_f32<T>(p));
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
      if (j < nj && d < D) ob[(size_t)r * D + d] = from_f32<T>(acc[i][j] / l_run[i]);
    }
  }
}

template <typename T, bool GLOBAL_K>
int launch(const void* q, const void* k, const void* v, const float* rq,
           const float* ks, void* o, int BH, int Sq, int Skv, int D, float fm,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_int8_kernel<T, GLOBAL_K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)BH);
  flash_int8_kernel<T, GLOBAL_K><<<grid, NT, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)k, (const T*)v, rq, ks, (T*)o, Sq, Skv,
      D, fm);
  return (int)cudaGetLastError();
}

}  // namespace

// q8: (BH, Sq, D) int8, k8: (BH, Skv, D) int8, v: (BH, Skv, D) and
// o: (BH, Sq, D) in dtype (0 = float32, 1 = bfloat16), all contiguous,
// D <= 160. rq: (BH, Sq) fp32 per-query-row multipliers; ks: (BH, Skv) fp32
// per-key-row scales (per-row mode) or null (global_k = 1). fm: the shift in
// the exponent's units (fixed_max * log2(e) in global-k mode, fixed_max in
// per-row mode). Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_int8_fwd(const void* q8, const void* k8,
                                        const void* v, const void* rq,
                                        const void* ks, void* o, int BH,
                                        int Sq, int Skv, int D, float fm,
                                        int global_k, int dtype, void* stream) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (D < 1 || D > 16 * MAX_DJ || (!global_k && ks == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rq;
  const float* kk = (const float*)ks;
  if (dtype == 0)
    return global_k ? launch<float, true>(q8, k8, v, r, kk, o, BH, Sq, Skv, D, fm, s)
                    : launch<float, false>(q8, k8, v, r, kk, o, BH, Sq, Skv, D, fm, s);
  if (dtype == 1)
    return global_k
               ? launch<__nv_bfloat16, true>(q8, k8, v, r, kk, o, BH, Sq, Skv, D, fm, s)
               : launch<__nv_bfloat16, false>(q8, k8, v, r, kk, o, BH, Sq, Skv, D, fm, s);
  return (int)cudaErrorInvalidValue;
}
