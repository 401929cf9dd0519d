// Flash attention forward (non-causal, unmasked) for NVIDIA Hopper (sm_90a):
// o = softmax(q k^T * scale) v over (BH, S, D) tensors, one pass, the S x S
// scores never leaving the chip.
//
// Replaces: blobctrl_tpu/ops/flash_attention.py `_flash_kernel_fixed_max`
// (the static softmax shift p = exp(s - FM) in place of the running max,
// exact while the logits stay within (FM - 87, FM + 88)) and, with the
// running-max mode, `_flash_kernel` (alpha-rescaled online softmax), and,
// with the exp2-folded mode, `_flash_kernel_fixed_max2` (`:55`): q arrives
// pre-scaled by scale * log2(e) and the shift -fixed_max * log2(e) comes as
// one scalar, so each score takes one add and one exp2 (p = 2^(q'.k +
// shift)). The TPU kernel carries the shift in an extra contraction lane
// d + 1 of q and k; here it is added to the fp32 dot product instead, the
// same math up to the order of one addition, and no lane is built in
// device memory. One kernel covers the three modes, selected by a template
// parameter.
//
// What bounds it on the H100: 4*BH*Sq*Skv*D operations against
// (q + k + v + o) bytes. At the production shapes (S = 8192 with D = 40,
// S = 2048 with D = 80) that is thousands of operations per byte, so it is
// bound by arithmetic: the two products on the tensor cores, plus one exp
// per score on the special-function units.
//
// What this first version does about it: it keeps the S x S scores out of
// device memory (the point of the kernel) and is otherwise plain. One
// 256-thread block owns 64 query rows and walks the keys in 64-row tiles
// through shared memory; scores, softmax and the P.V update run on the CUDA
// cores in fp32 (each thread owns a 4 x 4 block of scores and 4 rows x
// ceil(D/16) columns of the output). Differences from the TPU kernel:
//   * no padding in device memory: D in {16, 40, 80, 160} (any D <= 160) is
//     handled by the loop bounds, and shared rows use an odd stride so the
//     column walks are free of bank conflicts;
//   * no divisibility: the ragged key tail is masked to -inf, the ragged
//     query tail is simply not stored;
//   * p is rounded to the input dtype before P.V, as the TPU kernel's
//     `p.astype(v.dtype)` does, while the row sum l uses the fp32 p.
// mma/wgmma tiles for the two products are the known next step for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // key rows per tile
constexpr int NT = 256;      // threads: 16 (tx) x 16 (ty)
constexpr int MAX_DJ = 10;   // output columns per thread: D <= 16 * MAX_DJ = 160
constexpr float NEG_BIG = -1e30f;  // initial running max, as in the TPU kernel

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
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int D) {
  const int ld = D | 1;
  return sizeof(float) * ((size_t)BQ * ld + (size_t)BKV * ld + (size_t)BKV * D +
                          (size_t)BQ * (BKV + 1));
}

// MODE: 0 = running max, 1 = fixed max exp(s * scale - fixed_max),
// 2 = exp2-folded exp2(s + fixed_max) (fixed_max holds the shift).
constexpr int RUNNING_MAX = 0, FIXED_MAX = 1, EXP2_FOLD = 2;

template <typename T, int MODE>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Skv, int D, float scale, float fixed_max) {
  extern __shared__ float smem[];
  const int ld = D | 1;                // odd stride for Q and K rows
  float* Qs = smem;                    // [BQ][ld]
  float* Ks = Qs + BQ * ld;            // [BKV][ld]
  float* Vs = Ks + BKV * ld;           // [BKV][D]
  float* Ps = Vs + BKV * D;            // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // score columns tx + 16*j; output columns tx + 16*j
  const int ty = tid / 16;   // rows ty*4 + i
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;
  T* ob = o + bh * Sq * D;
  const int nj = (D + 15) / 16;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[r * ld + d] = q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float m_run[4], l_run[4], acc[4][MAX_DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_BIG;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BKV * D; e += NT) {
      const int r = e / D, d = e % D;
      const bool ok = kv0 + r < Skv;
      const size_t g = (size_t)(kv0 + r) * D + d;
      Ks[r * ld + d] = ok ? to_f32(kb[g]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kv0 + tx + 16 * j < Skv;
        if (MODE == EXP2_FOLD)
          s[i][j] = ok ? s[i][j] + fixed_max : -INFINITY;
        else
          s[i][j] = ok ? s[i][j] * scale : -INFINITY;
      }
      float shift = fixed_max;
      if (MODE == RUNNING_MAX) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        const float m_new = fmaxf(m_run[i], half_warp_max(mx));
        const float alpha = expf(m_run[i] - m_new);
        l_run[i] *= alpha;
#pragma unroll
        for (int j = 0; j < MAX_DJ; ++j) acc[i][j] *= alpha;
        m_run[i] = m_new;
        shift = m_new;
      }
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = MODE == EXP2_FOLD ? exp2f(s[i][j]) : expf(s[i][j] - shift);
        psum += p;
        Ps[(ty * 4 + i) * (BKV + 1) + tx + 16 * j] = to_f32(from_f32<T>(p));
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

template <typename T, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Skv, int D, float scale, float fixed_max,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)BH);
  flash_kernel<T, MODE><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, D, scale, fixed_max);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, Sq, D), k/v: (BH, Skv, D), o: (BH, Sq, D), all contiguous, D <= 160.
// dtype: 0 = float32, 1 = bfloat16. mode: 0 = running max, 1 = static shift
// fixed_max, 2 = exp2-folded (q pre-scaled by scale * log2 e, fixed_max
// holds the shift -FM * log2 e, scale is unused). Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int BH, int Sq, int Skv, int D,
                                   float scale, int mode, float fixed_max,
                                   int dtype, void* stream) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (D < 1 || D > 16 * MAX_DJ) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_LAUNCH(T)                                                              \
  switch (mode) {                                                                    \
    case RUNNING_MAX:                                                                \
      return launch<T, RUNNING_MAX>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s); \
    case FIXED_MAX:                                                                  \
      return launch<T, FIXED_MAX>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s);   \
    case EXP2_FOLD:                                                                  \
      return launch<T, EXP2_FOLD>(q, k, v, o, BH, Sq, Skv, D, scale, fixed_max, s);   \
    default:                                                                         \
      return (int)cudaErrorInvalidValue;                                             \
  }
  if (dtype == 0) { FLASH_LAUNCH(float) }
  if (dtype == 1) { FLASH_LAUNCH(__nv_bfloat16) }
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}
