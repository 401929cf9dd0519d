// Gaussian blob splatting with back-to-front alpha compositing, for NVIDIA
// Hopper (sm_90a). fp32 throughout.
//
// Replaces: blobctrl_tpu/ops/blob_splat.py `_splat_kernel` (`:31`), reached
// through `splat_scores_pallas` (`:79`) and `splat_scores_auto` (`:123`),
// which the blob view of the interactive session calls (blob/viz.py).
//
// What it computes, per image n, pixel (row, col) and blob k < M, from the
// parameter rows p[n][k] = [cx*W, cy*H, d/det, -(b+c)/det, a/det, gate, 0, 0]
// that the wrapper builds (ops/blob_splat.py, as the JAX package builds them
// in XLA):
//   dx = (col - p0) * (1/W),  dy = (row - p1) * (1/H)
//   d2 = p2*dx*dx + p3*dx*dy + p4*dy*dy
//   s_k = min(2 * sigmoid(-d2), 1), or 1e-6 where the gate p5 < 0.5
// then, back to front, out[k+1] = s_k * prod_{j>k} (1 - s_j) and the
// background out[0] = prod_j (1 - s_j). The output is channels-last
// (N, H, W, M+1), the layout the callers read, so no transpose follows.
//
// What bounds it on the H100: it reads 32*M bytes of parameters per image
// and writes 4*(M+1) bytes per pixel; about 20 flops per pixel and blob, so
// the output bytes bound it (N*H*W*(M+1)*4 bytes at 3.35 TB/s).
//
// What the design does about it: one thread per output pixel, the image's
// M parameter rows staged in shared memory (read from global memory where
// they do not fit), and the scores computed back to front on the fly: the
// composite needs s_k only in that order, so each thread keeps one running
// tail in a register and writes each channel once. No M x H x W scratch
// exists (the TPU kernel's VMEM scratch is a tiling artifact of its
// blocks). Any H and W. Every operation rounds as the plain version does
// (explicit _rn intrinsics, so nothing contracts into an FMA; expf and a
// true division), so the two agree to fp32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads (pixels) per block
constexpr int SMEM_ROWS = 1024;    // parameter rows staged in shared memory

__global__ void __launch_bounds__(NT)
splat_kernel(const float* __restrict__ params, float* __restrict__ out,
             int M, int H, int W, float inv_w, float inv_h) {
  __shared__ float sp[SMEM_ROWS * 8];
  const int n = blockIdx.y;
  const float* gp = params + (int64_t)n * M * 8;
  const bool staged = M <= SMEM_ROWS;
  if (staged) {
    for (int i = threadIdx.x; i < M * 8; i += NT) sp[i] = gp[i];
    __syncthreads();
  }
  const float* p = staged ? sp : gp;

  const int64_t pix = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (pix >= (int64_t)H * W) return;
  const float row = (float)(int)(pix / W);
  const float col = (float)(int)(pix % W);
  float* o = out + ((int64_t)n * H * W + pix) * (M + 1);

  float tail = 1.0f;
  for (int k = M - 1; k >= 0; --k) {
    const float* r = p + k * 8;
    const float dx = __fmul_rn(__fsub_rn(col, r[0]), inv_w);
    const float dy = __fmul_rn(__fsub_rn(row, r[1]), inv_h);
    const float t0 = __fmul_rn(__fmul_rn(r[2], dx), dx);
    const float t1 = __fmul_rn(__fmul_rn(r[3], dx), dy);
    const float t2 = __fmul_rn(__fmul_rn(r[4], dy), dy);
    const float d2 = __fadd_rn(__fadd_rn(t0, t1), t2);
    float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(d2)));
    s = fminf(__fmul_rn(s, 2.0f), 1.0f);
    if (r[5] < 0.5f) s = 1e-6f;
    o[k + 1] = __fmul_rn(s, tail);
    tail = __fmul_rn(tail, __fsub_rn(1.0f, s));
  }
  o[0] = tail;
}

}  // namespace

// params: (N, M, 8) fp32 rows; out: (N, H, W, M+1) fp32. inv_w and inv_h
// are 1/W and 1/H rounded to fp32 by the caller. Returns a cudaError_t.
extern "C" int blob_splat_fwd(const void* params, void* out, int N, int M,
                              int H, int W, float inv_w, float inv_h,
                              void* stream) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (N < 1 || M < 1 || H < 1 || W < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((int64_t)H * W + NT - 1) / NT;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)N);
  splat_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)params, (float*)out, M, H, W, inv_w, inv_h);
  return (int)cudaGetLastError();
}
