// Gaussian blob splatting with back-to-front alpha compositing, for NVIDIA
// Hopper (sm_90a). fp32 arithmetic; one launch per call in every mode.
//
// Replaces: blobctrl_tpu/ops/blob_splat.py `_splat_kernel` (`:31`), reached
// through `splat_scores_pallas` (`:79`) and `splat_scores_auto` (`:123`),
// which the blob view of the interactive session calls (blob/viz.py), and,
// in the view mode, the colouring and uint8 conversion that the JAX
// package's `blob_vis_image` runs after it (blobctrl_tpu/blob/viz.py:69-82).
//
// What it computes, per image n, pixel (row, col) and blob k < M. The
// parameter row of blob k, from the raw inputs (x, y, the 2x2 covariance
// [[a, b], [c, d]] and the size), operation for operation as
// ops/blob_splat.py `splat_params` computes it:
//   det = a*d - b*c,  p = [x*W, y*H, d/det, -(b+c)/det, a/det, size >= 0.5]
// then
//   dx = (col - p0) * (1/W),  dy = (row - p1) * (1/H)
//   d2 = p2*dx*dx + p3*dx*dy + p4*dy*dy
//   s_k = min(2 / (1 + exp(d2)), 1), or 1e-6 where the gate p5 < 0.5
// and, back to front, out[k+1] = s_k * prod_{j>k} (1 - s_j), the background
// out[0] = prod_j (1 - s_j). Modes:
//   SCORES  (N, H, W, M+1) fp32, channels-last, the layout the callers read;
//           the rows computed from the raw inputs, or read from (N, M, 8)
//           rows in device memory (`splat_from_params`);
//   VIEW    image 0 only: the colour sum over channels M, M-1, ..., 0 of
//           out[c] * colors[c] (M+1, 3), clamped to [0, 1], times 255 and
//           truncated to uint8 (H, W, 3): the blob view, with no score map
//           or float image in device memory;
//   ROWS    the (N, M, 8) rows alone, [p0..p5, 0, 0], to check them.
// Every operation rounds as the plain versions do (explicit _rn intrinsics,
// so nothing contracts into an FMA; the accurate expf and true divisions),
// so the kernel and its plain versions on the card agree bit for bit.
//
// What bounds it on the H100: at the session's view (1, 512, 512, M = 1)
// the device work is tiny (2 MB of scores, 0.63 us at 3.35 TB/s; the view
// writes 0.75 MB, 0.23 us), so launch latency and the wrapper's host time,
// not bytes, set the pace. At larger N*H*W*(M+1) the output bytes bound it
// (about 20 flops a pixel and blob against 4 bytes a channel written).
//
// What the design does about it: the whole call is one launch with one
// output allocation; the parameter rows are computed in each block's
// prologue (a few divisions per blob, against the plain torch ops that
// built them before), the palette is read in the kernel, and the view's
// epilogue (colour sum, clamp, x255, uint8) is fused in, so the host gets
// 3 bytes a pixel and does no pass of its own. One thread per pixel keeps
// one running tail in a register (the composite needs s_k only back to
// front); the block stages its pixels' channels in shared memory and
// writes them out as contiguous 16-byte stores, where a thread storing its
// own M+1 channels would scatter 4-byte stores M+1 floats apart. Blobs go
// through shared memory CH channels at a time (the rows, the palette and
// the staged outputs of one chunk), so any M takes the same single launch;
// with M+1 > CH a chunk's outputs are runs of CH floats, stored coalesced.
// No M x H x W scratch exists (the TPU kernel's VMEM scratch is a tiling
// artifact of its blocks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads a block, one output pixel each
constexpr int CH = 32;    // channels staged in shared memory at a time
constexpr int SMEM_HEAD = CH * 8 + CH * 3;  // floats of rows and palette

enum Mode { SCORES = 0, VIEW = 1, ROWS = 2 };

struct Raw {               // the raw inputs, each contiguous fp32
  const float* xs;         // (N, M)
  const float* ys;         // (N, M)
  const float* covs;       // (N, M, 2, 2)
  const float* sizes;      // (N, M)
};

// The parameter row of blob i = n*M + k, as `splat_params` computes it.
__device__ __forceinline__ void make_row(const Raw& in, int64_t i, float w,
                                         float h, float* r) {
  const float* cv = in.covs + i * 4;
  const float a = cv[0], b = cv[1], c = cv[2], d = cv[3];
  const float det = __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, c));
  r[0] = __fmul_rn(in.xs[i], w);
  r[1] = __fmul_rn(in.ys[i], h);
  r[2] = __fdiv_rn(d, det);
  r[3] = __fdiv_rn(-__fadd_rn(b, c), det);
  r[4] = __fdiv_rn(a, det);
  r[5] = in.sizes[i] >= 0.5f ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(NT)
rows_kernel(Raw in, float* __restrict__ rows, int64_t count, float w,
            float h) {
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i >= count) return;
  float r[8];
  make_row(in, i, w, h, r);
  r[6] = r[7] = 0.0f;
  for (int j = 0; j < 8; ++j) rows[i * 8 + j] = r[j];
}

// One block: NT consecutive pixels of image blockIdx.y (row-major). Every
// thread reaches every barrier; threads past the image's last pixel only
// help to stage and store.
template <int MODE, bool RAW>
__global__ void __launch_bounds__(NT)
splat_kernel(Raw in, const float* __restrict__ prows,
             const float* __restrict__ colors, void* __restrict__ out, int M,
             int H, int W, float inv_w, float inv_h) {
  extern __shared__ __align__(16) float smem[];
  float* srow = smem;                 // CH rows of 8
  float* spal = smem + CH * 8;        // CH colours of 3 (VIEW)
  float* stage = smem + SMEM_HEAD;    // SCORES: NT x S floats; VIEW: NT x 3 B

  const int n = blockIdx.y;
  const int hw = H * W;
  const int pix0 = blockIdx.x * NT;
  const int np = min(NT, hw - pix0);  // pixels of this block
  const int t = threadIdx.x;
  const bool live = t < np;
  const int pix = pix0 + t;
  const float row = (float)(live ? pix / W : 0);
  const float col = (float)(live ? pix % W : 0);
  const int M1 = M + 1;
  const int S = min(M1, CH) | 1;      // stage stride: odd, so no bank conflict
  const float wf = (float)W, hf = (float)H;

  float tail = 1.0f, acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int c0 = (M1 - 1) / CH * CH; c0 >= 0; c0 -= CH) {  // back to front
    const int c1 = min(c0 + CH, M1), cw = c1 - c0, cb = max(c0, 1);
    __syncthreads();                  // the last chunk's smem is free again
    for (int c = cb + t; c < c1; c += NT) {   // blob c-1 -> channel c
      float* r = srow + (c - c0) * 8;
      const int64_t i = (int64_t)n * M + (c - 1);
      if (RAW) {
        make_row(in, i, wf, hf, r);
      } else {
        for (int j = 0; j < 6; ++j) r[j] = prows[i * 8 + j];
      }
    }
    if (MODE == VIEW)
      for (int e = t; e < cw * 3; e += NT) spal[e] = colors[c0 * 3 + e];
    __syncthreads();

    if (live) {
      for (int c = c1 - 1; c >= c0; --c) {
        float v;
        if (c > 0) {
          const float* r = srow + (c - c0) * 8;
          const float dx = __fmul_rn(__fsub_rn(col, r[0]), inv_w);
          const float dy = __fmul_rn(__fsub_rn(row, r[1]), inv_h);
          const float t0 = __fmul_rn(__fmul_rn(r[2], dx), dx);
          const float t1 = __fmul_rn(__fmul_rn(r[3], dx), dy);
          const float t2 = __fmul_rn(__fmul_rn(r[4], dy), dy);
          const float d2 = __fadd_rn(__fadd_rn(t0, t1), t2);
          float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(d2)));
          s = fminf(__fmul_rn(s, 2.0f), 1.0f);
          if (r[5] < 0.5f) s = 1e-6f;
          v = __fmul_rn(s, tail);
          tail = __fmul_rn(tail, __fsub_rn(1.0f, s));
        } else {
          v = tail;                   // the background
        }
        if (MODE == SCORES) {
          stage[t * S + (c - c0)] = v;
        } else {
          const float* p = spal + (c - c0) * 3;
          acc0 = __fadd_rn(acc0, __fmul_rn(v, p[0]));
          acc1 = __fadd_rn(acc1, __fmul_rn(v, p[1]));
          acc2 = __fadd_rn(acc2, __fmul_rn(v, p[2]));
        }
      }
    }

    if (MODE == SCORES) {             // store the chunk's channels
      __syncthreads();
      float* o = static_cast<float*>(out);
      const int total = np * cw;
      if (cw == M1) {                 // the block's outputs are contiguous
        const int64_t base = ((int64_t)n * hw + pix0) * M1;
        const int head = min(total, (int)((4 - (base & 3)) & 3));
        const int nvec = (total - head) / 4;
        for (int e = t; e < head; e += NT)
          o[base + e] = stage[e / M1 * S + e % M1];
        float4* o4 = reinterpret_cast<float4*>(o + base + head);
        for (int v = t; v < nvec; v += NT) {
          const int e = head + 4 * v;
          int p = e / M1, c = e - p * M1;
          float q[4];
          for (int j = 0; j < 4; ++j) {
            q[j] = stage[p * S + c];
            if (++c == M1) { c = 0; ++p; }
          }
          o4[v] = make_float4(q[0], q[1], q[2], q[3]);
        }
        for (int e = head + 4 * nvec + t; e < total; e += NT)
          o[base + e] = stage[e / M1 * S + e % M1];
      } else {                        // runs of cw floats, one a pixel
        for (int e = t; e < total; e += NT) {
          const int p = e / cw, c = e - p * cw;
          o[((int64_t)n * hw + pix0 + p) * M1 + c0 + c] = stage[p * S + c];
        }
      }
    }
  }

  if (MODE == VIEW) {                 // clamp, x255, truncate; 16-byte stores
    uint8_t* s8 = reinterpret_cast<uint8_t*>(stage);
    if (live) {
      const float a[3] = {acc0, acc1, acc2};
      for (int j = 0; j < 3; ++j) {
        const float v = fminf(fmaxf(a[j], 0.0f), 1.0f);
        s8[t * 3 + j] = (uint8_t)__float2uint_rz(__fmul_rn(v, 255.0f));
      }
    }
    __syncthreads();
    uint8_t* o = static_cast<uint8_t*>(out) + (int64_t)pix0 * 3;  // 16-aligned
    const int bytes = np * 3, nvec = bytes / 16;
    for (int v = t; v < nvec; v += NT)
      reinterpret_cast<uint4*>(o)[v] = reinterpret_cast<const uint4*>(s8)[v];
    for (int e = nvec * 16 + t; e < bytes; e += NT) o[e] = s8[e];
  }
}

template <int MODE, bool RAW>
int launch(const Raw& in, const float* rows, const float* colors, void* out,
           int N, int M, int H, int W, float inv_w, float inv_h,
           cudaStream_t stream) {
  const int blocks = (H * W + NT - 1) / NT;
  const int stage = MODE == SCORES ? NT * (min(M + 1, CH) | 1) * 4 : NT * 3;
  const size_t smem = SMEM_HEAD * 4 + stage;
  splat_kernel<MODE, RAW><<<dim3(blocks, N), NT, smem, stream>>>(
      in, rows, colors, out, M, H, W, inv_w, inv_h);
  return (int)cudaGetLastError();
}

}  // namespace

// xs, ys, sizes: (N, M), covs: (N, M, 2, 2) fp32, the raw inputs, or all
// null with rows: (N, M, 8) fp32 parameter rows (SCORES only). colors:
// (M+1, 3) fp32 (VIEW only). out: (N, H, W, M+1) fp32 (SCORES), (H, W, 3)
// uint8 of image 0 (VIEW, N = 1), (N, M, 8) fp32 (ROWS). inv_w and inv_h
// are 1/W and 1/H rounded to fp32 by the caller. Returns a cudaError_t.
extern "C" int blob_splat_fwd(const void* xs, const void* ys,
                              const void* covs, const void* sizes,
                              const void* rows, const void* colors, void* out,
                              int N, int M, int H, int W, float inv_w,
                              float inv_h, int mode, void* stream) {
  cudaGetLastError();  // clear any earlier error so the return is ours
  if (N < 1 || M < 1 || H < 1 || W < 1 || N > 65535
      || (int64_t)H * W > 2147483647LL - NT)
    return (int)cudaErrorInvalidValue;
  const Raw in{(const float*)xs, (const float*)ys, (const float*)covs,
               (const float*)sizes};
  const bool raw = rows == nullptr;
  if (raw && (!xs || !ys || !covs || !sizes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rows;
  const float* c = (const float*)colors;
  switch (mode) {
    case SCORES:
      return raw ? launch<SCORES, true>(in, r, c, out, N, M, H, W, inv_w,
                                        inv_h, s)
                 : launch<SCORES, false>(in, r, c, out, N, M, H, W, inv_w,
                                         inv_h, s);
    case VIEW:
      if (!raw || !colors || N != 1) return (int)cudaErrorInvalidValue;
      return launch<VIEW, true>(in, r, c, out, N, M, H, W, inv_w, inv_h, s);
    case ROWS: {
      if (!raw) return (int)cudaErrorInvalidValue;
      const int64_t count = (int64_t)N * M;
      rows_kernel<<<(unsigned)((count + NT - 1) / NT), NT, 0, s>>>(
          in, (float*)out, count, (float)W, (float)H);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
