"""GroupNorm apply fused into a 1x1 projection: (x * s[b] + t[b]) @ W + bias
[+ residual], the Transformer2D ``proj_in`` prologue (and the ``proj_out``
residual epilogue).

Counterpart of ``blobctrl_tpu/ops/gn_matmul.py``. ``csrc/norm_matmul.cu``
(``affine_matmul_fwd``) replaces the Pallas ``_affine_matmul_kernel`` and
``_affine_matmul_res_kernel``: a GEMM over the M = B*H*W pixel rows whose
prologue applies the per-(batch, channel) affine as x is loaded, so the
normalized activation never goes to device memory. The GroupNorm
statistics stay outside the kernel, in plain torch (``gn_affine``), as they
stay in XLA in the JAX package, and use its one-pass variance.

bf16 runs on the tensor cores (the shared mainloop of
``csrc/gemm_bf16.cuh``: 128 x 256 output blocks, or 128 x 128 where the
columns are no multiple of 256; slices of x and of the weights streamed by
cp.async, x normalized once per element in shared memory, the products on
mma.sync), fp32 on the first, SIMT kernel; the C entry point picks by
dtype and reports which ran (``tc_launches``, ``res_tc_launches``). Where
the output blocks are fewer than the SMs, the wrapper splits C across more
blocks (``launch_config``) and a second kernel sums the splits in fp32 with
the bias and residual. What is left: wgmma with TMA.

Unlike the Pallas kernel, whose row-block fallback leaves rows unwritten
when h*w is no multiple of 8, the CUDA kernel masks ragged rows and is
right at any h*w.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from blobctrl_torch.ops import _build
from blobctrl_torch.ops._split import NUM_SMS, cdiv, split_k

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                               # kernel launches, plain epilogue
launch_shapes = collections.Counter()      # (b, hw, c, n, dtype, affine) -> launches
tc_launches = 0                            # of those, on the tensor-core kernel
res_launches = 0                           # the same for the residual epilogue
res_launch_shapes = collections.Counter()
res_tc_launches = 0

# The bf16 kernel's block (csrc/norm_matmul.cu, csrc/gemm_bf16.cuh), shared
# with ops.ln_matmul: BLOCK_M rows x WIDE_N columns where n % WIDE_N == 0,
# else x NARROW_N; each width with its K slice (channels) and the depth of
# its rings of x and weight slices: {block_n: (block_k, stages)}.
BLOCK_M, WIDE_N, NARROW_N = 128, 256, 128
SLICES = {WIDE_N: (64, 3), NARROW_N: (32, 4)}


def smem_bytes(block_n: int) -> int:
    """The kernel's tc_smem<BN>: per stage the x slice and the weight
    slice; then the rows' fp32 LayerNorm mean and rstd."""
    block_k, stages = SLICES[block_n]
    return (2 * stages * (BLOCK_M * (block_k + 8) + block_k * (block_n + 8))
            + 8 * BLOCK_M)


def launch_config(m: int, c: int, n: int) -> dict:
    """The bf16 kernel's launch for an (m, c) @ (c, n) product: the block's
    columns, the number of C splits and the grid (row blocks, column
    blocks, splits). C is split (``_split.split_k``) only where the blocks
    are fewer than the SMs: elsewhere the fp32 workspace's traffic (m x n x
    4 bytes written and read per split) outweighs a shorter last wave."""
    block_n = WIDE_N if n % WIDE_N == 0 else NARROW_N
    m_blocks, n_blocks = cdiv(m, BLOCK_M), cdiv(n, block_n)
    grid = m_blocks * n_blocks
    slices = cdiv(c, SLICES[block_n][0])
    splits = split_k(grid, slices) if grid < NUM_SMS else 1
    return {"block_n": block_n, "splits": splits,
            "grid": (m_blocks, n_blocks, splits),
            "smem_bytes": smem_bytes(block_n)}


def split_workspace(x: torch.Tensor, m: int, c: int, n: int):
    """-> (splits, the fp32 (splits, m, n) workspace or None) for a launch
    on x: bf16 takes ``launch_config``'s split, fp32 (SIMT) none."""
    splits = (launch_config(m, c, n)["splits"]
              if x.dtype == torch.bfloat16 else 1)
    ws = (torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
          if splits > 1 else None)
    return splits, ws


def gn_affine(x: torch.Tensor, norm_params, num_groups: int, eps: float):
    """Per-(batch, channel) fp32 (s, t), each (B, C), with GroupNorm(x) ==
    x * s[b] + t[b], computed as the JAX package's ``gn_affine`` does: fp32
    group mean and the one-pass variance E[x^2] - mean^2."""
    n, c = x.shape[0], x.shape[-1]
    g = num_groups
    xf = x.float().reshape(n, -1, g, c // g)
    mean = xf.mean(dim=(1, 3))                                   # (N, G)
    var = xf.square().mean(dim=(1, 3)) - mean.square()
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(c // g, dim=1)               # (N, C)
    rstd_c = rstd.repeat_interleave(c // g, dim=1)
    gamma = norm_params["scale"].float()[None]
    beta = norm_params["bias"].float()[None]
    s = rstd_c * gamma
    return s, beta - mean_c * rstd_c * gamma


def affine_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            s: Optional[torch.Tensor] = None,
                            t: Optional[torch.Tensor] = None,
                            residual: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain version: (x * s[b] + t[b]) in fp32 rounded to x's dtype
    (x itself without s), @ w (in x's dtype) in fp32, + bias [+ residual]
    in fp32, cast to x's dtype. x: (B, H, W, C); w: (C, N); s, t: (B, C)
    fp32; residual: (B, H, W, N)."""
    xn = x
    if s is not None:
        xn = (x.float() * s[:, None, None, :].float()
              + t[:, None, None, :].float()).to(x.dtype)
    y = torch.matmul(xn.float(), w.to(x.dtype).float())
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def affine_matmul(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  s: Optional[torch.Tensor] = None,
                  t: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x * s[b] + t[b]) @ w + bias [+ residual]. x: (B, H, W, C) NHWC, w:
    (C, N), residual (B, H, W, N), all contiguous and of one dtype (bf16 or
    fp32); bias (N,); s, t (B, C) fp32, both or neither -> (B, H, W, N).
    CPU tensors take the plain version. It has no backward (nor has the
    JAX package's): under grad it raises on either device."""
    global launches, res_launches, tc_launches, res_tc_launches
    _build.refuse_grad("the GroupNorm-affine matmul (K10)",
                       "turn nn.transformer_2d.set_gn_proj_fuse off", x, w,
                       bias, s, t, residual)
    if (s is None) != (t is None):
        raise ValueError("affine_matmul: s and t go together")
    others = [a for a in (w, bias, s, t, residual) if a is not None]
    if not x.is_cuda:
        if all(a.device.type == "cpu" for a in others):
            return affine_matmul_reference(x, w, bias, s, t, residual)
        raise ValueError("affine_matmul: every tensor must be on x's CUDA "
                         "device")
    dev = x.device
    if any(a.device != dev for a in others):
        raise ValueError("affine_matmul: every tensor must be on x's CUDA "
                         "device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or (
            residual is not None and residual.dtype != x.dtype):
        raise ValueError(f"affine_matmul: dtypes x {x.dtype}, w {w.dtype}"
                         f"{'' if residual is None else f', residual {residual.dtype}'}"
                         f"; the kernel takes one dtype, bf16 or fp32")
    if x.dim() != 4 or w.dim() != 2 or w.shape[0] != x.shape[3]:
        raise ValueError(f"affine_matmul: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    b, h, wd, c = x.shape
    n = w.shape[1]
    if residual is not None and tuple(residual.shape) != (b, h, wd, n):
        raise ValueError(f"affine_matmul: residual {tuple(residual.shape)}, "
                         f"want {(b, h, wd, n)}")
    if s is not None and (tuple(s.shape) != (b, c) or tuple(t.shape) != (b, c)):
        raise ValueError(f"affine_matmul: s {tuple(s.shape)}, t "
                         f"{tuple(t.shape)}, want {(b, c)}")
    if not all(a.is_contiguous() for a in (x, w) + (
            () if residual is None else (residual,))):
        raise ValueError("affine_matmul: x, w and residual must be "
                         "contiguous")
    if min(b, h, wd, c, n) < 1:
        raise ValueError(f"affine_matmul: empty shape x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    bias32 = (torch.zeros(n, device=dev) if bias is None
              else _build.as_f32(bias, dev, n))
    s32 = None if s is None else _build.as_f32(s, dev, b, c)
    t32 = None if t is None else _build.as_f32(t, dev, b, c)
    splits, ws = split_workspace(x, b * h * wd, c, n)
    fn = _build.entry("affine_matmul")
    out = torch.empty((b, h, wd, n), device=dev, dtype=x.dtype)
    design = ctypes.c_int(-1)
    rc = fn(x.data_ptr(), w.data_ptr(), bias32.data_ptr(), _ptr(s32),
            _ptr(t32), _ptr(residual), out.data_ptr(), b * h * wd, h * wd, c,
            n, _DTYPES[x.dtype], splits, _ptr(ws), _build.stream(dev),
            ctypes.byref(design))
    _build.check("affine_matmul", rc)
    key = (b, h * wd, c, n, str(x.dtype), s is not None)
    tc = design.value == _build.DESIGN_TENSOR_CORES
    if residual is None:
        launches += 1
        tc_launches += tc
        launch_shapes[key] += 1
    else:
        res_launches += 1
        res_tc_launches += tc
        res_launch_shapes[key] += 1
    return out


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel_2d(x: torch.Tensor, conv_params) -> torch.Tensor:
    """The 1x1 conv kernel (1, 1, C, N) as a contiguous (C, N) in x's
    dtype."""
    return conv_params["kernel"].reshape(x.shape[-1], -1).to(
        x.dtype).contiguous()


def gn_proj(x: torch.Tensor, norm_params, conv_params, groups: int = 32,
            eps: float = 1e-6,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm(x; norm_params) @ 1x1 conv (+ bias) [+ residual]. x: (B, H,
    W, C) NHWC; conv_params: {"kernel": (1, 1, C, N), "bias": (N,)}."""
    s, t = gn_affine(x, norm_params, groups, eps)
    return affine_matmul(x, _kernel_2d(x, conv_params),
                         conv_params.get("bias"), s, t, residual)


def matmul_residual(x: torch.Tensor, conv_params,
                    residual: torch.Tensor) -> torch.Tensor:
    """x @ 1x1 conv (+ bias) + residual: the same kernel without the
    affine prologue."""
    return affine_matmul(x, _kernel_2d(x, conv_params),
                         conv_params.get("bias"), residual=residual)
