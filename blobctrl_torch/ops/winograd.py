"""Winograd F(2x2, 3x3) stride-1 same conv with the optional GroupNorm+SiLU
prologue, for even H and W.

Counterpart of ``blobctrl_tpu/ops/winograd.py``. ``csrc/winograd.cu``
replaces the Pallas ``_winograd_kernel``: each 2x2 output tile comes from
a 4x4 input tile with 16 multiply-adds per (C, Co) pair instead of the
direct conv's 36. The input and output transforms run in fp32 inside the
kernel; V and M never go to device memory. The weights are transformed
once, outside the kernel (``transform_weights``); the pipeline keeps the
result beside each hot kernel (``BlobNetPipeline._conv_params``).

Transform matrices (interpolation points 0, 1, -1, inf):
  B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]   (input)
  G   = [[1,0,0],[.5,.5,.5],[.5,-.5,.5],[0,0,1]]       (weights, exact)
  A^T = [[1,1,1,0],[0,1,-1,-1]]                        (output)

bf16 runs on the tensor cores (the 16 products on mma.sync, the input halo
and the weight slices by cp.async), fp32 on the SIMT kernel; the C entry
point picks by dtype and reports which ran (``tc_launches``). Where a
bf16 conv's output blocks would leave SMs idle (fewer blocks than SMs, or
a short last wave), the wrapper splits C across more blocks
(``launch_config``) and the kernel sums the splits in fp32.

The JAX package splits the contraction in two halves summed in x's dtype
when its VMEM estimate passes 14 MiB; the port's kernel accumulates C in
fp32 throughout, so at full width in bf16 the two differ there by bf16
rounding.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from blobctrl_torch.ops import _build
from blobctrl_torch.ops._split import cdiv, split_k
from blobctrl_torch.ops.conv3x3 import _DTYPES, _epilogue_args, _prologue, _ptr

_GT = ((1.0, 0.5, 0.5, 0.0),
       (0.0, 0.5, -0.5, 0.0),
       (0.0, 0.5, 0.5, 1.0))  # G^T (3, 4)

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (b, h, w, c, co, dtype, prologue) -> launches
tc_launches = 0                            # of those, on the tensor-core kernel

# The bf16 kernel's block (csrc/winograd.cu): a PATCH_H x PATCH_W patch of
# 2x2 output tiles x BLOCK_N output channels, C in BLOCK_K-channel slices.
PATCH_H, PATCH_W, BLOCK_N, BLOCK_K = 4, 8, 64, 32
SMEM_BYTES = 223488   # its dynamic shared memory (the kernel's TC_SMEM)


def launch_config(b: int, h: int, w: int, c: int, co: int) -> dict:
    """The bf16 kernel's launch for an NHWC (b, h, w, c) -> co conv: the
    number of C splits (``_split.split_k``; one block fills an SM, its
    shared memory, so 160 blocks take two waves) and the grid (patches, Co
    blocks, splits)."""
    blocks = b * cdiv(h // 2, PATCH_H) * cdiv(w // 2, PATCH_W)
    n_blocks = cdiv(co, BLOCK_N)
    splits = split_k(blocks * n_blocks, cdiv(c, BLOCK_K))
    return {"splits": splits, "grid": (blocks, n_blocks, splits),
            "smem_bytes": SMEM_BYTES}


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Co) HWIO -> (16, C, Co) fp32 Winograd-domain weights U =
    G g G^T, U[4i + j] = sum_s G[j,s] (sum_r G[i,r] g[r,s]). Computed as the
    JAX package's einsum compiles: in fp32, the sum over r (kh) first, each
    three-term sum in order, so the result is bit-equal to its."""
    g = kernel.float()

    def contract(a, i):  # sum_r G^T[r, i] * a[r], in order, fp32
        return (_GT[0][i] * a[0] + _GT[1][i] * a[1]) + _GT[2][i] * a[2]
    rows = [contract(g, i) for i in range(4)]           # each (3, C, Co)
    u = torch.stack([contract(r, j) for r in rows for j in range(4)])
    return u.contiguous()


def _tile_transform(d: torch.Tensor) -> torch.Tensor:
    """B^T d B over the two tile axes (-2 rows, -1 columns) of fp32 d, rows
    first, in the kernel's order of the +/- sums."""
    def bt(r0, r1, r2, r3):
        return (r0 - r2, r1 + r2, r2 - r1, r1 - r3)
    t = torch.stack(bt(*d.unbind(-2)), -2)
    return torch.stack(bt(*t.unbind(-1)), -1)


def conv3x3_winograd_reference(x: torch.Tensor, u: torch.Tensor,
                               bias: Optional[torch.Tensor] = None,
                               scale: Optional[torch.Tensor] = None,
                               shift: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The plain version, with the kernel's roundings: the prologue rounded
    to x's dtype, zero padding, V = B^T d B in fp32 rounded to x's dtype, U
    in x's dtype, M = sum_c V U in fp32, Y = A^T M A + bias in fp32, cast to
    x's dtype. x: (B, H, W, C) NHWC with even H, W; u: (16, C, Co)."""
    b, h, w, c = x.shape
    if scale is not None:
        x = _prologue(x, scale, shift)
    dtype = x.dtype
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    # (B, H/2, W/2, C, 4, 4) overlapping 4x4 tiles at stride 2
    d = xp.unfold(1, 4, 2).unfold(2, 4, 2).float()
    v = _tile_transform(d).to(dtype).float()
    v = v.permute(4, 5, 0, 1, 2, 3).reshape(16, -1, c)
    m = torch.matmul(v, u.to(dtype).float())              # (16, tiles, Co)
    m = m.reshape(4, 4, b, h // 2, w // 2, -1)
    p0 = m[0] + m[1] + m[2]                               # A^T over rows
    p1 = m[1] - m[2] - m[3]
    bias32 = 0.0 if bias is None else bias.float()
    rows = []
    for p in (p0, p1):                                    # A over columns
        rows.append(torch.stack([p[0] + p[1] + p[2] + bias32,
                                 p[1] - p[2] - p[3] + bias32], 3))
    # rows[a][b, th, tw, bb, n] = out[b, 2 th + a, 2 tw + bb, n]
    y = torch.stack(rows, 2).reshape(b, h, w, -1)
    return y.to(dtype).contiguous()


def conv3x3_winograd(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Winograd F(2x2, 3x3) conv: the contract of ``conv3x3.conv3x3`` (NHWC
    x, HWIO kernel, optional silu(x * scale + shift) prologue) for even H
    and W; raises otherwise. u: the pre-transformed (16, C, Co) weights
    (``transform_weights``), computed here when absent, used in x's dtype.
    CPU tensors take the plain version. It has no backward (nor has the
    JAX package's): under grad it raises on either device."""
    global launches, tc_launches
    _build.refuse_grad("the Winograd conv (K12)",
                       "turn ops.conv3x3.set_winograd off",
                       x, kernel, bias, scale, shift, u)
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"conv3x3_winograd: x {tuple(x.shape)}; Winograd "
                         f"F(2x2, 3x3) takes NHWC with even H and W")
    if shift is not None and scale is None:
        raise ValueError("conv3x3_winograd: shift needs scale")
    if u is None:
        u = transform_weights(kernel)
    if u.dim() != 3 or u.shape[0] != 16 or u.shape[1] != x.shape[3]:
        raise ValueError(f"conv3x3_winograd: x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)}")
    if x.device.type == "cpu" and u.device.type == "cpu":
        return conv3x3_winograd_reference(x, u, bias, scale, shift)
    if not (x.is_cuda and u.device == x.device):
        raise ValueError("conv3x3_winograd: x and the weights must share one "
                         "CUDA device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv3x3_winograd: x dtype {x.dtype}; the kernel "
                         f"takes bf16 or fp32")
    if not x.is_contiguous():
        raise ValueError("conv3x3_winograd: x must be contiguous")
    b, h, wd, c = x.shape
    co = u.shape[2]
    if min(b, h, wd, c, co) < 1:
        raise ValueError(f"conv3x3_winograd: empty shape x {tuple(x.shape)}, "
                         f"u {tuple(u.shape)}")
    uw = u.to(x.dtype).contiguous()
    bias32, scale32, shift32 = _epilogue_args(x, co, bias, scale, shift)
    splits = (launch_config(b, h, wd, c, co)["splits"]
              if x.dtype == torch.bfloat16 else 1)
    ws = (torch.empty((splits, b, h, wd, co), device=x.device,
                      dtype=torch.float32) if splits > 1 else None)
    fn = _build.entry("winograd")
    out = torch.empty((b, h, wd, co), device=x.device, dtype=x.dtype)
    design = ctypes.c_int(-1)
    rc = fn(x.data_ptr(), uw.data_ptr(), bias32.data_ptr(), _ptr(scale32),
            _ptr(shift32), out.data_ptr(), b, h, wd, c, co, _DTYPES[x.dtype],
            splits, _ptr(ws), torch.cuda.current_stream(x.device).cuda_stream,
            ctypes.byref(design))
    _build.check("winograd", rc)
    launches += 1
    tc_launches += design.value == _build.DESIGN_TENSOR_CORES
    launch_shapes[(b, h, wd, c, co, str(x.dtype), scale is not None)] += 1
    return out


def transform_conv_tree(params, dtype):
    """``u`` (``transform_weights``, in ``dtype``) beside every (3, 3, C, Co)
    conv ``kernel`` with C >= 32 (the convs ``nn.resnet.route_conv`` can
    send to ``conv3x3``) of a param tree. Every other leaf is passed
    through as the same object."""
    def walk(p):
        if isinstance(p, dict):
            out = {k: walk(v) for k, v in p.items()}
            k = p.get("kernel")
            if (isinstance(k, torch.Tensor) and k.dim() == 4
                    and tuple(k.shape[:2]) == (3, 3) and k.shape[2] >= 32):
                out["u"] = transform_weights(k).to(dtype)
            return out
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        return p

    return walk(params)
