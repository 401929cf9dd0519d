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

Unlike the Pallas kernel, whose row-block fallback leaves rows unwritten
when h*w is no multiple of 8, the CUDA kernel masks ragged rows and is
right at any h*w.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from blobctrl_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                               # kernel launches, plain epilogue
launch_shapes = collections.Counter()      # (b, hw, c, n, dtype, affine) -> launches
res_launches = 0                           # the same for the residual epilogue
res_launch_shapes = collections.Counter()


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
    CPU tensors take the plain version."""
    global launches, res_launches
    if (s is None) != (t is None):
        raise ValueError("affine_matmul: s and t go together")
    tensors = [a for a in (x, w, bias, s, t, residual) if a is not None]
    if all(a.device.type == "cpu" for a in tensors):
        return affine_matmul_reference(x, w, bias, s, t, residual)
    if not (x.is_cuda and all(a.device == x.device for a in tensors)):
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
    f32 = {"device": x.device, "dtype": torch.float32}
    bias32 = (torch.zeros(n, **f32) if bias is None
              else bias.to(**f32).reshape(n).contiguous())
    s32 = None if s is None else s.to(**f32).contiguous()
    t32 = None if t is None else t.to(**f32).contiguous()
    fn = _build.entry("affine_matmul")
    out = torch.empty((b, h, wd, n), device=x.device, dtype=x.dtype)
    rc = fn(x.data_ptr(), w.data_ptr(), bias32.data_ptr(), _ptr(s32),
            _ptr(t32), _ptr(residual), out.data_ptr(), b * h * wd, h * wd, c,
            n, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("affine_matmul", rc)
    key = (b, h * wd, c, n, str(x.dtype), s is not None)
    if residual is None:
        launches += 1
        launch_shapes[key] += 1
    else:
        res_launches += 1
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
