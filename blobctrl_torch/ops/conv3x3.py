"""3x3 stride-1 same conv with an optional fused GroupNorm+SiLU prologue.

Counterpart of ``blobctrl_tpu/ops/conv3x3.py``. The CUDA kernel
(``csrc/conv3x3.cu``) replaces the Pallas ``_conv3x3_kernel_halo`` (and its
"views3" twin ``_conv3x3_kernel``, the same function): an implicit GEMM with
M = B*H*W, N = Co, K = 9*C, fp32 accumulation, bias in the epilogue, and
``silu(x * scale[b, c] + shift[b, c])`` applied as x is loaded, before the
zero padding (taps outside the image contribute 0, not silu(shift)).
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F

from blobctrl_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (b, h, w, c, co, dtype, prologue) -> launches


def _per_batch(t: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(C,) or (B, C) -> contiguous fp32 (B, C)."""
    return t.float().expand(b, c).contiguous()


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version (the JAX package's ``_xla_reference``): the
    prologue in fp32, cast to x's dtype, zero padding, then the conv in fp32
    plus bias, cast back. x: (B, H, W, C) NHWC; w: (3, 3, C, Co) HWIO."""
    b, _, _, c = x.shape
    dtype = x.dtype
    if scale is not None:
        xf = x.float() * _per_batch(scale, b, c)[:, None, None, :]
        if shift is not None:
            xf = xf + _per_batch(shift, b, c)[:, None, None, :]
        x = F.silu(xf).to(dtype)
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   w.float().permute(3, 2, 0, 1), padding=1)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, H, W, C) NHWC, w: (3, 3, C, Co) HWIO, both contiguous and of
    one dtype (bf16 or fp32); bias (Co,); scale/shift (B, C) or (C,) ->
    (B, H, W, Co). CPU tensors take the plain version."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_reference(x, w, bias, scale, shift)
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("conv3x3: x and w must share one CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"conv3x3: dtypes x {x.dtype}, w {w.dtype}; the "
                         f"kernel takes matching bf16 or fp32")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3,
                                                               x.shape[3]):
        raise ValueError(f"conv3x3: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous")
    if shift is not None and scale is None:
        raise ValueError("conv3x3: shift needs scale")
    b, h, wd, c = x.shape
    co = w.shape[3]
    if min(b, h, wd, c, co) < 1:
        raise ValueError(f"conv3x3: empty shape x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    aux = {"device": x.device, "dtype": torch.float32}
    bias32 = (torch.zeros(co, **aux) if bias is None
              else bias.to(**aux).reshape(co).contiguous())
    if scale is not None:
        scale32 = _per_batch(scale.to(x.device), b, c)
        shift32 = (torch.zeros(b, c, **aux) if shift is None
                   else _per_batch(shift.to(x.device), b, c))
    fn = _build.entry("conv3x3")
    out = torch.empty((b, h, wd, co), device=x.device, dtype=x.dtype)
    rc = fn(x.data_ptr(), w.data_ptr(), bias32.data_ptr(),
            scale32.data_ptr() if scale is not None else None,
            shift32.data_ptr() if scale is not None else None,
            out.data_ptr(), b, h, wd, c, co, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("conv3x3", rc)
    launches += 1
    launch_shapes[(b, h, wd, c, co, str(x.dtype), scale is not None)] += 1
    return out
