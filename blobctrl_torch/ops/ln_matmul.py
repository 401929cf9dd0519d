"""LayerNorm fused into the projection after it: LN(x; gamma, beta) @ W
[+ bias], the transformer block's pre-norm prologue.

Counterpart of ``blobctrl_tpu/ops/ln_matmul.py``. ``csrc/norm_matmul.cu``
(``ln_matmul_fwd``) replaces the Pallas ``_ln_matmul_kernel``: each block
reduces its rows' fp32 mean and two-pass variance over C, then normalizes
x as it loads it into the GEMM, so the normalized activation never goes to
device memory (one x read, one y write).
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from blobctrl_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (m, c, n, dtype) -> launches


def ln_matmul_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: Optional[torch.Tensor], w: torch.Tensor,
                        w_bias: Optional[torch.Tensor] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """The plain version: fp32 row mean and two-pass variance mean((x -
    mu)^2), ((x - mu) * rsqrt(var + eps)) * gamma + beta rounded to x's
    dtype, @ w (in x's dtype) in fp32, + w_bias, cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps) * gamma.float()
    if beta is not None:
        xn = xn + beta.float()
    y = torch.matmul(xn.to(x.dtype).float(), w.to(x.dtype).float())
    if w_bias is not None:
        y = y + w_bias.float()
    return y.to(x.dtype)


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor,
              beta: Optional[torch.Tensor], w: torch.Tensor,
              w_bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x; gamma, beta) @ w (+ w_bias). x: (..., C) contiguous,
    bf16 or fp32; gamma, beta (C,); w (C, N), cast to x's dtype; w_bias (N,)
    -> (..., N) in x's dtype. CPU tensors take the plain version."""
    global launches
    tensors = [a for a in (x, gamma, beta, w, w_bias) if a is not None]
    if all(a.device.type == "cpu" for a in tensors):
        return ln_matmul_reference(x, gamma, beta, w, w_bias, eps)
    if not (x.is_cuda and all(a.device == x.device for a in tensors)):
        raise ValueError("ln_matmul: every tensor must be on x's CUDA device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ln_matmul: x dtype {x.dtype}; the kernel takes "
                         f"bf16 or fp32")
    c = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != c or gamma.numel() != c or (
            beta is not None and beta.numel() != c):
        raise ValueError(f"ln_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, gamma {tuple(gamma.shape)}")
    if not x.is_contiguous():
        raise ValueError("ln_matmul: x must be contiguous")
    n = w.shape[1]
    m = x.numel() // max(c, 1)
    if min(m, c, n) < 1:
        raise ValueError(f"ln_matmul: empty shape x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    f32 = {"device": x.device, "dtype": torch.float32}
    wk = w.to(x.dtype).contiguous()
    bias32 = (torch.zeros(n, **f32) if w_bias is None
              else w_bias.to(**f32).reshape(n).contiguous())
    g32 = gamma.to(**f32).reshape(c).contiguous()
    b32 = (torch.zeros(c, **f32) if beta is None
           else beta.to(**f32).reshape(c).contiguous())
    fn = _build.entry("ln_matmul")
    out = torch.empty(x.shape[:-1] + (n,), device=x.device, dtype=x.dtype)
    rc = fn(x.data_ptr(), wk.data_ptr(), bias32.data_ptr(), g32.data_ptr(),
            b32.data_ptr(), out.data_ptr(), m, c, n, float(eps),
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ln_matmul", rc)
    launches += 1
    launch_shapes[(m, c, n, str(x.dtype))] += 1
    return out
