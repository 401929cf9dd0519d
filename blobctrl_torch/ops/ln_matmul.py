"""LayerNorm fused into the projection after it: LN(x; gamma, beta) @ W
[+ bias], the transformer block's pre-norm prologue.

Counterpart of ``blobctrl_tpu/ops/ln_matmul.py``. ``csrc/norm_matmul.cu``
(``ln_matmul_fwd``) replaces the Pallas ``_ln_matmul_kernel``: from each
row's fp32 mean and two-pass variance over C it normalizes x as it loads it
into the GEMM, so the normalized activation never goes to device memory.

bf16 runs on the tensor cores: a small kernel first writes each row's mean
and rstd once (an fp32 (M, 2) workspace; the TPU kernel likewise normalizes
once per row block, its SIMT predecessor here once per 64-column block),
then the GEMM of ``ops.gn_matmul`` (the shared mainloop of
``csrc/gemm_bf16.cuh``, its block and split: ``gn_matmul.launch_config``)
applies the LayerNorm once per loaded element. fp32 runs on the first,
SIMT kernel, whose blocks reduce their own rows' statistics. The C entry
point picks by dtype and reports which ran (``tc_launches``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from blobctrl_torch.ops import _build
from blobctrl_torch.ops.gn_matmul import _ptr, split_workspace

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (m, c, n, dtype) -> launches
tc_launches = 0                            # of those, on the tensor-core kernel


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
    -> (..., N) in x's dtype. CPU tensors take the plain version. It has no
    backward (nor has the JAX package's): under grad it raises on either
    device."""
    global launches, tc_launches
    _build.refuse_grad("the LayerNorm matmul (K11)",
                       "turn nn.attention.set_ln_matmul_fuse off", x, gamma,
                       beta, w, w_bias)
    others = [a for a in (gamma, beta, w, w_bias) if a is not None]
    if not x.is_cuda:
        if all(a.device.type == "cpu" for a in others):
            return ln_matmul_reference(x, gamma, beta, w, w_bias, eps)
        raise ValueError("ln_matmul: every tensor must be on x's CUDA device")
    dev = x.device
    if any(a.device != dev for a in others):
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
    wk = w.to(x.dtype).contiguous()
    bias32 = (torch.zeros(n, device=dev) if w_bias is None
              else _build.as_f32(w_bias, dev, n))
    g32 = _build.as_f32(gamma, dev, c)
    b32 = (torch.zeros(c, device=dev) if beta is None
           else _build.as_f32(beta, dev, c))
    splits, ws = split_workspace(x, m, c, n)
    stats = (torch.empty((m, 2), device=dev, dtype=torch.float32)
             if x.dtype == torch.bfloat16 else None)
    fn = _build.entry("ln_matmul")
    out = torch.empty(x.shape[:-1] + (n,), device=dev, dtype=x.dtype)
    design = ctypes.c_int(-1)
    rc = fn(x.data_ptr(), wk.data_ptr(), bias32.data_ptr(), g32.data_ptr(),
            b32.data_ptr(), out.data_ptr(), m, c, n, float(eps),
            _DTYPES[x.dtype], splits, _ptr(ws), _ptr(stats),
            _build.stream(dev), ctypes.byref(design))
    _build.check("ln_matmul", rc)
    launches += 1
    tc_launches += design.value == _build.DESIGN_TENSOR_CORES
    launch_shapes[(m, c, n, str(x.dtype))] += 1
    return out
