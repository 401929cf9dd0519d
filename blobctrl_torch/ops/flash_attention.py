"""Flash attention: non-causal, unmasked softmax(q k^T * scale) v.

Counterpart of ``blobctrl_tpu/ops/flash_attention.py``. The CUDA kernel
(``csrc/flash_attention.cu``) replaces the Pallas ``_flash_kernel_fixed_max``
and, with ``fixed_max=None``, the running-max ``_flash_kernel``. It serves
the long self-attention of the double-width latent layout (8192 tokens at
the top level of a 512^2 edit), where the plain version materializes an
S x S fp32 score matrix in device memory.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from blobctrl_torch.ops import _build

MAX_HEAD_DIM = 160
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (bh, sq, skv, d, dtype, fixed) -> launches


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain version: fp32 scores and softmax, probabilities cast to the
    input dtype, then P @ V (the JAX package's ``_xla_sdpa_reference``).
    q: (BH, Sq, D); k, v: (BH, Skv, D)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    fixed_max: Optional[float] = 20.0) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Skv, D), contiguous, bf16 or fp32 ->
    (BH, Sq, D) in q's dtype, fp32 accumulation.

    fixed_max: a number selects the static softmax shift p = exp(s - FM),
    exact while the logits stay within (FM - 87, FM + 88); None selects the
    running row max with alpha-rescaling. CPU tensors take the plain version
    (exact softmax either way)."""
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must share one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes matching bf16 or fp32")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM or sq < 1 or skv < 1 or bh > 65535:
        raise ValueError(f"flash_attention: bh={bh}, sq={sq}, skv={skv}, "
                         f"d={d} outside the kernel's range "
                         f"(d <= {MAX_HEAD_DIM}, bh <= 65535)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    fn = _build.entry("flash_attention")
    out = torch.empty_like(q)
    fixed = fixed_max is not None
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, sq, skv, d, ctypes.c_float(scale), int(fixed),
            ctypes.c_float(fixed_max if fixed else 0.0), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", rc)
    launches += 1
    launch_shapes[(bh, sq, skv, d, str(q.dtype), fixed)] += 1
    return out
