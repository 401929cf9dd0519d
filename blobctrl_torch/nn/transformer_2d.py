"""Spatial transformer (counterpart of ``blobctrl_tpu/nn/transformer_2d.py``):
GroupNorm(eps 1e-6) -> 1x1 proj_in -> transformer blocks over the HW tokens
-> 1x1 proj_out -> residual. NHWC makes the token reshuffles plain
reshapes. With ``set_gn_proj_fuse(True)`` the GroupNorm -> proj_in pair goes
through ``ops.gn_matmul.gn_proj`` (the GroupNorm apply as the projection's
prologue); proj_out + residual stay as they are, as in the JAX package."""

from __future__ import annotations

from typing import Optional

import torch

from blobctrl_torch.nn import attention, layers
from blobctrl_torch.ops import gn_matmul

# GroupNorm -> proj_in through the fused kernel; off by default, as in the
# JAX package.
_GN_PROJ_FUSE = False


def set_gn_proj_fuse(flag: bool):
    global _GN_PROJ_FUSE
    _GN_PROJ_FUSE = bool(flag)


def gn_proj_fuse_enabled() -> bool:
    return _GN_PROJ_FUSE


def init_transformer_2d(init: layers.ParamInit, channels: int,
                        num_layers: int, cross_dim: Optional[int]):
    """``num_layers + 2`` children: proj_in, each block, proj_out."""
    keys = init.split(num_layers + 2)
    return {
        "norm": layers.init_norm(init, channels),
        "proj_in": layers.init_conv(keys[0], 1, 1, channels, channels),
        "blocks": [attention.init_transformer_block(keys[i + 1], channels,
                                                    cross_dim)
                   for i in range(num_layers)],
        "proj_out": layers.init_conv(keys[-1], 1, 1, channels, channels),
    }


def transformer_2d(params, x: torch.Tensor, heads: int,
                   context: Optional[torch.Tensor] = None,
                   norm_groups: int = 32) -> torch.Tensor:
    n, h, w, c = x.shape
    residual = x
    if _GN_PROJ_FUSE:
        x = gn_matmul.gn_proj(x, params["norm"], params["proj_in"],
                              groups=norm_groups, eps=1e-6)
    else:
        x = layers.group_norm(params["norm"], x, norm_groups, eps=1e-6)
        x = layers.conv2d(params["proj_in"], x)
    x = x.reshape(n, h * w, c)
    for block in params["blocks"]:
        x = attention.transformer_block(block, x, heads, context=context)
    x = layers.conv2d(params["proj_out"], x.reshape(n, h, w, c))
    return x + residual
