"""Spatial transformer (counterpart of ``blobctrl_tpu/nn/transformer_2d.py``):
GroupNorm(eps 1e-6) -> 1x1 proj_in -> transformer blocks over the HW tokens
-> 1x1 proj_out -> residual. NHWC makes the token reshuffles plain
reshapes."""

from __future__ import annotations

from typing import Optional

import torch

from blobctrl_torch.nn import attention, layers


def init_transformer_2d(init: layers.ParamInit, channels: int,
                        num_layers: int, cross_dim: Optional[int]):
    return {
        "norm": layers.init_norm(init, channels),
        "proj_in": layers.init_conv(init, 1, 1, channels, channels),
        "blocks": [attention.init_transformer_block(init, channels, cross_dim)
                   for _ in range(num_layers)],
        "proj_out": layers.init_conv(init, 1, 1, channels, channels),
    }


def transformer_2d(params, x: torch.Tensor, heads: int,
                   context: Optional[torch.Tensor] = None,
                   norm_groups: int = 32) -> torch.Tensor:
    n, h, w, c = x.shape
    residual = x
    x = layers.group_norm(params["norm"], x, norm_groups, eps=1e-6)
    x = layers.conv2d(params["proj_in"], x).reshape(n, h * w, c)
    for block in params["blocks"]:
        x = attention.transformer_block(block, x, heads, context=context)
    x = layers.conv2d(params["proj_out"], x.reshape(n, h, w, c))
    return x + residual
