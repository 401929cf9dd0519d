"""Timestep embeddings (counterpart of ``blobctrl_tpu/nn/embeddings.py``):
the diffusers ``Timesteps`` sinusoid and the ``TimestepEmbedding`` MLP."""

from __future__ import annotations

import math

import torch

from blobctrl_torch.nn import layers
from blobctrl_torch.parallel import kernel_sharding as ks


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0,
                                  max_period: float = 10000.0) -> torch.Tensor:
    """timesteps: (B,) -> (B, dim) fp32 sinusoidal embedding."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    return emb


def init_timestep_embedding(init: layers.ParamInit, in_dim: int,
                            time_embed_dim: int):
    k1, k2 = init.split()
    return {"linear_1": layers.init_linear(k1, in_dim, time_embed_dim),
            "linear_2": layers.init_linear(k2, time_embed_dim,
                                           time_embed_dim)}


def timestep_embedding(params, t_emb: torch.Tensor) -> torch.Tensor:
    """Both linears are column-only under tensor parallelism: each output
    is gathered to the full width (linear_2 is square) before its use."""
    full = params["linear_2"]["kernel"].shape[0]
    h = layers.linear(params["linear_1"], t_emb)
    h = layers.silu(ks.gather_channels(h, full))
    return ks.gather_channels(layers.linear(params["linear_2"], h), full)
