"""UNet2DCondition (SD-1.5 geometry) with BlobCtrl's injection protocol
(counterpart of ``blobctrl_tpu/models/unet.py``).

For SD-1.5 geometry there are 28 injection sites: 12 down (1 after conv_in
plus the per-block resnet/downsampler taps), 1 mid, 15 up, each applied to
the right half of the double-width sample. NHWC activations; params are
plain dicts with the JAX package's key names.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.nn import embeddings, layers
from blobctrl_torch.nn import unet_blocks as ub
from blobctrl_torch.parallel import kernel_sharding as ks


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    layers_per_block: int = 2
    cross_attention_dim: Optional[int] = 768
    num_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_layers_per_block: int = 1
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def init_unet(cfg: UNetConfig, key=0, device="cuda", dtype=torch.float32):
    """The JAX ``init_unet(key, cfg)``'s tree, leaf for leaf, drawn on
    ``device`` (``nn.layers.ParamInit``) and cast to ``dtype``; ``key`` a
    threefry key or an int, ``PRNGKey(int)``."""
    return _init_unet(layers.ParamInit(key, resolve_device(device), dtype),
                      cfg)


def _init_unet(init: layers.ParamInit, cfg: UNetConfig):
    """``4 + 2 * n`` children for n levels: conv_in, the time embedding,
    the n down blocks, the mid block, the n up blocks, conv_out."""
    boc = cfg.block_out_channels
    n = len(boc)
    ted = cfg.time_embed_dim
    ki = iter(init.split(4 + 2 * n))
    params = {
        "conv_in": layers.init_conv(next(ki), 3, 3, cfg.in_channels, boc[0]),
        "time_embedding": embeddings.init_timestep_embedding(next(ki),
                                                             boc[0], ted),
        "down_blocks": [], "up_blocks": [],
    }
    out_ch = boc[0]
    for i in range(n):
        in_ch, out_ch = out_ch, boc[i]
        params["down_blocks"].append(ub.init_down_block(
            next(ki), in_ch, out_ch, ted, cfg.layers_per_block,
            cfg.num_heads if cfg.down_block_has_attn[i] else None,
            cfg.cross_attention_dim, add_downsample=i < n - 1,
            transformer_layers=cfg.transformer_layers_per_block))
    params["mid_block"] = ub.init_mid_block(
        next(ki), boc[-1], ted, cfg.cross_attention_dim,
        cfg.transformer_layers_per_block)
    rev = list(reversed(boc))
    prev_out = rev[0]
    for i in range(n):
        out_ch, in_ch = rev[i], rev[min(i + 1, n - 1)]
        params["up_blocks"].append(ub.init_up_block(
            next(ki), in_ch, out_ch, prev_out, ted, cfg.layers_per_block + 1,
            cfg.num_heads if cfg.up_block_has_attn[i] else None,
            cfg.cross_attention_dim, add_upsample=i < n - 1,
            transformer_layers=cfg.transformer_layers_per_block))
        prev_out = out_ch
    params["conv_norm_out"] = layers.init_norm(init, boc[0])
    params["conv_out"] = layers.init_conv(next(ki), 3, 3, boc[0],
                                          cfg.out_channels)
    return params


def time_embed(params, cfg: UNetConfig, timesteps: torch.Tensor,
               dtype) -> torch.Tensor:
    t_emb = embeddings.sinusoidal_timestep_embedding(
        timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
        cfg.freq_shift)
    return embeddings.timestep_embedding(params["time_embedding"],
                                         t_emb.to(dtype))


def _norm_timesteps(timesteps, batch: int, device) -> torch.Tensor:
    t = torch.as_tensor(timesteps, dtype=torch.float32, device=device)
    return t.expand(batch) if t.dim() == 0 else t


@ks.scoped("unet")
def unet_encode(params, cfg: UNetConfig, sample: torch.Tensor, timesteps,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                down_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
                mid_block_add_sample: Optional[torch.Tensor] = None,
                remat: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """conv_in + down blocks + mid block, with the 12 down + 1 mid
    injections. Returns (mid activation, skip stack). remat: see
    ``nn.unet_blocks``."""
    timesteps = _norm_timesteps(timesteps, sample.shape[0], sample.device)
    ng, eps, heads = cfg.norm_num_groups, cfg.norm_eps, cfg.num_heads
    ctx = encoder_hidden_states
    emb = time_embed(params, cfg, timesteps, sample.dtype)

    x = ks.gather_channels(layers.conv2d(params["conv_in"], sample,
                                         padding=1),
                           cfg.block_out_channels[0])
    down_q = ub.InjectionQueue(down_block_add_samples)
    x = down_q.apply(x)
    res_stack: List[torch.Tensor] = [x]
    for i, block_p in enumerate(params["down_blocks"]):
        attn = cfg.down_block_has_attn[i]
        x, states = ub.down_block(block_p, x, emb, ctx if attn else None,
                                  heads if attn else None, down_q, ng, eps,
                                  remat)
        res_stack.extend(states)
    x = ub.mid_block(params["mid_block"], x, emb, ctx, heads, ng, eps, remat)
    if mid_block_add_sample is not None:
        x = ub.add_injection(x, mid_block_add_sample)
    down_q.assert_empty()
    return x, tuple(res_stack)


@ks.scoped("unet")
def unet_decode(params, cfg: UNetConfig, x: torch.Tensor, skip_stack,
                timesteps,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                up_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
                remat: bool = False) -> torch.Tensor:
    """Up blocks + output head from an (x_mid, skip_stack) encoder state."""
    timesteps = _norm_timesteps(timesteps, x.shape[0], x.device)
    ng, eps, heads = cfg.norm_num_groups, cfg.norm_eps, cfg.num_heads
    ctx = encoder_hidden_states
    emb = time_embed(params, cfg, timesteps, x.dtype)
    up_q = ub.InjectionQueue(up_block_add_samples)
    res_stack = list(skip_stack)
    for i, block_p in enumerate(params["up_blocks"]):
        k = len(block_p["resnets"])
        skips, res_stack = res_stack[-k:], res_stack[:-k]
        upsample_hw = tuple(res_stack[-1].shape[1:3]) if res_stack else None
        attn = cfg.up_block_has_attn[i]
        x, _ = ub.up_block(block_p, x, skips, emb, ctx if attn else None,
                           heads if attn else None, up_q, upsample_hw, ng,
                           eps, remat=remat)
    up_q.assert_empty()
    x = layers.silu(layers.group_norm(params["conv_norm_out"], x, ng, eps))
    return ks.gather_channels(
        layers.conv2d(params["conv_out"], x, padding=1), cfg.out_channels)


def unet_apply(params, cfg: UNetConfig, sample: torch.Tensor, timesteps,
               encoder_hidden_states: Optional[torch.Tensor] = None,
               down_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
               mid_block_add_sample: Optional[torch.Tensor] = None,
               up_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
               remat: bool = False) -> torch.Tensor:
    """sample: (B, H, W, C_in) NHWC; timesteps: (B,) or a scalar. The three
    *add_samples carry the right-half-cropped BlobNet residuals, consumed in
    the reference's order. remat: see ``nn.unet_blocks``."""
    x, res_stack = unet_encode(params, cfg, sample, timesteps,
                               encoder_hidden_states, down_block_add_samples,
                               mid_block_add_sample, remat)
    return unet_decode(params, cfg, x, res_stack, timesteps,
                       encoder_hidden_states, up_block_add_samples, remat)
