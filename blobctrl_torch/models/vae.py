"""AutoencoderKL (SD-1.5 VAE): encoder, decoder, scaled latents
(counterpart of ``blobctrl_tpu/models/vae.py``). GroupNorm(eps 1e-6), SiLU,
asymmetric (0,1,0,1) pad before each stride-2 encoder downsample, and a
single-head residual attention in both mid blocks (plain attention: the JAX
package leaves it to XLA too)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.nn import layers
from blobctrl_torch.nn import resnet as rn
from blobctrl_torch.parallel import kernel_sharding as ks
from blobctrl_torch.utils import threefry


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


def _attention_block(params, x: torch.Tensor, norm_groups: int):
    n, h, w, c = x.shape
    hs = layers.group_norm(params["norm"], x, norm_groups, eps=1e-6)
    hs = hs.reshape(n, h * w, c)
    q = layers.linear(params["to_q"], hs)
    k = layers.linear(params["to_k"], hs)
    v = layers.linear(params["to_v"], hs)
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * (
        1.0 / c ** 0.5)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = layers.linear(params["to_out"], torch.matmul(probs, v))
    return out.reshape(n, h, w, c) + x


def _mid_block(params, x: torch.Tensor, norm_groups: int):
    x = rn.resnet_block(params["resnets"][0], x, None, norm_groups, eps=1e-6)
    x = _attention_block(params["attentions"][0], x, norm_groups)
    return rn.resnet_block(params["resnets"][1], x, None, norm_groups,
                           eps=1e-6)


def encode(params, cfg: VAEConfig, image: torch.Tensor) -> torch.Tensor:
    """image: (B, H, W, 3) in [-1, 1] -> moments (B, H/8, W/8, 2*latent)."""
    enc = params["encoder"]
    ng = cfg.norm_num_groups
    gather = ks.gather_channels  # the column-only convs' outputs
    x = gather(layers.conv2d(enc["conv_in"], image, padding=1),
               cfg.block_out_channels[0])
    for block in enc["down_blocks"]:
        for res_p in block["resnets"]:
            x = rn.resnet_block(res_p, x, None, ng, eps=1e-6)
        if "downsample" in block:
            x = gather(layers.conv2d(block["downsample"]["conv"], x,
                                     stride=2, padding=((0, 1), (0, 1))),
                       x.shape[-1])
    x = _mid_block(enc["mid_block"], x, ng)
    x = layers.silu(layers.group_norm(enc["conv_norm_out"], x, ng, eps=1e-6))
    moments = 2 * cfg.latent_channels
    x = gather(layers.conv2d(enc["conv_out"], x, padding=1), moments)
    return gather(layers.conv2d(params["quant_conv"], x), moments)


def decode(params, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents: (B, h, w, 4) unscaled (divided by scaling_factor)."""
    dec = params["decoder"]
    ng = cfg.norm_num_groups
    gather = ks.gather_channels  # the column-only convs' outputs
    x = gather(layers.conv2d(params["post_quant_conv"], latents),
               cfg.latent_channels)
    x = gather(layers.conv2d(dec["conv_in"], x, padding=1),
               cfg.block_out_channels[-1])
    x = _mid_block(dec["mid_block"], x, ng)
    for block in dec["up_blocks"]:
        for res_p in block["resnets"]:
            x = rn.resnet_block(res_p, x, None, ng, eps=1e-6)
        if "upsample" in block:
            x = rn.conv3x3_routed(block["upsample"]["conv"],
                                  layers.nearest_upsample_2x(x), x.shape[-1])
    x = layers.silu(layers.group_norm(dec["conv_norm_out"], x, ng, eps=1e-6))
    return gather(layers.conv2d(dec["conv_out"], x, padding=1),
                  cfg.out_channels)


def sample_latents(moments: torch.Tensor, key=None) -> torch.Tensor:
    """The diagonal Gaussian of the moments (B, h, w, 2 * latent): its mode
    (the mean) when no key is given, else mean + exp(logvar / 2) * eps, the
    log variance clipped to [-30, 20], eps the JAX package's float32
    ``normal(key, mean.shape)`` (``utils.threefry``), drawn on the mean's
    device."""
    mean, logvar = moments.chunk(2, dim=-1)
    if key is None:
        return mean
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    eps = threefry.normal(key, mean.shape, device=mean.device)
    return mean + std * eps.to(mean.dtype)


@ks.scoped("vae")
def encode_to_scaled_latents(params, cfg: VAEConfig,
                             image: torch.Tensor) -> torch.Tensor:
    """The distribution's mode (no sampling), times the scaling factor."""
    mean = encode(params, cfg, image)[..., :cfg.latent_channels]
    return mean * cfg.scaling_factor


@ks.scoped("vae")
def decode_from_scaled_latents(params, cfg: VAEConfig,
                               latents: torch.Tensor) -> torch.Tensor:
    return decode(params, cfg, latents / cfg.scaling_factor)


def init_vae(cfg: VAEConfig, key=0, device="cuda", dtype=torch.float32):
    """The JAX ``init_vae(key, cfg)``'s tree, leaf for leaf, drawn on
    ``device`` and cast to ``dtype``; ``key`` a threefry key or an int,
    ``PRNGKey(int)``. ``split(key, 64)`` is taken in order, one child per
    resnet, projection and conv: the encoder's conv_in, each down block's
    resnets then its downsampler, the mid resnets, to_q, to_k, to_v and
    to_out, conv_out; the decoder's conv_in, mid block, each up block's
    resnets then its upsampler, conv_out; quant_conv, post_quant_conv (44
    at SD-1.5's geometry)."""
    init = layers.ParamInit(key, resolve_device(device), dtype)
    keys = iter(init.split(64))
    boc = cfg.block_out_channels
    n = len(boc)

    def resnets(c_in, c_out, count):
        return [rn.init_resnet_block(next(keys), c_in if i == 0 else c_out,
                                     c_out, None) for i in range(count)]

    def attn(c):
        return {"norm": layers.init_norm(init, c),
                **{name: layers.init_linear(next(keys), c, c)
                   for name in ("to_q", "to_k", "to_v", "to_out")}}

    def conv3(c_in, c_out):
        return layers.init_conv(next(keys), 3, 3, c_in, c_out)

    enc = {"conv_in": conv3(cfg.in_channels, boc[0]), "down_blocks": []}
    c = boc[0]
    for i in range(n):
        block = {"resnets": resnets(c, boc[i], cfg.layers_per_block)}
        if i < n - 1:
            block["downsample"] = {"conv": conv3(boc[i], boc[i])}
        enc["down_blocks"].append(block)
        c = boc[i]
    enc["mid_block"] = {"resnets": resnets(c, c, 2), "attentions": [attn(c)]}
    enc["conv_norm_out"] = layers.init_norm(init, c)
    enc["conv_out"] = conv3(c, 2 * cfg.latent_channels)

    rev = list(reversed(boc))
    dec = {"conv_in": conv3(cfg.latent_channels, rev[0]),
           "mid_block": {"resnets": resnets(rev[0], rev[0], 2),
                         "attentions": [attn(rev[0])]},
           "up_blocks": []}
    c = rev[0]
    for i in range(n):
        block = {"resnets": resnets(c, rev[i], cfg.layers_per_block + 1)}
        if i < n - 1:
            block["upsample"] = {"conv": conv3(rev[i], rev[i])}
        dec["up_blocks"].append(block)
        c = rev[i]
    dec["conv_norm_out"] = layers.init_norm(init, c)
    dec["conv_out"] = conv3(c, cfg.out_channels)
    lc2 = 2 * cfg.latent_channels
    return {"encoder": enc, "decoder": dec,
            "quant_conv": layers.init_conv(next(keys), 1, 1, lc2, lc2),
            "post_quant_conv": layers.init_conv(
                next(keys), 1, 1, cfg.latent_channels, cfg.latent_channels)}
