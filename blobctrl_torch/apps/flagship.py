"""The production BlobCtrl stack: SD-1.5 UNet (5-channel conv_in), BlobNet
(1029-channel conv_in) and the SD-1.5 VAE (counterpart of
``blobctrl_tpu/apps/flagship.py``), plus the tiny test geometry and random
production-geometry weights drawn on the device."""

from __future__ import annotations

import torch

from blobctrl_torch.models import blobnet as blobnet_lib
from blobctrl_torch.models import unet as unet_lib
from blobctrl_torch.models import vae as vae_lib


def sd15_unet_config() -> unet_lib.UNetConfig:
    """SD-1.5 UNet with conv_in widened 4 -> 5 channels."""
    return unet_lib.UNetConfig(in_channels=5)


def blobctrl_blobnet_config() -> blobnet_lib.BlobNetConfig:
    """BlobNet over 4 latent + 1 score + 1024 DINOv2 channels."""
    return blobnet_lib.BlobNetConfig(in_channels=4, conditioning_channels=1025)


def sd15_vae_config() -> vae_lib.VAEConfig:
    return vae_lib.VAEConfig()


def tiny_configs(dino_c: int = 16, ctx: int = 16):
    """Small geometry for tests: 2 levels of 8/16 channels."""
    unet_cfg = unet_lib.UNetConfig(
        in_channels=5, out_channels=4, block_out_channels=(8, 16),
        down_block_has_attn=(True, False), up_block_has_attn=(False, True),
        layers_per_block=2, cross_attention_dim=ctx, num_heads=2,
        norm_num_groups=4)
    blobnet_cfg = blobnet_lib.BlobNetConfig(
        in_channels=4, conditioning_channels=1 + dino_c,
        block_out_channels=(8, 16), down_block_has_attn=(True, False),
        up_block_has_attn=(False, True), layers_per_block=2,
        cross_attention_dim=None, num_heads=2, norm_num_groups=4)
    return unet_cfg, blobnet_cfg


def production_params(seed: int = 0, device="cuda", dtype=torch.bfloat16):
    """(unet, blobnet, vae) params at production geometry, drawn on the
    device with the JAX init bounds (uniform +-1/sqrt(fan_in) kernels, unit
    norm scales, zero biases). The BlobNet taps are drawn too, so every
    kernel and injection sees nontrivial data."""
    return (unet_lib.init_unet(sd15_unet_config(), seed, device, dtype),
            blobnet_lib.init_blobnet(blobctrl_blobnet_config(), seed + 1,
                                     device, dtype, zero_taps=False),
            vae_lib.init_vae(sd15_vae_config(), seed + 2, device, dtype))
