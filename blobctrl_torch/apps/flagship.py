"""The production BlobCtrl stack: SD-1.5 UNet (5-channel conv_in), BlobNet
(1029-channel conv_in), the SD-1.5 VAE, CLIP ViT-L/14 text and DINOv2-large
(counterpart of ``blobctrl_tpu/apps/flagship.py``), plus the tiny test
geometry and random production-geometry weights drawn on the device."""

from __future__ import annotations

import torch

from blobctrl_torch.models import blobnet as blobnet_lib
from blobctrl_torch.models import clip_text as clip_lib
from blobctrl_torch.models import dinov2 as dino_lib
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


def clip_vit_l_config() -> clip_lib.CLIPTextConfig:
    """CLIP ViT-L/14 text: 12 layers, 768 wide, 77 positions."""
    return clip_lib.CLIPTextConfig()


def dinov2_large_config() -> dino_lib.DINOv2Config:
    """DINOv2-large: 24 layers, 1024 wide, 14-px patches."""
    return dino_lib.DINOv2Config.large()


def tiny_encoder_configs(vocab_size: int = 600, ctx: int = 16,
                         dino_c: int = 16):
    """Small CLIP text and DINOv2 for tests, as wide as ``tiny_configs``'
    context and appearance channels."""
    return (clip_lib.CLIPTextConfig(vocab_size=vocab_size, hidden_size=ctx,
                                    intermediate_size=2 * ctx, num_layers=2,
                                    num_heads=2),
            dino_lib.DINOv2Config(hidden_size=dino_c, num_layers=2,
                                  num_heads=2, intermediate_size=2 * dino_c,
                                  patch_size=14, image_size=56))


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
    device in fp32 and cast to ``dtype``: the JAX package's
    ``init_unet(PRNGKey(seed), sd15_unet_config())``,
    ``init_blobnet(PRNGKey(seed + 1), blobctrl_blobnet_config())`` and
    ``init_vae(PRNGKey(seed + 2), sd15_vae_config())``, leaf for leaf,
    but for the BlobNet's 1x1 taps, drawn from a key outside JAX's tree
    (``blobnet.init_blobnet``'s ``zero_taps=False``) so that every kernel
    and injection sees nontrivial data."""
    return (unet_lib.init_unet(sd15_unet_config(), seed, device, dtype),
            blobnet_lib.init_blobnet(blobctrl_blobnet_config(), seed + 1,
                                     device, dtype, zero_taps=False),
            vae_lib.init_vae(sd15_vae_config(), seed + 2, device, dtype))


def production_encoder_params(seed: int = 0, device="cuda",
                              dtype=torch.bfloat16):
    """(clip, dino) params of CLIP ViT-L/14 text and DINOv2-large, drawn on
    the device in fp32 and cast to ``dtype``: the JAX package's
    ``clip_text.init(PRNGKey(seed), clip_vit_l_config())`` and
    ``dinov2.init(PRNGKey(seed + 1), dinov2_large_config())``, leaf for
    leaf."""
    return (clip_lib.init(clip_vit_l_config(), seed, device, dtype),
            dino_lib.init(dinov2_large_config(), seed + 1, device, dtype))
