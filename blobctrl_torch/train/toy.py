"""The trained toy checkpoints (``assets/toy_ckpt``, ``assets/toy_ckpt_256``):
configs, the fixed class embeddings and the loader (counterpart of the
loading half of ``blobctrl_tpu/train/toy.py``; training is not ported)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from blobctrl_torch.models import blobnet as blobnet_lib
from blobctrl_torch.models import unet as unet_lib
from blobctrl_torch.models import vae as vae_lib
from blobctrl_torch.params import from_jax as fj

# (name, RGB): class identity is both the "prompt" and the "appearance"
COLORS = (("red", (214, 48, 38)), ("green", (52, 168, 83)),
          ("blue", (66, 103, 210)), ("yellow", (233, 196, 34)),
          ("magenta", (186, 60, 170)), ("cyan", (58, 186, 186)))


def toy_configs(ctx: int = 16, dino_c: int = 16, size: int = 128):
    """2-level nets at size 128, 3-level at size >= 256; 4-level f8 VAE."""
    if size >= 256:
        blocks = (32, 64, 96)
        down_attn, up_attn = (True, True, False), (False, True, True)
    else:
        blocks = (32, 64)
        down_attn, up_attn = (True, False), (False, True)
    unet_cfg = unet_lib.UNetConfig(
        in_channels=5, out_channels=4, block_out_channels=blocks,
        down_block_has_attn=down_attn, up_block_has_attn=up_attn,
        layers_per_block=2, cross_attention_dim=ctx, num_heads=2,
        norm_num_groups=8)
    blobnet_cfg = blobnet_lib.BlobNetConfig(
        in_channels=4, conditioning_channels=1 + dino_c,
        block_out_channels=blocks, down_block_has_attn=down_attn,
        up_block_has_attn=up_attn, layers_per_block=2,
        cross_attention_dim=None, num_heads=2, norm_num_groups=8)
    vae_cfg = vae_lib.VAEConfig(block_out_channels=(16, 32, 32, 32),
                                layers_per_block=1, norm_num_groups=8)
    return unet_cfg, blobnet_cfg, vae_cfg


def class_embeddings(ctx: int = 16, length: int = 7, seed: int = 7,
                     dino_c: int = 16) -> Dict[str, np.ndarray]:
    """Fixed random per-class embeddings: "text" (n, length, ctx) plays
    CLIP's role, "appearance" (n, dino_c) DINOv2's."""
    rng = np.random.RandomState(seed)
    n = len(COLORS)
    return {"text": (rng.randn(n, length, ctx) * 0.5).astype(np.float32),
            "appearance": rng.randn(n, dino_c).astype(np.float32)}


def load_toy(ckpt_dir: str, device="cuda", dtype=torch.float32):
    """-> (BlobNetPipeline over the trained toy weights, meta dict)."""
    from blobctrl_torch.pipeline import BlobNetPipeline

    with open(os.path.join(ckpt_dir, "toy.json")) as f:
        meta = json.load(f)
    trees: Dict[str, Dict[str, np.ndarray]] = {"unet": {}, "blobnet": {},
                                               "vae": {}}
    for k, v in fj.load_safetensors(os.path.join(ckpt_dir,
                                                 "toy.safetensors")).items():
        prefix, rest = k.split(".", 1)
        trees[prefix][rest] = np.asarray(v, np.float32)
    unet_cfg, blobnet_cfg, vae_cfg = toy_configs(
        ctx=meta["ctx"], dino_c=meta["dino_c"], size=meta.get("size", 128))
    vae_cfg = dataclasses.replace(vae_cfg,
                                  scaling_factor=meta["vae_scaling_factor"])
    params = {k: fj.from_jax(fj.unflatten(v), device, dtype)
              for k, v in trees.items()}
    pipe = BlobNetPipeline(unet_cfg=unet_cfg, unet_params=params["unet"],
                           blobnet_cfg=blobnet_cfg,
                           blobnet_params=params["blobnet"],
                           vae_cfg=vae_cfg, vae_params=params["vae"],
                           dtype=dtype, device=device)
    return pipe, meta
