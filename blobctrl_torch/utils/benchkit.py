"""The production pipeline and the standard 512^2 edit inputs (counterpart of
``blobctrl_tpu/utils/benchkit.py``): one place that defines the edit the
port is driven and timed with."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from blobctrl_torch.apps import flagship
from blobctrl_torch.blob import math as blob_math
from blobctrl_torch.nn import attention, transformer_2d
from blobctrl_torch.ops import conv3x3, flash_attention
from blobctrl_torch.pipeline import BlobNetPipeline
from blobctrl_torch.tokenizer import clip_bpe


def make_flagship_pipe(seed: int = 0, device="cuda", dtype=torch.bfloat16):
    """Production-geometry pipeline with random weights drawn on the
    device (see ``flagship.production_params``)."""
    unet_p, blob_p, vae_p = flagship.production_params(seed, device, dtype)
    return BlobNetPipeline(
        unet_cfg=flagship.sd15_unet_config(), unet_params=unet_p,
        blobnet_cfg=flagship.blobctrl_blobnet_config(), blobnet_params=blob_p,
        vae_cfg=flagship.sd15_vae_config(), vae_params=vae_p, dtype=dtype,
        device=device)


def byte_level_tokenizer() -> clip_bpe.CLIPTokenizer:
    """A CLIP tokenizer over a vocabulary built in code: the 256 byte
    symbols, each again with the word-end mark, a few merges, BOS and EOS
    (the SD-1.5 vocabulary files are not in the repository)."""
    base = list(clip_bpe.bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(base)}
    for ch in base:
        vocab[ch + "</w>"] = len(vocab)
    merges = [("r", "e"), ("e", "d</w>"), ("b", "a"), ("l", "l</w>"),
              ("ba", "ll</w>"), ("t", "a"), ("b", "l"), ("bl", "e</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return clip_bpe.CLIPTokenizer(vocab, merges)


def add_encoders(pipe: BlobNetPipeline, seed: int = 0) -> BlobNetPipeline:
    """Give a production pipeline CLIP ViT-L/14 text, DINOv2-large (random
    weights drawn on its device) and the byte-level tokenizer, so it takes
    prompt strings and object images."""
    clip_p, dino_p = flagship.production_encoder_params(seed, pipe.device,
                                                        pipe.dtype)
    pipe.clip_cfg, pipe.clip_params = flagship.clip_vit_l_config(), clip_p
    pipe.dino_cfg, pipe.dino_params = flagship.dinov2_large_config(), dino_p
    pipe.tokenizer = byte_level_tokenizer()
    return pipe


def make_flagship_session_pipe(seed: int = 0, device="cuda",
                               dtype=torch.bfloat16):
    """The production pipeline with its encoders: what
    ``apps/session.BlobCtrlSession`` drives (random weights drawn on the
    device)."""
    return add_encoders(make_flagship_pipe(seed, device, dtype), seed + 3)


def make_edit_inputs(height: int = 512, seed: int = 0, ellipse=None,
                     width: int = None):
    """Random fg/bg images, one blob score, CLIP-shaped prompt embeds,
    DINOv2-shaped appearance feats and fixed initial latents, ``height``
    by ``width`` (square where ``width`` is None, then the same numbers as
    the JAX package's ``make_edit_inputs`` for the same seed)."""
    h, w = height, height if width is None else width
    rng = np.random.RandomState(seed)
    if ellipse is None:
        ellipse = ((w * 0.55, h * 0.5), (w * 0.25, h * 0.4), 30.0)
    return dict(
        fg_image=rng.randint(0, 255, (h, w, 3)).astype(np.uint8),
        bg_image=rng.randint(0, 255, (h, w, 3)).astype(np.uint8),
        gs_score=blob_math.blob_score_from_ellipse(
            ellipse, w, h, (h // 8, w // 8)).numpy(),
        prompt_embeds=rng.randn(1, 77, 768).astype(np.float32) * 0.02,
        negative_prompt_embeds=rng.randn(1, 77, 768).astype(np.float32) * 0.02,
        fg_dino_feats=rng.randn(1, 1024).astype(np.float32) * 0.1,
        latents=rng.randn(1, h // 8, w // 8, 4).astype(np.float32),
    )


def standard_edit_kwargs(height: int = 512, steps: int = 50, seed: int = 0,
                         ellipse=None, width: int = None):
    """Full kwargs for one production edit (unipc, CFG 7.5, control
    strength 1.6, control window end 0.9), ``height`` by ``width``
    (square where ``width`` is None)."""
    width = height if width is None else width
    kw = make_edit_inputs(height, seed, ellipse, width)
    kw.update(height=height, width=width, num_inference_steps=steps,
              guidance_scale=7.5, blobnet_conditioning_scale=1.6,
              blobnet_control_guidance_end=0.9, scheduler="unipc")
    return kw


@contextlib.contextmanager
def int8_everything():
    """The int8-everything bundle of the JAX package's bench (int8 convs
    with the static activation amax, and int8 q.k^T flash attention with one
    global k scale; the int8 linears stay off) around a block, restoring
    the previous switches after it."""
    conv_before = conv3x3.conv_int8_enabled()
    qk_before, gk_before = attention.attention_int8_mode()
    conv3x3.set_conv_int8(True)
    attention.set_attention_backend("auto", qk_int8=True, int8_global_k=True)
    try:
        yield
    finally:
        conv3x3.set_conv_int8(conv_before)
        attention.set_attention_backend("auto", qk_int8=qk_before,
                                        int8_global_k=gk_before)


@contextlib.contextmanager
def fused_kernels():
    """The fused-kernel edit: the exact edit with the JAX package's four
    opt-in kernels on (the exp2-folded flash attention, GroupNorm -> proj_in
    as one GEMM, each pre-LayerNorm fused into its projection, Winograd
    F(2x2, 3x3) for every routed 3x3 conv with even H and W) around a
    block, restoring the previous switches after it."""
    before = (flash_attention.exp2_fold_enabled(),
              transformer_2d.gn_proj_fuse_enabled(),
              attention.ln_matmul_fuse_mode(), conv3x3.winograd_enabled())
    flash_attention.set_exp2_fold(True)
    transformer_2d.set_gn_proj_fuse(True)
    attention.set_ln_matmul_fuse("on")
    conv3x3.set_winograd(True)
    try:
        yield
    finally:
        flash_attention.set_exp2_fold(before[0])
        transformer_2d.set_gn_proj_fuse(before[1])
        attention.set_ln_matmul_fuse(before[2])
        conv3x3.set_winograd(before[3])


def write_tiny_training_roots(models_root: str, data_root: str,
                              scenes: int = 4) -> None:
    """A tiny models root and a data set the training CLI runs on, made
    by the port alone wherever it runs, the same bits each time:
    ``flagship.tiny_configs``' UNet (at 4 input channels, the downloaded
    layout) and BlobNet cut to one level of one layer (attention in the
    UNet's blocks, in the BlobNet's mid block only), ``train/toy``'s VAE,
    ``write_training_root``'s encoders and LoRA; and ``scenes`` seeded
    toy scenes (``toy.make_scene``) at 64^2 with their masks and prompts,
    PNG (the first four the same whatever their number).
    ``tests/data/orbax`` holds JAX's run
    on them (``scripts/torch_orbax_fixtures.py``)."""
    import dataclasses
    import json
    import os
    from blobctrl_torch.models import blobnet, unet, vae
    from blobctrl_torch.train import toy
    from blobctrl_torch.utils import png
    ucfg, bcfg = flagship.tiny_configs()
    one = dict(block_out_channels=(8,), layers_per_block=1)
    ucfg = dataclasses.replace(ucfg, in_channels=4, down_block_has_attn=(
        True,), up_block_has_attn=(True,), **one)
    bcfg = dataclasses.replace(bcfg, down_block_has_attn=(False,),
                               up_block_has_attn=(False,), **one)
    vcfg = toy.toy_configs()[2]
    cpu = torch.device("cpu")
    write_training_root(models_root, unet.init_unet(ucfg, 1, cpu), ucfg,
                        blobnet.init_blobnet(bcfg, 2, cpu), bcfg,
                        vae.init_vae(vcfg, 3, cpu), vcfg)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(data_root, sub), exist_ok=True)
    rng = np.random.RandomState(13)
    prompts = {}
    for i in range(scenes):
        scene = toy.make_scene(rng, 64)
        for sub, arr in (("images", scene["image"]),
                         ("masks", scene["mask"])):
            with open(os.path.join(data_root, sub, f"scene{i}.png"),
                      "wb") as f:
                f.write(png.encode_png(arr))
        prompts[f"scene{i}"] = f"a {toy.COLORS[scene['cls']][0]} ball"
    with open(os.path.join(data_root, "prompts.json"), "w") as f:
        json.dump(prompts, f)


def write_training_root(models_root: str, unet_tree, unet_cfg,
                        blobnet_tree, blobnet_cfg, vae_tree,
                        vae_cfg) -> None:
    """A models root the training CLI loads, around the given UNet,
    BlobNet and VAE (trees on the host): ``flagship.tiny_encoder_configs``'
    CLIP text and DINOv2 (as wide as the toys' context and appearance
    channels) and a rank-4 LoRA over the UNet, drawn on the host from
    fixed keys (JAX's init trees for the same keys), all written in fp32,
    with ``byte_level_tokenizer``."""
    from blobctrl_torch.models import clip_text, dinov2, lora
    from blobctrl_torch.params import export
    from blobctrl_torch.utils import threefry
    ccfg, dcfg = flagship.tiny_encoder_configs()
    cpu = torch.device("cpu")
    adapter = lora.init_lora(threefry.key(5), unet_tree, rank=4, device=cpu)
    for i, ab in enumerate(adapter.values()):
        ab["B"] = 0.05 * threefry.normal(threefry.key(100 + i),
                                         tuple(ab["B"].shape), device=cpu)
    export.write_models_root(
        models_root, unet=unet_tree, unet_cfg=unet_cfg,
        blobnet=blobnet_tree, blobnet_cfg=blobnet_cfg, vae=vae_tree,
        vae_cfg=vae_cfg, clip=clip_text.init(ccfg, 4, cpu), clip_cfg=ccfg,
        dino=dinov2.init(dcfg, 6, cpu), dino_cfg=dcfg, lora=adapter,
        lora_alpha=8.0, tokenizer=byte_level_tokenizer(),
        dino_image_size=28, float_dtype=None)
