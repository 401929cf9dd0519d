"""Config JSON round trips (counterpart of
``blobctrl_tpu/params/config_io.py``): the port's frozen config dataclasses
saved and restored, and diffusers / transformers ``config.json`` dicts
translated into them."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Type, TypeVar

from blobctrl_torch.models.blobnet import BlobNetConfig
from blobctrl_torch.models.clip_text import CLIPTextConfig
from blobctrl_torch.models.dinov2 import DINOv2Config
from blobctrl_torch.models.unet import UNetConfig
from blobctrl_torch.models.vae import VAEConfig

T = TypeVar("T")


def save_config(cfg, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    d = dataclasses.asdict(cfg)
    d["_class_name"] = type(cfg).__name__
    with open(path, "w") as f:
        json.dump(d, f, indent=2, default=str)


def load_config(cls: Type[T], path: str) -> T:
    with open(path) as f:
        d = json.load(f)
    d.pop("_class_name", None)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in fields})


def _heads(config: Dict[str, Any]) -> int:
    # diffusers' SD-1.5 configs name the head count attention_head_dim
    heads = config.get("num_attention_heads") or config["attention_head_dim"]
    if isinstance(heads, (list, tuple)):
        heads = heads[0]
    return int(heads)


def unet_config_from_diffusers(config: Dict[str, Any]) -> UNetConfig:
    """A diffusers UNet2DConditionModel config.json -> UNetConfig."""
    return UNetConfig(
        in_channels=config["in_channels"],
        out_channels=config["out_channels"],
        block_out_channels=tuple(config["block_out_channels"]),
        down_block_has_attn=tuple("CrossAttn" in t
                                  for t in config["down_block_types"]),
        up_block_has_attn=tuple("CrossAttn" in t
                                for t in config["up_block_types"]),
        layers_per_block=config["layers_per_block"],
        cross_attention_dim=config.get("cross_attention_dim"),
        num_heads=_heads(config),
        norm_num_groups=config.get("norm_num_groups", 32),
        norm_eps=config.get("norm_eps", 1e-5),
        transformer_layers_per_block=config.get(
            "transformer_layers_per_block", 1) or 1,
        flip_sin_to_cos=config.get("flip_sin_to_cos", True),
        freq_shift=config.get("freq_shift", 0),
    )


def vae_config_from_diffusers(config: Dict[str, Any]) -> VAEConfig:
    return VAEConfig(
        in_channels=config.get("in_channels", 3),
        out_channels=config.get("out_channels", 3),
        latent_channels=config.get("latent_channels", 4),
        block_out_channels=tuple(config.get("block_out_channels",
                                            (128, 256, 512, 512))),
        layers_per_block=config.get("layers_per_block", 2),
        norm_num_groups=config.get("norm_num_groups", 32),
        scaling_factor=config.get("scaling_factor", 0.18215),
    )


def clip_text_config_from_transformers(config: Dict[str, Any]
                                       ) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=config.get("vocab_size", 49408),
        hidden_size=config.get("hidden_size", 768),
        intermediate_size=config.get("intermediate_size", 3072),
        num_layers=config.get("num_hidden_layers", 12),
        num_heads=config.get("num_attention_heads", 12),
        max_positions=config.get("max_position_embeddings", 77),
        layer_norm_eps=config.get("layer_norm_eps", 1e-5),
        hidden_act=config.get("hidden_act", "quick_gelu"),
    )


def dinov2_config_from_transformers(config: Dict[str, Any]) -> DINOv2Config:
    return DINOv2Config(
        hidden_size=config.get("hidden_size", 1024),
        num_layers=config.get("num_hidden_layers", 24),
        num_heads=config.get("num_attention_heads", 16),
        intermediate_size=config.get("intermediate_size", 4096),
        patch_size=config.get("patch_size", 14),
        layer_norm_eps=config.get("layer_norm_eps", 1e-6),
        image_size=config.get("image_size", 518),
    )


def _block_types(has_attn, base: str):
    return ["CrossAttn" + base if a else base for a in has_attn]


def blobnet_config_to_diffusers(cfg: BlobNetConfig) -> Dict[str, Any]:
    """BlobNetConfig -> the reference BlobNetModel config.json dict (the
    inverse of ``blobnet_config_from_diffusers``)."""
    return {
        "_class_name": "BlobNetModel",
        "in_channels": cfg.in_channels,
        "conditioning_channels": cfg.conditioning_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": _block_types(cfg.down_block_has_attn,
                                         "DownBlock2D"),
        "up_block_types": _block_types(cfg.up_block_has_attn, "UpBlock2D"),
        "layers_per_block": cfg.layers_per_block,
        "cross_attention_dim": cfg.cross_attention_dim,
        "attention_head_dim": cfg.num_heads,
        "norm_num_groups": cfg.norm_num_groups,
        "norm_eps": cfg.norm_eps,
    }


def blobnet_config_from_diffusers(config: Dict[str, Any]) -> BlobNetConfig:
    """The reference BlobNetModel config.json -> BlobNetConfig."""
    return BlobNetConfig(
        in_channels=config.get("in_channels", 4),
        conditioning_channels=config.get("conditioning_channels", 1025),
        block_out_channels=tuple(config["block_out_channels"]),
        down_block_has_attn=tuple("CrossAttn" in t
                                  for t in config["down_block_types"]),
        up_block_has_attn=tuple("CrossAttn" in t
                                for t in config["up_block_types"]),
        layers_per_block=config["layers_per_block"],
        cross_attention_dim=config.get("cross_attention_dim"),
        num_heads=_heads(config),
        norm_num_groups=config.get("norm_num_groups", 32),
        norm_eps=config.get("norm_eps", 1e-5),
    )
