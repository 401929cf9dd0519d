"""Param trees -> the reference checkpoint layout: the inverse of
``params.convert`` and ``params.config_io``, and a safetensors writer on
numpy and json alone (the port does not depend on the ``safetensors``
package).

``write_models_root`` lays out a whole ``models_root`` as the reference's
downloader does (see ``params.io``), so the loaders can be driven from
weights made in code. The ``*_state_dict`` functions work on trees of
numpy arrays or torch tensors (on any device), and return views where the
layout allows: nothing is copied until the writer reaches the leaf.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from blobctrl_torch.params import config_io

_TORCH_ST = {torch.float64: "F64", torch.float32: "F32",
             torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
             torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": [{"c": x}]}} -> {"a.b.0.c": x}."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _permute(x, axes):
    return x.permute(*axes) if torch.is_tensor(x) else x.transpose(axes)


def _torch_layout(key: str, x):
    """A tree leaf -> (torch key suffix "weight"/"bias", torch layout)."""
    stem, last = key.rsplit(".", 1)
    if last == "kernel":
        if x.ndim == 4:
            return stem + ".weight", _permute(x, (3, 2, 0, 1))
        return stem + ".weight", _permute(x, (1, 0))
    if last == "scale":
        return stem + ".weight", x
    return key, x


def unet_state_dict(tree) -> Dict[str, Any]:
    """A UNet or BlobNet tree -> diffusers UNet2DConditionModel /
    BlobNetModel keys and layouts."""
    sd = {}
    for path, x in flatten(tree).items():
        p = (("." + path).replace(".ff.proj_in.", ".ff.net.0.proj.")
             .replace(".ff.proj_out.", ".ff.net.2.")
             .replace(".zero_down.", ".blobnet_down_blocks.")
             .replace(".zero_mid.", ".blobnet_mid_block.")
             .replace(".zero_up.", ".blobnet_up_blocks.")
             .replace(".blocks.", ".transformer_blocks.")
             .replace(".downsample.", ".downsamplers.0.")
             .replace(".upsample.", ".upsamplers.0.")
             .replace(".to_out.", ".to_out.0."))[1:]
        k, v = _torch_layout(p, x)
        sd[k] = v
    return sd


def vae_state_dict(tree) -> Dict[str, Any]:
    """A VAE tree -> diffusers AutoencoderKL keys and layouts."""
    sd = {}
    for path, x in flatten(tree).items():
        p = (("." + path).replace(".downsample.", ".downsamplers.0.")
             .replace(".upsample.", ".upsamplers.0.")
             .replace(".to_out.", ".to_out.0.")
             .replace(".norm.", ".group_norm."))[1:]
        k, v = _torch_layout(p, x)
        sd[k] = v
    return sd


def clip_text_state_dict(tree, max_positions: int = 77) -> Dict[str, Any]:
    """A CLIP text tree -> transformers CLIPTextModel keys and layouts, with
    its position_ids buffer."""
    sd = {"text_model.embeddings.position_ids":
          np.arange(max_positions, dtype=np.int64)[None]}
    for path, x in flatten(tree).items():
        if path in ("token_embedding", "position_embedding"):
            sd[f"text_model.embeddings.{path}.weight"] = x
            continue
        if path.startswith("layers."):
            path = "encoder." + path
        k, v = _torch_layout(path, x)
        sd["text_model." + k] = v
    return sd


def dinov2_state_dict(tree) -> Dict[str, Any]:
    """A DINOv2 tree -> transformers Dinov2Model keys and layouts, with its
    (unused) mask token."""
    sd = {}
    for path, x in flatten(tree).items():
        if path == "cls_token":
            sd["embeddings.cls_token"] = x[None]
            sd["embeddings.mask_token"] = np.zeros(tuple(x.shape),
                                                   np.float32)
            continue
        if path == "position_embeddings":
            sd["embeddings.position_embeddings"] = x[None]
            continue
        if path.startswith("patch_embed."):
            path = path.replace("patch_embed.",
                                "embeddings.patch_embeddings.projection.")
        parts = path.split(".")
        if parts[0] == "layers":
            n = parts[1]
            if parts[2] in ("ls1", "ls2"):
                sd[f"encoder.layer.{n}.layer_scale{parts[2][-1]}.lambda1"] = x
                continue
            if parts[2] == "attn":
                name = {"q": "attention.attention.query",
                        "k": "attention.attention.key",
                        "v": "attention.attention.value",
                        "out": "attention.output.dense"}[parts[3]]
                parts = ["layer", n] + name.split(".") + parts[4:]
            else:
                parts = ["layer"] + parts[1:]
            path = "encoder." + ".".join(parts)
        k, v = _torch_layout(path, x)
        sd[k] = v
    return sd


def lora_state_dict(lora: Dict[str, Any]) -> Dict[str, Any]:
    """An adapter dict -> PEFT keys: lora_A (r, in) or, for a k x k conv
    adapter, (r, in, kh, kw) with lora_B (out, r, 1, 1); lora_B (out, r)."""
    sd = {}
    for key, ab in lora.items():
        body = ("." + key.replace("/", ".") + ".").replace(
            ".blocks.", ".transformer_blocks.").replace(
            ".ff.proj_in.", ".ff.net.0.proj.").replace(
            ".ff.proj_out.", ".ff.net.2.").replace(
            ".downsample.", ".downsamplers.0.").replace(
            ".upsample.", ".upsamplers.0.").replace(
            ".to_out.", ".to_out.0.")[1:-1]
        a, b = ab["A"], ab["B"]
        if a.ndim == 4:
            a, b = _permute(a, (3, 2, 0, 1)), _permute(b, (1, 0))[:, :, None,
                                                                  None]
        else:
            a, b = _permute(a, (1, 0)), _permute(b, (1, 0))
        sd[f"base_model.model.{body}.lora_A.weight"] = a
        sd[f"base_model.model.{body}.lora_B.weight"] = b
    return sd


# the SAM tree's path fragments -> the original segment_anything keys, in
# order (the neck's norms before the blocks' generic ones)
SAM_RENAMES = (
    (".vision.patch_embed.", ".image_encoder.patch_embed.proj."),
    (".vision.layers.", ".image_encoder.blocks."),
    (".vision.neck.conv1.", ".image_encoder.neck.0."),
    (".vision.neck.layer_norm1.", ".image_encoder.neck.1."),
    (".vision.neck.conv2.", ".image_encoder.neck.2."),
    (".vision.neck.layer_norm2.", ".image_encoder.neck.3."),
    (".layer_norm1.", ".norm1."), (".layer_norm2.", ".norm2."),
    (".layer_norm3.", ".norm3."), (".layer_norm4.", ".norm4."),
    (".layer_norm_final_attn.", ".norm_final_attn."),
    (".decoder.upscale_conv1.", ".decoder.output_upscaling.0."),
    (".decoder.upscale_layer_norm.", ".decoder.output_upscaling.1."),
    (".decoder.upscale_conv2.", ".decoder.output_upscaling.3."),
    (".decoder.", ".mask_decoder."),
)
# leaves stored as they are in the tree, or with a leading axis of one
SAM_TABLES = {
    "vision.pos_embed": ("image_encoder.pos_embed", True),
    "prompt.shared_embedding": (
        "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", False),
    "prompt.not_a_point_embed": ("prompt_encoder.not_a_point_embed.weight",
                                 True),
    "prompt.no_mask_embed": ("prompt_encoder.no_mask_embed.weight", True),
    "decoder.iou_token": ("mask_decoder.iou_token.weight", False),
    "decoder.mask_tokens": ("mask_decoder.mask_tokens.weight", False),
}


def sam_state_dict(tree) -> Dict[str, Any]:
    """A SAM tree -> the original ``segment_anything`` checkpoint's keys and
    layouts (``sam_vit_h_4b8939.pth``): the inverse of the converter's
    original-format path. The transposed convs' (kh, kw, c_out, c_in)
    kernels go back to torch's (c_in, c_out, kh, kw)."""
    sd = {}
    for path, x in flatten(tree).items():
        if path in SAM_TABLES:
            key, lead = SAM_TABLES[path]
            sd[key] = x[None] if lead else x
            continue
        if path == "prompt.point_embed":
            for i in range(x.shape[0]):
                sd[f"prompt_encoder.point_embeddings.{i}.weight"] = x[i:i + 1]
            continue
        if path.endswith((".rel_pos_h", ".rel_pos_w")):
            k, v = path, x
        else:
            k, v = _torch_layout(path, x)
        k = "." + k
        for old, new in SAM_RENAMES:
            k = k.replace(old, new)
        # the MLP heads: head.j -> head.layers.j
        k = re.sub(r"(output_hypernetworks_mlps\.\d+|iou_prediction_head)"
                   r"\.(\d+)\.", r"\1.layers.\2.", k)
        sd[k[1:]] = v
    return sd


def save_sam(path: str, tree) -> int:
    """Write a SAM tree as the original checkpoint file, a ``torch.save``d
    state dict of contiguous CPU tensors in the tree's dtype, one leaf
    copied to the host at a time. -> the file's bytes."""
    sd = {k: _as_torch(v).contiguous().cpu()
          for k, v in sam_state_dict(tree).items()}
    torch.save(sd, path)
    return os.path.getsize(path)


def safety_checker_state_dict(tree) -> Dict[str, Any]:
    """A safety-checker tree -> diffusers' StableDiffusionSafetyChecker keys
    (the SD-1.5 ``safety_checker/`` weights): the CLIP vision tower under
    ``vision_model.``, the projection, the concept and special-care
    embeddings and their thresholds."""
    prefix = "vision_model.vision_model."   # transformers' CLIPVisionModel
    sd = {}
    for path, x in flatten(tree["vision"]).items():
        if path == "class_embedding":
            sd[prefix + "embeddings.class_embedding"] = x
            continue
        if path == "position_embedding":
            sd[prefix + "embeddings.position_embedding.weight"] = x
            continue
        if path.startswith("patch_embed."):
            path = path.replace("patch_embed.", "embeddings.patch_embedding.")
        if path.startswith("layers."):
            path = "encoder." + path
        k, v = _torch_layout(path, x)
        sd[prefix + k] = v
    sd["visual_projection.weight"] = _permute(
        tree["visual_projection"]["kernel"], (1, 0))
    for k in ("concept_embeds", "concept_embeds_weights",
              "special_care_embeds", "special_care_embeds_weights"):
        sd[k] = tree[k]
    return sd


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def unet_config_to_diffusers(cfg) -> Dict[str, Any]:
    """UNetConfig -> a diffusers UNet2DConditionModel config.json dict."""
    return {"_class_name": "UNet2DConditionModel",
            "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "down_block_types": config_io._block_types(cfg.down_block_has_attn,
                                             "DownBlock2D"),
            "up_block_types": config_io._block_types(cfg.up_block_has_attn,
                                           "UpBlock2D"),
            "layers_per_block": cfg.layers_per_block,
            "cross_attention_dim": cfg.cross_attention_dim,
            "attention_head_dim": cfg.num_heads,
            "norm_num_groups": cfg.norm_num_groups, "norm_eps": cfg.norm_eps,
            "transformer_layers_per_block": cfg.transformer_layers_per_block,
            "flip_sin_to_cos": cfg.flip_sin_to_cos,
            "freq_shift": cfg.freq_shift}


def vae_config_to_diffusers(cfg) -> Dict[str, Any]:
    n = len(cfg.block_out_channels)
    return {"_class_name": "AutoencoderKL", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels,
            "latent_channels": cfg.latent_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "down_block_types": ["DownEncoderBlock2D"] * n,
            "up_block_types": ["UpDecoderBlock2D"] * n,
            "layers_per_block": cfg.layers_per_block,
            "norm_num_groups": cfg.norm_num_groups,
            "scaling_factor": cfg.scaling_factor}


def clip_text_config_to_transformers(cfg) -> Dict[str, Any]:
    return {"architectures": ["CLIPTextModel"],
            "model_type": "clip_text_model", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_positions,
            "layer_norm_eps": cfg.layer_norm_eps,
            "hidden_act": cfg.hidden_act}


def dinov2_config_to_transformers(cfg) -> Dict[str, Any]:
    return {"architectures": ["Dinov2Model"], "model_type": "dinov2",
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "patch_size": cfg.patch_size, "layer_norm_eps": cfg.layer_norm_eps,
            "image_size": cfg.image_size}


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _as_torch(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.array(x))


def _torch_dtype(x) -> torch.dtype:
    return x.dtype if torch.is_tensor(x) else _as_torch(
        np.empty(0, np.asarray(x).dtype)).dtype


def save_safetensors(path: str, tensors: Dict[str, Any],
                     float_dtype: Optional[torch.dtype] = None) -> int:
    """Write name -> array (numpy or torch, any device) as a .safetensors
    file, floats cast to ``float_dtype`` when given; one leaf at a time is
    made contiguous and copied to the host. -> bytes written."""
    header, dtypes, offset = {}, {}, 0
    for name, x in tensors.items():
        dt = _torch_dtype(x)
        if float_dtype is not None and dt.is_floating_point:
            dt = float_dtype
        shape = [int(n) for n in x.shape]
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dt
                                                   ).element_size()
        header[name] = {"dtype": _TORCH_ST[dt], "shape": shape,
                        "data_offsets": [offset, offset + nbytes]}
        dtypes[name] = dt
        offset += nbytes
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(len(hb).to_bytes(8, "little"))
        f.write(hb)
        for name, x in tensors.items():
            t = _as_torch(x).to(dtypes[name]).contiguous().cpu()
            if t.dtype == torch.bfloat16:  # numpy has no bfloat16
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())
    return 8 + len(hb) + offset


def save_tokenizer(tokenizer, tokenizer_dir: str):
    """A ``CLIPTokenizer`` -> vocab.json and merges.txt."""
    os.makedirs(tokenizer_dir, exist_ok=True)
    with open(os.path.join(tokenizer_dir, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(tokenizer.encoder, f, ensure_ascii=False)
    merges = sorted(tokenizer.bpe_ranks, key=tokenizer.bpe_ranks.get)
    with open(os.path.join(tokenizer_dir, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def _write_json(path: str, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def write_models_root(root: str, *, unet, unet_cfg, blobnet, blobnet_cfg,
                      vae, vae_cfg, clip, clip_cfg, dino, dino_cfg, lora,
                      lora_alpha=None, tokenizer=None,
                      dino_image_size: int = 224,
                      float_dtype: Optional[torch.dtype] = torch.float16
                      ) -> int:
    """Lay out a reference ``models_root`` (see ``params.io``): each net's
    safetensors and config.json, the PEFT LoRA with its adapter_config.json,
    the DINOv2 preprocessor config (its crop is the input size) and the
    tokenizer files. -> bytes of weights written."""
    sd_root = os.path.join(root, "stable-diffusion-v1-5")
    nets = (
        (os.path.join(sd_root, "unet"), "diffusion_pytorch_model",
         unet_state_dict(unet), unet_config_to_diffusers(unet_cfg)),
        (os.path.join(sd_root, "vae"), "diffusion_pytorch_model",
         vae_state_dict(vae), vae_config_to_diffusers(vae_cfg)),
        (os.path.join(sd_root, "text_encoder"), "model",
         clip_text_state_dict(clip, clip_cfg.max_positions),
         clip_text_config_to_transformers(clip_cfg)),
        (os.path.join(root, "BlobCtrl", "blobnet"), "diffusion_pytorch_model",
         unet_state_dict(blobnet),
         config_io.blobnet_config_to_diffusers(blobnet_cfg)),
        (os.path.join(root, "dinov2-large"), "model", dinov2_state_dict(dino),
         dinov2_config_to_transformers(dino_cfg)),
        (os.path.join(root, "BlobCtrl", "unet_lora"), "adapter_model",
         lora_state_dict(lora), None))
    total = 0
    for d, name, sd, cfg in nets:
        os.makedirs(d, exist_ok=True)
        total += save_safetensors(os.path.join(d, name + ".safetensors"), sd,
                                  float_dtype)
        if cfg is not None:
            _write_json(os.path.join(d, "config.json"), cfg)
    rank = next(iter(lora.values()))["A"].shape[-1]
    _write_json(os.path.join(root, "BlobCtrl", "unet_lora",
                             "adapter_config.json"),
                {"r": int(rank), "lora_alpha": lora_alpha,
                 "target_modules": sorted({k.rsplit("/", 1)[-1]
                                           for k in lora})})
    _write_json(os.path.join(root, "dinov2-large", "preprocessor_config.json"),
                {"crop_size": {"height": dino_image_size,
                               "width": dino_image_size},
                 "do_center_crop": True, "do_resize": True})
    if tokenizer is not None:
        save_tokenizer(tokenizer, os.path.join(sd_root, "tokenizer"))
    return total
