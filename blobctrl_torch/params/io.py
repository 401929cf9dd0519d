"""Checkpoint IO: safetensors / torch-pickle files -> the port's param trees
(counterpart of ``blobctrl_tpu/params/io.py``).

Loads the artifact layout of the reference's downloader:

  models/
    stable-diffusion-v1-5/{unet,vae,text_encoder,tokenizer}/
    BlobCtrl/blobnet/diffusion_pytorch_model.safetensors
    BlobCtrl/unet_lora/... (PEFT format, adapter_config.json)
    dinov2-large/model.safetensors, preprocessor_config.json
    sam/sam_vit_h_4b8939.pth

Weights are read through a memory map, converted to the tree's layout and
moved to the device one leaf at a time: the host never holds a float32 copy
of a whole net. LoRA merges into each target kernel in float32 on the
device, before the cast to the compute dtype.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import zipfile
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.apps import flagship
from blobctrl_torch.models import lora as lora_lib
from blobctrl_torch.nn.layers import sorted_tree
from blobctrl_torch.params import config_io, convert, convert_sam
from blobctrl_torch.pipeline import BlobNetPipeline
from blobctrl_torch.tokenizer import clip_bpe

# safetensors dtype -> numpy dtype (little-endian); BF16 is decoded
ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
             "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
             "U8": "u1", "BOOL": "?"}


class SafetensorsFile(Mapping):
    """name -> array of one .safetensors file (the u64 header length, the
    JSON header, raw little-endian data), read through a memory map: each
    array is a view of the file, except BF16, which numpy lacks and which
    is decoded to float32 (the uint16 bits shifted into the high half) each
    time it is read."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        for name, info in header.items():
            if info["dtype"] not in ST_DTYPES:
                raise ValueError(f"{path}: {name}: unsupported dtype "
                                 f"{info['dtype']}")
        self._header = header
        size = os.path.getsize(path) - 8 - n
        # copy-on-write: the views are writable (torch wraps them without
        # a copy) and the file is never written
        self._data = (np.memmap(path, np.uint8, mode="c", offset=8 + n)
                      if size > 0 else np.zeros(0, np.uint8))

    def __getitem__(self, name: str) -> np.ndarray:
        info = self._header[name]
        start, end = info["data_offsets"]
        arr = self._data[start:end].view(np.dtype(ST_DTYPES[info["dtype"]]))
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.reshape(info["shape"])

    def __iter__(self) -> Iterator[str]:
        return iter(self._header)

    def __len__(self) -> int:
        return len(self._header)


def load_safetensors(path: str) -> SafetensorsFile:
    """name -> array of a .safetensors file, through a memory map."""
    return SafetensorsFile(path)


def _load_model_dir(model_dir: str) -> Mapping:
    """name -> array of a diffusers / transformers model directory: its
    safetensors shards (a later shard wins a repeated name), else its
    torch ``.bin`` / ``.pth`` files."""
    names = sorted(os.listdir(model_dir))
    st = [n for n in names if n.endswith(".safetensors")]
    if st:
        return collections.ChainMap(*[
            load_safetensors(os.path.join(model_dir, n))
            for n in reversed(st)])
    bins = [n for n in names if n.endswith((".bin", ".pth"))]
    if bins:
        out: Dict[str, Any] = {}
        for n in bins:
            out.update(torch.load(os.path.join(model_dir, n),
                                  map_location="cpu", weights_only=True))
        return out
    raise FileNotFoundError(f"no weights in {model_dir}")


def _device_leaf(device, dtype, merge: Optional[Callable] = None):
    """A converter leaf that moves each array to ``device`` in its stored
    dtype, makes floats float32 there, applies ``merge(path, tensor)`` and
    casts them to ``dtype``. A converter's layout change is a permuted view
    of the stored block: the block moves as it is stored and is permuted on
    the device."""
    dev = resolve_device(device)

    def leaf(path, arr):
        order = sorted(range(arr.ndim), key=lambda d: -arr.strides[d])
        t = torch.from_numpy(np.ascontiguousarray(arr.transpose(order)))
        t = t.to(dev).permute(*np.argsort(order).tolist()).contiguous()
        if not t.is_floating_point():
            return t
        t = t.float()
        if merge is not None:
            t = merge(path, t)
        return t.to(dtype)
    return leaf


def _load_tree(model_dir: str, convert_fn, device, dtype, merge=None):
    leaf = _device_leaf(device, dtype, merge)  # refuse a missing card first
    return convert_fn(_load_model_dir(model_dir), leaf=leaf)


def widen_conv_in(unet_tree: Dict[str, Any], new_in: int = 5
                  ) -> Dict[str, Any]:
    """Widen conv_in's input channels with zero-initialized ones (the
    reference widens SD-1.5's 4 channels to 5 for the score map)."""
    k = unet_tree["conv_in"]["kernel"]
    kh, kw, cin, cout = k.shape
    if cin >= new_in:
        return unet_tree
    pad = torch.zeros((kh, kw, new_in - cin, cout), dtype=k.dtype,
                      device=k.device)
    unet_tree["conv_in"]["kernel"] = torch.cat([k, pad], dim=2)
    return unet_tree


def load_sd15_unet(unet_dir: str, widen_to: Optional[int] = 5,
                   device="cuda", dtype=torch.float32):
    tree = _load_tree(unet_dir, convert.convert_unet, device, dtype)
    return widen_conv_in(tree, widen_to) if widen_to else tree


def load_blobnet(blobnet_dir: str, device="cuda", dtype=torch.float32):
    return _load_tree(blobnet_dir, convert.convert_unet, device, dtype)


def load_vae(vae_dir: str, device="cuda", dtype=torch.float32):
    return _load_tree(vae_dir, convert.convert_vae, device, dtype)


def load_clip_text(text_encoder_dir: str, device="cuda",
                   dtype=torch.float32):
    return _load_tree(text_encoder_dir, convert.convert_clip_text, device,
                      dtype)


def load_dinov2(dinov2_dir: str, device="cuda", dtype=torch.float32):
    return _load_tree(dinov2_dir, convert.convert_dinov2, device, dtype)


def load_sam(path: str, device="cuda"):
    """A SAM checkpoint (a torch pickle in the original segment_anything
    key format, ``sam/sam_vit_h_4b8939.pth`` in the reference's layout, or
    transformers') -> the SAM param tree on ``device``, in fp32, as the
    predictor runs it. The file is read through a memory map where its
    format allows, each leaf moved to the device on its own."""
    leaf = _device_leaf(device, torch.float32)  # refuse a missing card first
    sd = torch.load(path, map_location="cpu", weights_only=True,
                    mmap=zipfile.is_zipfile(path))
    if isinstance(sd, dict) and "state_dict" in sd and all(
            hasattr(v, "shape") for v in sd["state_dict"].values()):
        sd = sd["state_dict"]
    return convert_sam.convert_sam(sd, leaf=leaf)


def load_lora_dir(lora_dir: str, alpha: Optional[float] = None,
                  device="cuda"):
    """-> (adapter dict of float32 tensors on ``device``, alpha): alpha from
    the PEFT ``adapter_config.json``'s lora_alpha unless given."""
    dev = resolve_device(device)
    tree = lora_lib.convert_lora_state_dict(_load_model_dir(lora_dir))
    cfg_path = os.path.join(lora_dir, "adapter_config.json")
    if alpha is None and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            alpha = json.load(f).get("lora_alpha")
    return ({k: {n: torch.from_numpy(a).to(dev) for n, a in ab.items()}
             for k, ab in tree.items()}, alpha)


def _lora_merge(lora_tree, scale: float, alpha):
    """A leaf merge that adds each adapter to its target kernel."""
    def merge(path, t):
        key = "/".join(map(str, path[:-1]))
        if path[-1] == "kernel" and key in lora_tree:
            return lora_lib.merge_kernel(t, lora_tree[key], scale, alpha, key)
        return t
    return merge


def _maybe_config(model_dir: str, from_json, default):
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return from_json(json.load(f))


def load_pipeline(models_root: str, dtype=torch.bfloat16,
                  lora_scale: float = 1.0, device="cuda") -> BlobNetPipeline:
    """A BlobNetPipeline from the reference's checkpoint layout under
    ``models_root``, on ``device`` in ``dtype``. Each net's config comes
    from its config.json (the flagship's where there is none), the DINOv2
    input size from dinov2-large/preprocessor_config.json's crop, the
    tokenizer from its vocab.json / merges.txt. The UNet's conv_in is
    widened to 5 channels and the PEFT LoRA is merged at ``lora_scale`` and
    recorded, so ``BlobNetPipeline.set_lora_scale`` can rescale it."""
    dev = resolve_device(device)
    sd_root = os.path.join(models_root, "stable-diffusion-v1-5")
    blob_dir = os.path.join(models_root, "BlobCtrl", "blobnet")
    dino_dir = os.path.join(models_root, "dinov2-large")
    unet_cfg = _maybe_config(os.path.join(sd_root, "unet"),
                             config_io.unet_config_from_diffusers,
                             flagship.sd15_unet_config())
    if unet_cfg.in_channels == 4:  # widened at load
        unet_cfg = dataclasses.replace(unet_cfg, in_channels=5)
    blobnet_cfg = _maybe_config(blob_dir,
                                config_io.blobnet_config_from_diffusers,
                                flagship.blobctrl_blobnet_config())
    clip_cfg = _maybe_config(os.path.join(sd_root, "text_encoder"),
                             config_io.clip_text_config_from_transformers,
                             flagship.clip_vit_l_config())
    dino_cfg = _maybe_config(dino_dir,
                             config_io.dinov2_config_from_transformers,
                             flagship.dinov2_large_config())
    vae_cfg = _maybe_config(os.path.join(sd_root, "vae"),
                            config_io.vae_config_from_diffusers,
                            flagship.sd15_vae_config())
    # the DINOv2 input size is the image processor's crop, not the model
    # config's image_size (the reference preprocesses through its processor)
    dino_image_size = 224
    pp_path = os.path.join(dino_dir, "preprocessor_config.json")
    if os.path.exists(pp_path):
        with open(pp_path) as f:
            crop = json.load(f).get("crop_size") or {}
        dino_image_size = int(crop.get("height", dino_image_size))

    lora_tree, alpha = load_lora_dir(
        os.path.join(models_root, "BlobCtrl", "unet_lora"), device=dev)
    unet = widen_conv_in(_load_tree(
        os.path.join(sd_root, "unet"), convert.convert_unet, dev, dtype,
        merge=_lora_merge(lora_tree, lora_scale, alpha)), 5)
    tok_dir = os.path.join(sd_root, "tokenizer")
    # every tree key-sorted, as the JAX package's loader gives it (its
    # cast is a tree_map): the order a LoRA's init draws its targets in
    # and training flattens its state in
    pipe = BlobNetPipeline(
        unet_cfg=unet_cfg, unet_params=sorted_tree(unet),
        blobnet_cfg=blobnet_cfg,
        blobnet_params=sorted_tree(load_blobnet(blob_dir, dev, dtype)),
        vae_cfg=vae_cfg,
        vae_params=sorted_tree(load_vae(os.path.join(sd_root, "vae"), dev,
                                        dtype)),
        clip_cfg=clip_cfg,
        clip_params=sorted_tree(load_clip_text(
            os.path.join(sd_root, "text_encoder"), dev, dtype)),
        dino_cfg=dino_cfg,
        dino_params=sorted_tree(load_dinov2(dino_dir, dev, dtype)),
        tokenizer=(clip_bpe.CLIPTokenizer.from_dir(tok_dir)
                   if os.path.isdir(tok_dir) else None),
        dino_image_size=dino_image_size, dtype=dtype, device=dev)
    pipe._lora_tree, pipe._lora_alpha = lora_tree, alpha
    pipe._lora_scale = lora_scale
    return pipe
