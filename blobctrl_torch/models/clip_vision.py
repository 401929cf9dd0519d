"""CLIP vision tower (ViT-L/14), the backbone of the Stable Diffusion safety
checker (counterpart of ``blobctrl_tpu/models/clip_vision.py``).

transformers' CLIPVisionModel: a class token, the patch conv (no bias) and
learned positions, a pre-LN, pre-LN blocks with a quick_gelu MLP, a
post-LN; the pooled output is the post-LN class token. Plain torch in fp32
(TF32 off on the card for the call, ``layers.strict_fp32``);
``preprocess`` is host numpy with the port's copy of PIL's bicubic
resampler, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.models.clip_text import ACTIVATIONS, self_attention
from blobctrl_torch.nn import layers
from blobctrl_torch.utils import resample


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


@torch.inference_mode()
def apply(params, cfg: CLIPVisionConfig, pixel_values, device="cuda"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pixel_values (B, H, W, 3), CLIP-normalized (numpy or a tensor), on
    ``device``, where ``params`` live. -> (last hidden state (B, 1+N, C),
    the pooled class token after the post-LN (B, C))."""
    dev = resolve_device(device)
    if params["class_embedding"].device.type != dev.type:
        raise ValueError(f"params live on {params['class_embedding'].device}"
                         f", the call on {dev}")
    with layers.strict_fp32(dev):
        x = torch.as_tensor(pixel_values, dtype=torch.float32, device=dev)
        b = x.shape[0]
        c = cfg.hidden_size
        x = layers.conv2d(params["patch_embed"], x, stride=cfg.patch_size)
        x = x.reshape(b, -1, c)
        cls = params["class_embedding"][None, None].to(x.dtype)
        x = torch.cat([cls.expand(b, 1, c), x], 1)
        x = x + params["position_embedding"][:x.shape[1]].to(x.dtype)
        eps = cfg.layer_norm_eps
        x = layers.layer_norm(params["pre_layrnorm"], x, eps)
        act = ACTIVATIONS[cfg.hidden_act]
        for layer in params["layers"]:
            h = layers.layer_norm(layer["layer_norm1"], x, eps)
            x = x + self_attention(
                layer["self_attn"], h, cfg.num_heads,
                ("q_proj", "k_proj", "v_proj", "out_proj"))
            h = layers.layer_norm(layer["layer_norm2"], x, eps)
            h = act(layers.linear(layer["mlp"]["fc1"], h))
            x = x + layers.linear(layer["mlp"]["fc2"], h)
        pooled = layers.layer_norm(params["post_layernorm"], x[:, 0], eps)
        return x, pooled


CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess(images01: np.ndarray, size: int = 224) -> np.ndarray:
    """(B, H, W, 3) float in [0, 1] -> CLIP-normalized (B, size, size, 3)
    float32 (CLIPImageProcessor): a uint8 cast by truncation, PIL's bicubic
    resize of the shortest edge to ``size``, a centre crop, /255, the CLIP
    mean and std."""
    out = []
    for img in images01:
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        h, w = u8.shape[:2]
        if h < w:
            nh, nw = size, max(1, round(w * size / h))
        else:
            nh, nw = max(1, round(h * size / w)), size
        u8 = resample.pil_resize(u8, (nw, nh), "bicubic")
        left, top = (nw - size) // 2, (nh - size) // 2
        out.append(u8[top:top + size, left:left + size].astype(np.float32)
                   / 255.0)
    return (np.stack(out) - CLIP_MEAN) / CLIP_STD


def init(cfg: CLIPVisionConfig, seed: int = 0, device="cuda",
         dtype=torch.float32):
    """Random params with the converter's tree structure, drawn on
    ``device``: uniform +-1/sqrt(fan_in) kernels, normal 0.02 class token,
    positions and biases, norm scales 1 + normal 0.02."""
    init_ = layers.ParamInit(seed, resolve_device(device), dtype)
    c, m, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size

    def lin(d_in, d_out):
        return {"kernel": layers.init_linear(init_, d_in, d_out,
                                             use_bias=False)["kernel"],
                "bias": init_.normal((d_out,), 0.02)}

    def norm():
        return {"scale": 1.0 + init_.normal((c,), 0.02),
                "bias": init_.normal((c,), 0.02)}

    n_pos = (cfg.image_size // p) ** 2 + 1
    return {
        "class_embedding": init_.normal((c,), 0.02),
        "patch_embed": layers.init_conv(init_, p, p, 3, c, use_bias=False),
        "position_embedding": init_.normal((n_pos, c), 0.02),
        "pre_layrnorm": norm(),
        "layers": [{"layer_norm1": norm(),
                    "self_attn": {n: lin(c, c) for n in (
                        "q_proj", "k_proj", "v_proj", "out_proj")},
                    "layer_norm2": norm(),
                    "mlp": {"fc1": lin(c, m), "fc2": lin(m, c)}}
                   for _ in range(cfg.num_layers)],
        "post_layernorm": norm(),
    }
