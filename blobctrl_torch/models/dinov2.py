"""DINOv2 vision transformer, the appearance encoder (counterpart of
``blobctrl_tpu/models/dinov2.py``): patch conv (14x14, stride 14) + CLS +
bicubically interpolated position embeddings; pre-LN blocks with
per-channel LayerScale and an exact-erf gelu MLP; final LayerNorm; the
pooled output is the CLS token.

Plain torch, as the JAX package leaves it to XLA. Host preprocessing
(``preprocess_u8``) resizes with the port's copy of PIL's bicubic
resampler (``utils/resample``), bit for bit, and the device normalizes in
fp32 (``normalize_pixels``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.models.clip_text import self_attention
from blobctrl_torch.nn import layers
from blobctrl_torch.utils import resample


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    image_size: int = 518  # checkpoint-native grid of the position table

    @staticmethod
    def large() -> "DINOv2Config":
        return DINOv2Config()


def torch_bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) matrix of ``F.interpolate(mode='bicubic',
    align_corners=False)`` without antialias (a = -0.75), built on the
    host in float64."""
    a = -0.75

    def cubic(x):
        x = np.abs(x)
        return np.where(
            x <= 1, ((a + 2) * x - (a + 3)) * x * x + 1,
            np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))

    coords = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    base = np.floor(coords).astype(np.int64)
    frac = coords - base
    mat = np.zeros((dst, src))
    for k in range(-1, 3):
        np.add.at(mat, (np.arange(dst), np.clip(base + k, 0, src - 1)),
                  cubic(k - frac))
    return mat


def interpolate_pos_embed(pos: torch.Tensor, src_grid: int,
                          dst_hw: Tuple[int, int]) -> torch.Tensor:
    """(1+N, C) position table -> (1+gh*gw, C): CLS untouched, the patch
    grid resized bicubically (torch's rule, no antialias) in fp32."""
    gh, gw = dst_hw
    if src_grid == gh == gw:
        return pos
    c = pos.shape[-1]
    grid = pos[1:].reshape(src_grid, src_grid, c).float()
    wh = torch.as_tensor(torch_bicubic_matrix(src_grid, gh), dtype=torch.float32,
                         device=pos.device)
    ww = torch.as_tensor(torch_bicubic_matrix(src_grid, gw), dtype=torch.float32,
                         device=pos.device)
    resized = torch.einsum("hs,swc,wt->htc", wh, grid, ww.T)
    return torch.cat([pos[:1], resized.reshape(gh * gw, c).to(pos.dtype)], 0)


def apply(params, cfg: DINOv2Config, pixel_values: torch.Tensor):
    """pixel_values (B, H, W, 3), ImageNet-normalized. Returns (last hidden
    state (B, 1+N, C), pooled output (B, C))."""
    b = pixel_values.shape[0]
    p = cfg.patch_size
    x = layers.conv2d(params["patch_embed"], pixel_values, stride=p)
    gh, gw = x.shape[1], x.shape[2]
    x = x.reshape(b, gh * gw, -1)
    cls = params["cls_token"].to(x.dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], 1)
    pos = interpolate_pos_embed(params["position_embeddings"],
                                cfg.image_size // p, (gh, gw))
    x = x + pos.to(x.dtype)
    eps = cfg.layer_norm_eps
    for layer in params["layers"]:
        h = layers.layer_norm(layer["norm1"], x, eps)
        x = x + layer["ls1"] * self_attention(layer["attn"], h,
                                              cfg.num_heads,
                                              ("q", "k", "v", "out"))
        h = layers.layer_norm(layer["norm2"], x, eps)
        h = layers.gelu(layers.linear(layer["mlp"]["fc1"], h))
        x = x + layer["ls2"] * layers.linear(layer["mlp"]["fc2"], h)
    x = layers.layer_norm(params["layernorm"], x, eps)
    return x, x[:, 0]


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_u8(images_uint8: np.ndarray, size: int = 224,
                  short_edge: Optional[int] = None) -> np.ndarray:
    """(B, H, W, 3) uint8 RGB -> bicubic resize of the shortest side to
    ``short_edge`` (256 for the published DINOv2 processors), center crop
    ``size``; uint8, the exact intermediate (PIL's resampler re-quantizes),
    normalized on the device by ``normalize_pixels``."""
    if short_edge is None:
        short_edge = 256 if size == 224 else size
    out = []
    for img in np.asarray(images_uint8, np.uint8):
        h, w = img.shape[:2]
        if h < w:
            nh, nw = short_edge, max(1, round(w * short_edge / h))
        else:
            nh, nw = max(1, round(h * short_edge / w)), short_edge
        img = resample.pil_resize(img, (nw, nh), "bicubic")
        if min(nh, nw) < size:
            raise ValueError(f"short edge {short_edge} below the crop {size}")
        left, top = (nw - size) // 2, (nh - size) // 2
        out.append(img[top:top + size, left:left + size])
    return np.stack(out)


def normalize_pixels(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> fp32 ImageNet-normalized: 1/255, minus the
    mean, over the std, in fp32."""
    x = x.float() / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def preprocess(images_uint8: np.ndarray, size: int = 224,
               short_edge: Optional[int] = None) -> np.ndarray:
    """The host-side image processor (the JAX package's ``preprocess``, as
    its training data calls it): (B, H, W, 3) uint8 RGB -> ``preprocess_u8``
    then ``normalize_pixels`` -> float32 ImageNet-normalized numpy."""
    u8 = torch.from_numpy(preprocess_u8(images_uint8, size, short_edge))
    return normalize_pixels(u8).numpy()


def init(cfg: DINOv2Config, key=0, device="cuda", dtype=torch.float32):
    """The JAX ``init(key, cfg)``'s tree, leaf for leaf, drawn on
    ``device`` and cast to ``dtype``; ``key`` a threefry key or an int,
    ``PRNGKey(int)``. ``split(key, 4 + 8 * layers)`` taken in order: the
    patch embedding (uniform +-1/sqrt(fan_in)), the CLS token and the
    position table (normal * 0.02), then each layer's q, k, v, out, fc1
    and fc2; LayerScale 1e-5."""
    init_ = layers.ParamInit(key, resolve_device(device), dtype)
    keys = iter(init_.split(4 + 8 * cfg.num_layers))
    c, m = cfg.hidden_size, cfg.intermediate_size
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    p = {"patch_embed": layers.init_conv(next(keys), cfg.patch_size,
                                         cfg.patch_size, 3, c),
         "cls_token": next(keys).normal((1, c), 0.02),
         "position_embeddings": next(keys).normal((n_pos, c), 0.02),
         "layers": [],
         "layernorm": layers.init_norm(init_, c)}
    for _ in range(cfg.num_layers):
        p["layers"].append({
            "norm1": layers.init_norm(init_, c),
            "attn": {n: layers.init_linear(next(keys), c, c)
                     for n in ("q", "k", "v", "out")},
            "ls1": init_.ones((c,)) * 1e-5,
            "norm2": layers.init_norm(init_, c),
            "mlp": {"fc1": layers.init_linear(next(keys), c, m),
                    "fc2": layers.init_linear(next(keys), m, c)},
            "ls2": init_.ones((c,)) * 1e-5,
        })
    return p
