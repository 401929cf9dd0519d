"""The Stable Diffusion safety checker (counterpart of
``blobctrl_tpu/models/safety_checker.py``): CLIP vision image embeddings,
projected, against concept embeddings with per-concept thresholds, the
cosine logic of diffusers' StableDiffusionSafetyChecker:

  special_cos = cos(projected, special_care_embeds) -> special scores
  concept_cos = cos(projected, concept_embeds)      -> NSFW if any > 0

with a 0.01 adjustment when a special-care concept triggers. The reference
registers the checker but comments out its call; here, as in the JAX
package, the policy is the pipeline's explicit ``safety_checker`` argument
(``functools.partial(check, params, cfg)``) and ``blackout_nsfw``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.models import clip_vision
from blobctrl_torch.nn import layers
from blobctrl_torch.params.convert import (Leaf, _convert_param, _put,
                                           _to_np, _tokenize)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    return an @ bn.T


def scores(params, cfg: clip_vision.CLIPVisionConfig, images01: np.ndarray,
           device="cuda"):
    """-> (pooled CLIP embedding (B, C), special-care scores (B, S),
    concept scores (B, K)) on ``device``; a concept score above 0 flags."""
    px = clip_vision.preprocess(np.asarray(images01, np.float32),
                                cfg.image_size)
    _, pooled = clip_vision.apply(params["vision"], cfg, px, device=device)
    with torch.inference_mode(), layers.strict_fp32(device):
        embeds = layers.linear(params["visual_projection"], pooled)
        special_scores = (_cosine(embeds, params["special_care_embeds"])
                          - params["special_care_embeds_weights"][None])
        special_care = torch.any(special_scores > 0, dim=-1, keepdim=True)
        adjustment = torch.where(special_care, 0.01, 0.0)
        concept_scores = (_cosine(embeds, params["concept_embeds"])
                          - params["concept_embeds_weights"][None]
                          + adjustment)
    return pooled, special_scores, concept_scores


def check(params, cfg: clip_vision.CLIPVisionConfig, images01: np.ndarray,
          device="cuda") -> np.ndarray:
    """images01: (B, H, W, 3) float in [0, 1]. -> (B,) bool, has NSFW."""
    _, _, concept_scores = scores(params, cfg, images01, device)
    return torch.any(concept_scores > 0, dim=-1).cpu().numpy()


def blackout(images01: np.ndarray, has_nsfw: np.ndarray) -> np.ndarray:
    out = np.asarray(images01).copy()
    out[np.asarray(has_nsfw)] = 0.0
    return out


def convert_safety_checker(state_dict, leaf: Optional[Leaf] = None
                           ) -> Dict[str, Any]:
    """diffusers' StableDiffusionSafetyChecker state dict -> the tree."""
    vis_sd = {k[len("vision_model."):]: v for k, v in state_dict.items()
              if k.startswith("vision_model.")}
    tree: Dict[str, Any] = {"vision": convert_clip_vision(vis_sd, leaf)}
    _put(tree, leaf, ["visual_projection", "kernel"],
         _to_np(state_dict["visual_projection.weight"]).T)
    for k in ("concept_embeds", "concept_embeds_weights",
              "special_care_embeds", "special_care_embeds_weights"):
        _put(tree, leaf, [k], _to_np(state_dict[k]))
    return tree


def convert_clip_vision(state_dict, leaf: Optional[Leaf] = None
                        ) -> Dict[str, Any]:
    """transformers' CLIPVisionModel state dict -> the CLIP vision tree."""
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        path = _tokenize(key.replace("vision_model.", ""))
        arr = _to_np(tensor)
        if path[0] == "embeddings":
            if path[1] == "class_embedding":
                _put(tree, leaf, ["class_embedding"], arr)
            elif path[1] == "patch_embedding":
                _put(tree, leaf, ["patch_embed", "kernel"],
                     arr.transpose(2, 3, 1, 0))
            elif path[1] == "position_embedding":
                _put(tree, leaf, ["position_embedding"], arr)
            continue  # position_ids
        if path[0] == "encoder":
            path = path[1:]
        new_path, arr = _convert_param(path, arr)
        _put(tree, leaf, new_path, arr)
    return tree


def init(cfg: clip_vision.CLIPVisionConfig, projection_dim: int = 768,
         n_concepts: int = 17, n_special: int = 3, key=0,
         device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random checker params on ``device``: the CLIP vision tower
    (``clip_vision.init``), a uniform projection, unit-normal concept and
    special-care embeddings, every threshold 0. The JAX package has no
    init for it (it converts the published weights). The key tree: the
    tower draws from the first of ``split(key)``; a split chain of the
    second (``ParamInit.chain``) gives the projection's key, then the
    concept and special-care embeddings'; ``key`` a threefry key or an
    int, ``PRNGKey(int)``."""
    k_vision, k_head = layers.ParamInit(key, resolve_device(device),
                                        dtype).split()
    keys = k_head.chain()
    c = cfg.hidden_size
    return {
        "vision": clip_vision.init(cfg, k_vision.key, device, dtype),
        "visual_projection": layers.init_linear(next(keys), c,
                                                projection_dim,
                                                use_bias=False),
        "concept_embeds": next(keys).normal((n_concepts, projection_dim),
                                            1.0),
        "concept_embeds_weights": k_head.zeros((n_concepts,)),
        "special_care_embeds": next(keys).normal((n_special,
                                                  projection_dim), 1.0),
        "special_care_embeds_weights": k_head.zeros((n_special,)),
    }
