"""CLIP text encoder, the ViT-L/14 text tower of SD-1.5's prompt embedding
(counterpart of ``blobctrl_tpu/models/clip_text.py``): token and position
embeddings, pre-LN blocks with a quick_gelu MLP, causal self-attention,
final LayerNorm, and the clip_skip variant.

Plain torch: the JAX package runs this 77-token attention in XLA, not in a
kernel. Scores and softmax are fp32 (the JAX package's
``preferred_element_type``), the probabilities cast back to the compute
dtype before they weigh v.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


ACTIVATIONS = {"quick_gelu": layers.quick_gelu, "gelu": layers.gelu}


def self_attention(params, x: torch.Tensor, heads: int, names,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention of (B, S, C) with the projections
    ``names`` = (q, k, v, out) of ``params``; fp32 scores and softmax."""
    b, s, c = x.shape
    d = c // heads
    q, k, v = (layers.linear(params[n], x).reshape(b, s, heads, d)
               .transpose(1, 2) for n in names[:3])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, c)
    return layers.linear(params[names[3]], out)


def apply(params, cfg: CLIPTextConfig, input_ids: torch.Tensor,
          output_hidden_states: bool = False):
    """input_ids: (B, S) integer. Returns the last hidden state (B, S, C)
    after the final LayerNorm, or (it, hidden_states), hidden_states[i]
    the activations entering layer i."""
    s = input_ids.shape[1]
    ids = input_ids.to(params["token_embedding"].device).long()
    x = params["token_embedding"][ids] + params["position_embedding"][:s]
    eps = cfg.layer_norm_eps
    act = ACTIVATIONS[cfg.hidden_act]
    causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device),
                        diagonal=1)[None, None]
    hidden_states: List[torch.Tensor] = [x]
    for layer in params["layers"]:
        h = layers.layer_norm(layer["layer_norm1"], x, eps)
        x = x + self_attention(layer["self_attn"], h, cfg.num_heads,
                               ("q_proj", "k_proj", "v_proj", "out_proj"),
                               causal)
        h = layers.layer_norm(layer["layer_norm2"], x, eps)
        h = act(layers.linear(layer["mlp"]["fc1"], h))
        x = x + layers.linear(layer["mlp"]["fc2"], h)
        hidden_states.append(x)
    out = layers.layer_norm(params["final_layer_norm"], x, eps)
    if output_hidden_states:
        return out, hidden_states
    return out


def encode_with_clip_skip(params, cfg: CLIPTextConfig,
                          input_ids: torch.Tensor,
                          clip_skip: Optional[int] = None) -> torch.Tensor:
    """clip_skip=None: the final hidden state (after the final LayerNorm);
    clip_skip=k: hidden_states[-(k+2)] through the final LayerNorm."""
    out, hs = apply(params, cfg, input_ids, output_hidden_states=True)
    if clip_skip is None:
        return out
    return layers.layer_norm(params["final_layer_norm"], hs[-(clip_skip + 2)],
                             cfg.layer_norm_eps)


def init(cfg: CLIPTextConfig, key=0, device="cuda", dtype=torch.float32):
    """The JAX ``init(key, cfg)``'s tree, leaf for leaf, drawn on
    ``device`` and cast to ``dtype``; ``key`` a threefry key or an int,
    ``PRNGKey(int)``. ``split(key, 4 + 8 * layers)`` taken in order: the
    token and position embeddings (normal * 0.02), then each layer's q, k,
    v, out, fc1 and fc2 (uniform +-1/sqrt(fan_in))."""
    init_ = layers.ParamInit(key, resolve_device(device), dtype)
    keys = iter(init_.split(4 + 8 * cfg.num_layers))
    c, m = cfg.hidden_size, cfg.intermediate_size
    p = {"token_embedding": next(keys).normal((cfg.vocab_size, c), 0.02),
         "position_embedding": next(keys).normal((cfg.max_positions, c),
                                                 0.02),
         "layers": [],
         "final_layer_norm": layers.init_norm(init_, c)}
    for _ in range(cfg.num_layers):
        p["layers"].append({
            "layer_norm1": layers.init_norm(init_, c),
            "self_attn": {n: layers.init_linear(next(keys), c, c)
                          for n in ("q_proj", "k_proj", "v_proj",
                                    "out_proj")},
            "layer_norm2": layers.init_norm(init_, c),
            "mlp": {"fc1": layers.init_linear(next(keys), c, m),
                    "fc2": layers.init_linear(next(keys), m, c)},
        })
    return p
