"""UNet down/mid/up blocks with BlobCtrl's residual-injection protocol
(counterpart of ``blobctrl_tpu/nn/unet_blocks.py``).

A residual is added after every resnet(+attention) pair and after every
down/up-sampler. On a double-width feature map (W != H, the width-concat
layout) it lands on the right (noisy) half only.

``remat=True`` recomputes in the backward, at the JAX package's
granularity, each down layer, the mid-block body and each up layer
(``torch.utils.checkpoint``): their kernels then launch twice a step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils import checkpoint

from blobctrl_torch.nn import layers
from blobctrl_torch.nn import resnet as rn
from blobctrl_torch.nn import transformer_2d as t2d


def add_injection(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x + r, or on a double-width x only its right half + r.

    Always out of place: x may already sit on the UNet's skip stack, and r
    may be a BlobNet residual shared by both CFG rows, so neither is
    written."""
    h, w = x.shape[1], x.shape[2]
    r = r.to(x.dtype)
    if w == h:
        return x + r
    return torch.cat([x[:, :, :w - h, :], x[:, :, w - h:, :] + r], dim=2)


class InjectionQueue:
    """Positional consumer of BlobNet residuals."""

    def __init__(self, residuals: Optional[Sequence[torch.Tensor]]):
        self._items = list(residuals) if residuals is not None else None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if self._items is None:
            return x
        return add_injection(x, self._items.pop(0))

    def assert_empty(self):
        if self._items:
            raise ValueError(f"{len(self._items)} unconsumed injection "
                             f"residuals")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_down_block(init: layers.ParamInit, c_in: int, c_out: int,
                    temb_dim: int, num_layers: int, heads: Optional[int],
                    cross_dim: Optional[int], add_downsample: bool,
                    transformer_layers: int = 1):
    """heads=None -> plain DownBlock2D (no attention). ``2 * num_layers +
    1`` children: resnet i the 2i-th, attention i the (2i+1)-th, the
    downsampler the last."""
    keys = init.split(2 * num_layers + 1)
    p = {"resnets": []}
    if heads is not None:
        p["attentions"] = []
    for i in range(num_layers):
        p["resnets"].append(rn.init_resnet_block(
            keys[2 * i], c_in if i == 0 else c_out, c_out, temb_dim))
        if heads is not None:
            p["attentions"].append(t2d.init_transformer_2d(
                keys[2 * i + 1], c_out, transformer_layers, cross_dim))
    if add_downsample:
        p["downsample"] = rn.init_downsample(keys[-1], c_out)
    return p


def init_mid_block(init: layers.ParamInit, channels: int, temb_dim: int,
                   cross_dim: Optional[int],
                   transformer_layers: int = 1):
    k1, k2, k3 = init.split(3)
    return {
        "resnets": [rn.init_resnet_block(k1, channels, channels, temb_dim),
                    rn.init_resnet_block(k2, channels, channels, temb_dim)],
        "attentions": [t2d.init_transformer_2d(k3, channels,
                                               transformer_layers, cross_dim)],
    }


def init_up_block(init: layers.ParamInit, c_in: int, c_out: int,
                  prev_out: int, temb_dim: int, num_layers: int,
                  heads: Optional[int], cross_dim: Optional[int],
                  add_upsample: bool, transformer_layers: int = 1):
    """Children as ``init_down_block``'s, the upsampler the last."""
    keys = init.split(2 * num_layers + 1)
    p = {"resnets": []}
    if heads is not None:
        p["attentions"] = []
    for i in range(num_layers):
        res_skip = c_in if i == num_layers - 1 else c_out
        res_in = prev_out if i == 0 else c_out
        p["resnets"].append(rn.init_resnet_block(keys[2 * i],
                                                 res_in + res_skip, c_out,
                                                 temb_dim))
        if heads is not None:
            p["attentions"].append(t2d.init_transformer_2d(
                keys[2 * i + 1], c_out, transformer_layers, cross_dim))
    if add_upsample:
        p["upsample"] = rn.init_upsample(keys[-1], c_out)
    return p


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _remat(fn, remat: bool, *args):
    """fn(*args), its activations recomputed in the backward when remat."""
    if remat:
        return checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def down_block(params, x: torch.Tensor, temb: torch.Tensor,
               context: Optional[torch.Tensor], heads: Optional[int],
               inject: InjectionQueue, norm_groups: int = 32,
               eps: float = 1e-5, remat: bool = False
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    out_states = []
    attns = params.get("attentions")
    for i, res_p in enumerate(params["resnets"]):
        def layer(x, res_p=res_p, i=i):
            h = rn.resnet_block(res_p, x, temb, norm_groups, eps)
            if attns is not None:
                h = t2d.transformer_2d(attns[i], h, heads, context,
                                       norm_groups)
            return h
        x = inject.apply(_remat(layer, remat, x))
        out_states.append(x)
    if "downsample" in params:
        x = inject.apply(rn.downsample_2d(params["downsample"], x))
        out_states.append(x)
    return x, out_states


def mid_block(params, x: torch.Tensor, temb: torch.Tensor,
              context: Optional[torch.Tensor], heads: int,
              norm_groups: int = 32, eps: float = 1e-5,
              remat: bool = False) -> torch.Tensor:
    def body(x):
        h = rn.resnet_block(params["resnets"][0], x, temb, norm_groups, eps)
        for attn_p, res_p in zip(params["attentions"],
                                 params["resnets"][1:]):
            h = t2d.transformer_2d(attn_p, h, heads, context, norm_groups)
            h = rn.resnet_block(res_p, h, temb, norm_groups, eps)
        return h
    return _remat(body, remat, x)


def up_block(params, x: torch.Tensor, skips: List[torch.Tensor],
             temb: torch.Tensor, context: Optional[torch.Tensor],
             heads: Optional[int], inject: InjectionQueue,
             upsample_hw: Optional[tuple] = None, norm_groups: int = 32,
             eps: float = 1e-5, collect_states: bool = False,
             remat: bool = False
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    out_states = []
    attns = params.get("attentions")
    for i, res_p in enumerate(params["resnets"]):
        def layer(x, skip, res_p=res_p, i=i):
            h = torch.cat([x, skip.to(x.dtype)], dim=-1)
            h = rn.resnet_block(res_p, h, temb, norm_groups, eps)
            if attns is not None:
                h = t2d.transformer_2d(attns[i], h, heads, context,
                                       norm_groups)
            return h
        x = inject.apply(_remat(layer, remat, x, skips.pop()))
        if collect_states:
            out_states.append(x)
    if "upsample" in params:
        x = inject.apply(rn.upsample_2d(params["upsample"], x, upsample_hw))
        if collect_states:
            out_states.append(x)
    return x, out_states
