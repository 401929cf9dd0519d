"""BlobNet: a full UNet copy (down + mid + up) whose per-layer activations
are tapped through 1x1 "zero" convolutions and returned as residuals for the
main UNet (counterpart of ``blobctrl_tpu/models/blobnet.py``). For SD-1.5
geometry: 12 down + 1 mid + 15 up residuals per step. Its transformer
blocks self-attend (no cross-attention)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.models import unet as unet_lib
from blobctrl_torch.nn import layers
from blobctrl_torch.nn import resnet as rn
from blobctrl_torch.nn import unet_blocks as ub
from blobctrl_torch.parallel import kernel_sharding as ks
from blobctrl_torch.utils import threefry


@dataclasses.dataclass(frozen=True)
class BlobNetConfig:
    # conv_in consumes in_channels + conditioning_channels
    # (4 latent + 1 score + 1024 DINOv2 splat = 1029 for BlobCtrl)
    in_channels: int = 4
    conditioning_channels: int = 1025
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    layers_per_block: int = 2
    cross_attention_dim: Optional[int] = None
    num_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_layers_per_block: int = 1
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    def as_unet_config(self) -> unet_lib.UNetConfig:
        return unet_lib.UNetConfig(
            in_channels=self.in_channels + self.conditioning_channels,
            out_channels=4, block_out_channels=self.block_out_channels,
            down_block_has_attn=self.down_block_has_attn,
            up_block_has_attn=self.up_block_has_attn,
            layers_per_block=self.layers_per_block,
            cross_attention_dim=self.cross_attention_dim,
            num_heads=self.num_heads, norm_num_groups=self.norm_num_groups,
            norm_eps=self.norm_eps,
            transformer_layers_per_block=self.transformer_layers_per_block,
            flip_sin_to_cos=self.flip_sin_to_cos, freq_shift=self.freq_shift)


def tap_channels(cfg: BlobNetConfig) -> Tuple[List[int], List[int]]:
    """Channels of the down and up taps, in the reference's order."""
    boc, n, lpb = cfg.block_out_channels, len(cfg.block_out_channels), \
        cfg.layers_per_block
    down = [boc[0]]
    for i in range(n):
        down += [boc[i]] * lpb + ([boc[i]] if i < n - 1 else [])
    rev = list(reversed(boc))
    up = []
    for i in range(n):
        up += [rev[i]] * (lpb + 1) + ([rev[i]] if i < n - 1 else [])
    return down, up


# folded into the BlobNet key for the drawn taps, a key outside JAX's tree
TAP_FOLD = 0x74617073  # "taps"


def init_blobnet(cfg: BlobNetConfig, key=0, device="cuda",
                 dtype=torch.float32, zero_taps: bool = True):
    """The JAX ``init_blobnet(key, cfg)``'s tree, leaf for leaf, drawn on
    ``device`` and cast to ``dtype``: ``init_unet(key)``'s less the head,
    with zero 1x1 taps; ``key`` a threefry key or an int, ``PRNGKey(int)``.
    zero_taps=False (no JAX counterpart) draws the taps instead, so that
    the injections carry nontrivial data (trained taps are not zero
    either): tap i, in the order down, mid, up, is ``init_conv`` of
    ``split(fold_in(key, TAP_FOLD), taps)[i]``, and every other leaf stays
    JAX's."""
    init = layers.ParamInit(key, resolve_device(device), dtype)
    params = unet_lib._init_unet(init, cfg.as_unet_config())
    del params["conv_norm_out"], params["conv_out"]  # BlobNet has no head
    down, up = tap_channels(cfg)
    chans = down + [cfg.block_out_channels[-1]] + up
    if zero_taps:
        keys = [init] * len(chans)  # nothing is drawn from them
    else:
        keys = layers.ParamInit(threefry.fold_in(init.key, TAP_FOLD),
                                init.device, dtype).split(len(chans))
    taps = [layers.init_conv(k, 1, 1, c, c, zero=zero_taps)
            for k, c in zip(keys, chans)]
    params["zero_down"] = taps[:len(down)]
    params["zero_mid"] = taps[len(down)]
    params["zero_up"] = taps[len(down) + 1:]
    return params


def from_unet(unet_params, cfg: BlobNetConfig, key=0, device=None,
              dtype=torch.float32):
    """Training-time init (the JAX package's ``from_unet``, the reference's
    ``BlobNetModel.from_unet``): a BlobNet tree with the UNet's weights.
    conv_in's kernel is zero-padded over the conditioning input channels
    (the UNet's channels copy into the first slots, the bias whole); the
    time embedding and every down, mid and up block copy over, the UNet's
    cross-attention and head having no BlobNet counterpart; the 1x1 taps
    keep their zero init. A BlobNet weight without a UNet source raises.
    The tree is built by ``init_blobnet(cfg, key)``, as JAX's
    ``from_unet(unet_params, cfg, key)`` builds it, every drawn leaf then
    replaced. On ``device`` (the UNet's by default), in ``dtype``."""
    if device is None:
        device = unet_params["conv_in"]["kernel"].device
    init = init_blobnet(cfg, key, device, dtype)

    def copy(dst, src, path):
        name = "/".join(map(str, path))
        if isinstance(dst, dict):
            out = {}
            for k, v in dst.items():
                if k in ("zero_down", "zero_mid", "zero_up"):
                    out[k] = v
                    continue
                if k not in src:
                    raise ValueError(f"UNet params missing {name}/{k}")
                out[k] = copy(v, src[k], path + (k,))
            return out
        if isinstance(dst, list):
            if len(src) != len(dst):
                raise ValueError(f"{name}: {len(dst)} BlobNet entries vs "
                                 f"{len(src)} UNet")
            return [copy(d, s, path + (i,))
                    for i, (d, s) in enumerate(zip(dst, src))]
        src = torch.as_tensor(src, device=dst.device)
        if path == ("conv_in", "kernel"):
            if src.shape[2] > dst.shape[2] or (
                    src.shape[:2] + src.shape[3:] != dst.shape[:2]
                    + dst.shape[3:]):
                raise ValueError(f"conv_in: UNet {tuple(src.shape)} does not "
                                 f"embed in {tuple(dst.shape)}")
            out = torch.zeros_like(dst)
            out[:, :, :src.shape[2], :] = src.to(dst.dtype)
            return out
        if src.shape != dst.shape:
            raise ValueError(f"{name}: UNet {tuple(src.shape)} != BlobNet "
                             f"{tuple(dst.shape)}")
        return src.to(dst.dtype).clone()

    return copy(init, unet_params, ())


def num_residuals(cfg: BlobNetConfig) -> Tuple[int, int, int]:
    n, lpb = len(cfg.block_out_channels), cfg.layers_per_block
    return 1 + n * lpb + (n - 1), 1, n * (lpb + 1) + (n - 1)


@ks.scoped("blobnet")
def blobnet_apply(params, cfg: BlobNetConfig, sample: torch.Tensor, timesteps,
                  conditioning_scale: float = 1.0, remat: bool = False
                  ) -> Tuple[List[torch.Tensor], torch.Tensor,
                             List[torch.Tensor]]:
    """sample: (B, H, 2W, 1029) NHWC double-width blob conditioning input.
    Returns (down_residuals, mid_residual, up_residuals) at full double
    width; the pipeline crops the right half before injecting. remat: see
    ``nn.unet_blocks``."""
    ucfg = cfg.as_unet_config()
    timesteps = unet_lib._norm_timesteps(timesteps, sample.shape[0],
                                         sample.device)
    ng, eps, heads = cfg.norm_num_groups, cfg.norm_eps, cfg.num_heads
    emb = unet_lib.time_embed(params, ucfg, timesteps, sample.dtype)
    no_inject = ub.InjectionQueue(None)

    x = rn.conv3x3_routed(params["conv_in"], sample,
                          cfg.block_out_channels[0])
    down_states: List[torch.Tensor] = [x]
    for i, block_p in enumerate(params["down_blocks"]):
        x, states = ub.down_block(
            block_p, x, emb, None,
            heads if cfg.down_block_has_attn[i] else None, no_inject, ng, eps,
            remat)
        down_states.extend(states)
    x = ub.mid_block(params["mid_block"], x, emb, None, heads, ng, eps,
                     remat)
    mid_state = x

    up_states: List[torch.Tensor] = []
    res_stack = list(down_states)
    for i, block_p in enumerate(params["up_blocks"]):
        k = len(block_p["resnets"])
        skips, res_stack = res_stack[-k:], res_stack[:-k]
        upsample_hw = tuple(res_stack[-1].shape[1:3]) if res_stack else None
        x, states = ub.up_block(
            block_p, x, skips, emb, None,
            heads if cfg.up_block_has_attn[i] else None, no_inject,
            upsample_hw, ng, eps, collect_states=True, remat=remat)
        up_states.extend(states)

    # strict zips: a config/checkpoint mismatch raises instead of dropping
    # residuals
    sc = conditioning_scale
    down_res = [layers.conv2d(zp, s) * sc
                for zp, s in zip(params["zero_down"], down_states,
                                 strict=True)]
    mid_res = layers.conv2d(params["zero_mid"], mid_state) * sc
    up_res = [layers.conv2d(zp, s) * sc
              for zp, s in zip(params["zero_up"], up_states, strict=True)]
    return down_res, mid_res, up_res
