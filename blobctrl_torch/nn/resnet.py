"""ResnetBlock2D and Down/Upsample in NHWC (counterpart of
``blobctrl_tpu/nn/resnet.py``).

Stride-1 3x3 convs go through ``ops.conv3x3`` wherever the shape qualifies
(its kernel on the card, its plain version on the CPU); inside a resnet
block the GroupNorm statistics are folded into a per-(batch, channel) affine
and the normalize+SiLU runs in the conv's prologue instead of as separate
passes over device memory. With the int8 conv mode on, the routed convs
take the tree's pre-quantized ``kernel_q``/``w_scale`` where present, and
with the Winograd switch on its pre-transformed ``u``.

Under tensor parallelism (``parallel.kernel_sharding``) a resnet block's
conv1 and time_emb_proj are column-parallel (local output channels), its
norm2 and conv2 row-parallel (local channels, one all-reduce); the routing
then sees the local channel counts. The samplers are column-only: their
output channels are gathered before the next layer.
"""

from __future__ import annotations

from typing import Optional

import torch

from blobctrl_torch.nn import layers
from blobctrl_torch.ops import conv3x3 as conv3x3_op
from blobctrl_torch.parallel import kernel_sharding as ks


def route_conv(x: torch.Tensor) -> bool:
    """The JAX package's ``_route_conv`` on its card: ``ops.conv3x3`` when
    h % 8 == 0, w >= 8 and C >= 32; plain ``F.conv2d`` otherwise. The shape
    alone decides; the op picks kernel or plain version by device."""
    _, h, w, c = x.shape
    return h % 8 == 0 and w >= 8 and c >= 32


def _conv3x3_kernel(conv_params, x, scale=None, shift=None):
    return conv3x3_op.conv3x3(x, conv_params["kernel"].to(x.dtype),
                              conv_params.get("bias"), scale, shift,
                              kernel_q=conv_params.get("kernel_q"),
                              w_scale=conv_params.get("w_scale"),
                              u=conv_params.get("u"))


def conv3x3_routed(conv_params, x: torch.Tensor,
                   full: Optional[int] = None) -> torch.Tensor:
    """Stride-1 same-size 3x3 conv (BlobNet's 1029-channel conv_in, the
    up-sampler convs). full: the output width, gathered to it when the
    conv is column-only sharded."""
    if route_conv(x):
        y = _conv3x3_kernel(conv_params, x)
    else:
        y = layers.conv2d(conv_params, x, padding=1)
    return y if full is None else ks.gather_channels(y, full)


def init_resnet_block(init: layers.ParamInit, c_in: int, c_out: int,
                      temb_dim: Optional[int]):
    """Four children, conv1, conv2, time_emb_proj and conv_shortcut, split
    whether or not the last two exist."""
    k1, k2, k3, k4 = init.split(4)
    p = {"norm1": layers.init_norm(init, c_in),
         "conv1": layers.init_conv(k1, 3, 3, c_in, c_out),
         "norm2": layers.init_norm(init, c_out),
         "conv2": layers.init_conv(k2, 3, 3, c_out, c_out)}
    if temb_dim is not None:
        p["time_emb_proj"] = layers.init_linear(k3, temb_dim, c_out)
    if c_in != c_out:
        p["conv_shortcut"] = layers.init_conv(k4, 1, 1, c_in, c_out)
    return p


def resnet_block(params, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                 norm_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    def norm_act_conv(conv_params, norm_params, y):
        if route_conv(y):
            s, sh = layers.group_norm_scale_shift(norm_params, y, norm_groups,
                                                  eps)
            return _conv3x3_kernel(conv_params, y, s, sh)
        y = layers.silu(layers.group_norm(norm_params, y, norm_groups, eps))
        return layers.conv2d(conv_params, y, padding=1)

    h = norm_act_conv(params["conv1"], params["norm1"], x)
    if temb is not None and "time_emb_proj" in params:
        t = layers.linear(params["time_emb_proj"], layers.silu(temb))
        h = h + t[:, None, None, :]
    if ks.split(h.shape[-1], params["conv2"]["kernel"].shape[3]) > 1:
        h = ks.row_conv(_conv3x3_kernel, params["conv2"], params["norm2"], h,
                        norm_groups, eps, route_conv(h))
    else:
        h = norm_act_conv(params["conv2"], params["norm2"], h)
    if "conv_shortcut" in params:
        x = layers.conv2d(params["conv_shortcut"], x)
    return x + h


def init_downsample(init: layers.ParamInit, c: int):
    return {"conv": layers.init_conv(init, 3, 3, c, c)}


def downsample_2d(params, x: torch.Tensor) -> torch.Tensor:
    return ks.gather_channels(
        layers.conv2d(params["conv"], x, stride=2, padding=1), x.shape[-1])


def init_upsample(init: layers.ParamInit, c_in: int,
                  c_out: Optional[int] = None):
    return {"conv": layers.init_conv(init, 3, 3, c_in, c_out or c_in)}


def upsample_2d(params, x: torch.Tensor,
                out_hw: Optional[tuple] = None) -> torch.Tensor:
    if out_hw is None:
        x = layers.nearest_upsample_2x(x)
    else:
        # non-2x sizes only occur for odd inputs: nearest resize
        h, w = x.shape[1:3]
        oh, ow = out_hw
        hi = torch.arange(oh, device=x.device) * h // oh
        wi = torch.arange(ow, device=x.device) * w // ow
        x = x[:, hi][:, :, wi].contiguous()
    return conv3x3_routed(params["conv"], x, params["conv"]["kernel"].shape[2])
