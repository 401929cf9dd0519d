"""Functional NN primitives over NHWC tensors and params dicts.

Counterpart of ``blobctrl_tpu/nn/layers.py``. Every layer is a pair:
  * ``init_*(init, ...) -> params``, drawing from a seeded ``ParamInit``;
  * ``apply(params, x, ...) -> y``, a plain function over tensors.

Conv kernels are HWIO and linear kernels (in, out), as in the JAX package.
GroupNorm and LayerNorm statistics are fp32 whatever the compute dtype.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class ParamInit:
    """Seeded parameter drawing on one device: uniform +-1/sqrt(fan_in)
    kernels (the JAX package's ``init_linear`` / ``init_conv`` bounds), zero
    biases, unit norm scales. The generator lives on ``device``, so weights
    are drawn where they are used."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def uniform(self, shape, bound: float) -> torch.Tensor:
        t = torch.empty(shape, device=self.device, dtype=torch.float32)
        t.uniform_(-bound, bound, generator=self.gen)
        return t.to(self.dtype)

    def normal(self, shape, std: float) -> torch.Tensor:
        t = torch.empty(shape, device=self.device, dtype=torch.float32)
        t.normal_(0.0, std, generator=self.gen)
        return t.to(self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)


def init_linear(init: ParamInit, d_in: int, d_out: int, use_bias: bool = True):
    p = {"kernel": init.uniform((d_in, d_out), 1.0 / math.sqrt(d_in))}
    if use_bias:
        p["bias"] = init.zeros((d_out,))
    return p


def init_conv(init: ParamInit, kh: int, kw: int, c_in: int, c_out: int,
              use_bias: bool = True, zero: bool = False):
    if zero:
        kernel = init.zeros((kh, kw, c_in, c_out))
    else:
        kernel = init.uniform((kh, kw, c_in, c_out),
                              1.0 / math.sqrt(c_in * kh * kw))
    p = {"kernel": kernel}
    if use_bias:
        p["bias"] = init.zeros((c_out,))
    return p


def init_norm(init: ParamInit, c: int):
    return {"scale": init.ones((c,)), "bias": init.zeros((c,))}


# ---------------------------------------------------------------------------
# Linear / Conv2D (NHWC x HWIO)
# ---------------------------------------------------------------------------

def linear(params, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, params["kernel"].to(x.dtype))
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


Padding = Union[int, Tuple[int, int], Tuple[Tuple[int, int], Tuple[int, int]]]


def _pads(padding: Padding):
    """-> ((top, bottom), (left, right))."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    if isinstance(padding[0], int):
        return (padding[0], padding[0]), (padding[1], padding[1])
    return tuple(padding[0]), tuple(padding[1])


def conv2d(params, x: torch.Tensor, stride: int = 1,
           padding: Padding = 0) -> torch.Tensor:
    """2-D convolution of an NHWC input with an HWIO kernel; returns a
    contiguous NHWC tensor."""
    w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    xn = x.permute(0, 3, 1, 2)
    (pt, pb), (pl, pr) = _pads(padding)
    if pt == pb and pl == pr:
        y = F.conv2d(xn, w, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), w, stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y.contiguous()


# ---------------------------------------------------------------------------
# Normalization (fp32 statistics)
# ---------------------------------------------------------------------------

def _group_moments(x: torch.Tensor, num_groups: int):
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    return xf, mean, var


def group_norm(params, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over an NHWC (or N...C) tensor; stats over (spatial, C/G)."""
    xf, mean, var = _group_moments(x, num_groups)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = xf * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def group_norm_scale_shift(params, x: torch.Tensor, num_groups: int,
                           eps: float = 1e-5):
    """Fold GroupNorm statistics into fp32 per-(batch, channel) affine terms
    (N, C) with ``group_norm(params, x) == x * scale + shift`` up to
    rounding: the prologue the fused conv3x3 kernel applies on load."""
    n, c = x.shape[0], x.shape[-1]
    g = num_groups
    _, mean, var = _group_moments(x, g)
    rs = torch.rsqrt(var + eps).expand(n, 1, g, c // g).reshape(n, c)
    mu = mean.expand(n, 1, g, c // g).reshape(n, c)
    scale = rs * params["scale"].float()[None]
    shift = params["bias"].float()[None] - mu * scale
    return scale, shift


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if params is not None:
        xf = xf * params["scale"].float()
        if "bias" in params:
            xf = xf + params["bias"].float()
    return xf.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / resampling
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact erf formulation (torch's default)."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NHWC."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NHWC with half-pixel centers (torch's
    ``interpolate(mode='bilinear', align_corners=False)``), in fp32 and
    cast back, gathering rows then columns as the JAX package does."""
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    xf = x.float()

    def axis_weights(in_size, out_size):
        coords = ((torch.arange(out_size, dtype=torch.float32, device=x.device)
                   + 0.5) * (in_size / out_size) - 0.5)
        coords = torch.clamp(coords, 0.0, in_size - 1)
        lo = torch.floor(coords).long()
        hi = torch.clamp(lo + 1, max=in_size - 1)
        return lo, hi, coords - lo.float()

    hlo, hhi, hfrac = axis_weights(h, out_h)
    wlo, whi, wfrac = axis_weights(w, out_w)
    top, bot = xf[:, hlo], xf[:, hhi]
    rows = top + (bot - top) * hfrac[None, :, None, None]
    left, right = rows[:, :, wlo], rows[:, :, whi]
    return (left + (right - left) * wfrac[None, None, :, None]).to(x.dtype)
