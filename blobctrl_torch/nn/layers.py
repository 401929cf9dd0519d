"""Functional NN primitives over NHWC tensors and params dicts.

Counterpart of ``blobctrl_tpu/nn/layers.py``. Every layer is a pair:
  * ``init_*(init, ...) -> params``, drawing from a ``ParamInit``, the key
    the JAX ``init_*`` takes, split down the tree as JAX splits it;
  * ``apply(params, x, ...) -> y``, a plain function over tensors.

Conv kernels are HWIO and linear kernels (in, out), as in the JAX package.
GroupNorm and LayerNorm statistics are fp32 whatever the compute dtype.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from blobctrl_torch.utils import threefry


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class ParamInit:
    """One key of a parameter tree, with the device its leaves are drawn on
    and the dtype they are cast to.

    The JAX package's ``init_*`` functions take a key and split it down
    the tree (``jax.random.split``): each composite hands child i to its
    part i, and ``init_linear`` / ``init_conv`` draw their kernel from the
    first of two children. A leaf's key so depends on its place in the
    tree, never on how many leaves were drawn before it. A ``ParamInit`` is
    such a key: ``split(n)`` gives its n children, ``uniform`` and
    ``normal`` draw one leaf from it with ``utils.threefry`` (the bits
    ``jax.random`` draws for the key) on ``device``, in float32 as JAX
    draws, then cast to ``dtype`` as the loaders cast JAX's trees.
    ``key``: a threefry key, or an int read as ``PRNGKey(int)``."""

    def __init__(self, key, device, dtype=torch.float32):
        self.key = threefry.as_key(key)
        self.device = torch.device(device)
        self.dtype = dtype

    def _child(self, key) -> "ParamInit":
        return ParamInit(key, self.device, self.dtype)

    def split(self, num: int = 2):
        """``jax.random.split(key, num)``: the ``num`` children."""
        return [self._child(k) for k in threefry.split(self.key, num)]

    def chain(self):
        """Children without end, ``key, sub = split(key)`` and ``sub`` each
        time: a split chain for trees drawn leaf after leaf in their
        order."""
        key = self.key
        while True:
            key, sub = threefry.split(key)
            yield self._child(sub)

    def _draw(self, shape, fn, scale=None) -> torch.Tensor:
        """``fn(key, shape)`` (times ``scale``, in float32) cast to
        ``dtype``, drawn DRAW_BLOCK elements at a time over the flat
        index (a threefry element depends on its flat index only), so a
        large leaf's int64 temporaries stay small."""
        n = math.prod(shape)
        out = torch.empty(n, device=self.device, dtype=self.dtype)
        for a in range(0, n, DRAW_BLOCK):
            block = fn(self.key, (n,), rows=range(a, min(n, a + DRAW_BLOCK)),
                       device=self.device)
            out[a:a + len(block)] = block if scale is None else block * scale
        return out.reshape(shape)

    def uniform(self, shape, bound: float) -> torch.Tensor:
        """``jax.random.uniform(key, shape, float32, -bound, bound)``."""
        return self._draw(shape, functools.partial(
            threefry.uniform, minval=-bound, maxval=bound))

    def normal(self, shape, std: float) -> torch.Tensor:
        """``jax.random.normal(key, shape) * std``, the product in
        float32."""
        return self._draw(shape, threefry.normal, std)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)


def sorted_tree(tree):
    """``tree`` with every dict's keys sorted, as JAX orders a tree it
    rebuilds (``cast``'s ``tree_map``, and so the JAX package's loaded
    pipeline): the order its leaves are flattened, drawn and reduced in."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [sorted_tree(v) for v in tree]
    return tree


# elements a leaf is drawn by at a time: 128 MiB an int64 temporary
DRAW_BLOCK = 1 << 24


def init_linear(init: ParamInit, d_in: int, d_out: int, use_bias: bool = True):
    """JAX ``init_linear``: the kernel from the first of ``split(key)``,
    uniform +-1/sqrt(d_in); a zero bias."""
    k1, _ = init.split()
    p = {"kernel": k1.uniform((d_in, d_out), 1.0 / math.sqrt(d_in))}
    if use_bias:
        p["bias"] = init.zeros((d_out,))
    return p


def init_conv(init: ParamInit, kh: int, kw: int, c_in: int, c_out: int,
              use_bias: bool = True, zero: bool = False):
    """JAX ``init_conv``: the HWIO kernel from the first of ``split(key)``,
    uniform +-1/sqrt(fan_in), or zeros (the key split all the same); a
    zero bias."""
    k1, _ = init.split()
    if zero:
        kernel = init.zeros((kh, kw, c_in, c_out))
    else:
        kernel = k1.uniform((kh, kw, c_in, c_out),
                            1.0 / math.sqrt(c_in * kh * kw))
    p = {"kernel": kernel}
    if use_bias:
        p["bias"] = init.zeros((c_out,))
    return p


def init_norm(init: ParamInit, c: int):
    return {"scale": init.ones((c,)), "bias": init.zeros((c,))}


@contextlib.contextmanager
def strict_fp32(device):
    """For the body of the ``with``, fp32 means fp32 on the card: cuDNN and
    cuBLAS would otherwise run fp32 convs and products in TF32. Both
    switches are restored on the way out; nothing changes for another
    device."""
    if torch.device(device).type != "cuda":
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# Linear / Conv2D (NHWC x HWIO)
# ---------------------------------------------------------------------------

# The opt-in int8 linear path (the JAX package's, off by default there and
# here, and outside the int8-everything bundle): activations quantize under
# a static amax, the weights arrive pre-quantized per output channel
# (``kernel_q`` / ``w_scale``, from ``ops.conv3x3.quantize_conv_tree``), the
# product accumulates exactly in int32. No Pallas kernel backs it in the JAX
# package, so it stays plain torch.
_LINEAR_INT8 = False
_LINEAR_INT8_AMAX = 12.0


def set_linear_int8(flag: bool, amax: float = -1.0):
    """Toggle the int8 linear path; amax > 0 overrides the static
    activation amax (values beyond saturate)."""
    global _LINEAR_INT8, _LINEAR_INT8_AMAX
    _LINEAR_INT8 = bool(flag)
    if amax > 0:
        _LINEAR_INT8_AMAX = float(amax)


def linear_int8_enabled() -> bool:
    return _LINEAR_INT8


def quantize_act_i8(x: torch.Tensor, amax: Optional[float] = None):
    """x -> (int8 values, scalar fp32 scale) under the static amax:
    clip(round(x / xs), +-127) with xs = fp32(amax / 127) and a true
    division rounded half to even, as the JAX package computes it."""
    if amax is None:
        amax = _LINEAR_INT8_AMAX
    xs = torch.tensor(amax / 127.0, dtype=torch.float32, device=x.device)
    xq = torch.clamp(torch.round(x.float() / xs), -127, 127)
    return xq.to(torch.int8), xs


def _int_mm_ok(m: int, k: int, n: int, device) -> bool:
    """Whether ``torch._int_mm`` takes the (m, k) x (k, n) int8 product:
    on the card, for m > 16 and k, n multiples of 8 (its shape rules)."""
    return device.type == "cuda" and m > 16 and k % 8 == 0 and n % 8 == 0


def matmul_i8(x: torch.Tensor, kernel_q: torch.Tensor,
              w_scale: torch.Tensor, bias, out_dtype) -> torch.Tensor:
    """(..., K) float x (K, N) int8 -> (..., N): quantize x statically, sum
    the int8 products exactly in int32 (``torch._int_mm`` on the card where
    its shape rules allow, else an fp64 product, exact: |sum| <= 127^2 K
    is far below 2^53), rescale by (x_scale * w_scale[n]) in fp32, add the
    bias, cast to ``out_dtype``."""
    xq, xs = quantize_act_i8(x)
    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k)
    if _int_mm_ok(x2.shape[0], k, kernel_q.shape[1], x.device):
        acc = torch._int_mm(x2, kernel_q)
    else:
        acc = torch.matmul(x2.double(), kernel_q.double()).to(torch.int32)
    y = acc.reshape(*lead, -1).float() * (w_scale.float() * xs)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def linear(params, x: torch.Tensor) -> torch.Tensor:
    if _LINEAR_INT8 and "kernel_q" in params:
        return matmul_i8(x, params["kernel_q"], params["w_scale"],
                         params.get("bias"), x.dtype)
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
    contiguous NHWC tensor. In the int8 linear path a 1x1 stride-1 conv
    with pre-quantized weights (the transformers' proj_in / proj_out) is
    the channel product ``matmul_i8``."""
    if (_LINEAR_INT8 and "kernel_q" in params and stride == 1
            and tuple(params["kernel_q"].shape[:2]) == (1, 1)):
        kq = params["kernel_q"]
        return matmul_i8(x, kq.reshape(kq.shape[2:]), params["w_scale"],
                         params.get("bias"), x.dtype).contiguous()
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
