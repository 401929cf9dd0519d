"""3x3 stride-1 same conv with an optional fused GroupNorm+SiLU prologue,
exact, int8 or Winograd.

Counterpart of ``blobctrl_tpu/ops/conv3x3.py``. Two CUDA kernels:

  * ``csrc/conv3x3.cu`` replaces the Pallas ``_conv3x3_kernel_halo`` (and its
    "views3" twin ``_conv3x3_kernel``, the same function): an implicit GEMM
    with M = B*H*W, N = Co, K = 9*C, fp32 accumulation, bias in the
    epilogue, and ``silu(x * scale[b, c] + shift[b, c])`` applied as x is
    loaded, before the zero padding (taps outside the image contribute 0,
    not silu(shift)). bf16 runs on the tensor cores (the shared mainloop of
    ``csrc/gemm_bf16.cuh``: each block's 10 x 18 input halo goes through
    the prologue once per 64-channel slice and feeds the 9 taps as shifted
    views, the weights stream by cp.async into mma.sync), fp32 on the first,
    SIMT kernel; the C entry point picks by dtype and reports which ran
    (``tc_launches``). Where a bf16 conv's output blocks would leave SMs
    idle, the wrapper splits C across more blocks (``launch_config``) and a
    second kernel sums the splits in fp32 with the bias. What is left: wgmma
    with TMA, and warp-specialised producers;
  * ``csrc/conv3x3_int8.cu`` replaces ``_conv3x3_kernel_halo_i8``, the
    opt-in int8 mode (``set_conv_int8``): the same GEMM over int8
    activations under ONE activation scale and int8 weights under
    per-output-channel scales, int32 accumulation, one fp32 rescale. Both
    dtypes run on the int8 tensor cores: a pre-pass kernel applies the
    prologue and the quantize once per element into zero-padded int8 rows,
    then the halo implicit GEMM runs on mma.sync s8, with the weights
    K-major (``kmajor_weights``, cached beside ``kernel_q``) and C split by
    waves (``launch_config_int8``) into int32 partial sums; the C entry
    point reports the tensor cores (``int8_tc_launches``).

With the Winograd switch on (``set_winograd``) and the int8 mode off, calls
with even H and W go to ``ops.winograd.conv3x3_winograd`` instead.

``conv3x3`` runs the exact and int8 kernels through one
``torch.autograd.Function``, on both devices: the kernel forward (the
plain version for CPU tensors), and as backward the exact fp32 VJP of
``conv3x3_reference`` recomputed from the raw inputs, with gradients for
x, w, bias, scale and shift (the JAX package's custom VJP
``_diff_conv3x3``; the int8 mode straight through it). There is no
backward kernel: the JAX package's backward is XLA too.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from blobctrl_torch.nn.layers import strict_fp32
from blobctrl_torch.ops import _build
from blobctrl_torch.ops._split import cdiv, split_k

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# fp32(1/127): XLA compiles the quantizers' `amax / 127.0` as a multiply by
# this reciprocal, so the port's scales multiply by it too and come out
# bit-equal to the JAX package's
INV127 = float(torch.tensor(1.0) / 127.0)

# The int8 mode, off by default as in the JAX package. A static activation
# amax (activations assumed in [-amax, amax], beyond it they saturate) or
# None for a dynamic max-abs over each call's activations.
_CONV_INT8 = False
_CONV_INT8_ACT_AMAX: Optional[float] = 12.0
# The Winograd F(2x2, 3x3) route for even H and W, off by default as in the
# JAX package.
_WINOGRAD = False

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (b, h, w, c, co, dtype, prologue) -> launches
tc_launches = 0                            # of those, on the tensor-core kernel
int8_launches = 0                          # the same for the int8 kernel
int8_launch_shapes = collections.Counter()  # (b, h, w, c, co, dtype, prologue, act_amax) -> launches
int8_tc_launches = 0

# 2-D transformer projections (and 1x1 proj convs) that quantize_conv_tree
# also pre-quantizes, as the JAX package does for its int8 linear path
_LINEAR_INT8_NAMES = frozenset(
    {"to_q", "to_k", "to_v", "to_out", "proj_in", "proj_out"})


# The bf16 kernel's block (csrc/conv3x3.cu, csrc/gemm_bf16.cuh): a PATCH_H x
# PATCH_W patch of output pixels x BLOCK_N output channels, C in
# BLOCK_K-channel slices, two halo slices and B_STAGES weight slices in
# flight.
PATCH_H, PATCH_W, BLOCK_N, BLOCK_K, B_STAGES = 8, 16, 128, 64, 3
# the kernel's TC_SMEM: two halo stages, the weight ring
SMEM_BYTES = 2 * (2 * (PATCH_H + 2) * (PATCH_W + 2) * (BLOCK_K + 8)
                  + B_STAGES * BLOCK_K * (BLOCK_N + 8))


def launch_config(b: int, h: int, w: int, c: int, co: int) -> dict:
    """The bf16 kernel's launch for an NHWC (b, h, w, c) -> co conv: the
    number of C splits (``_split.split_k``) and the grid (patches, Co
    blocks, splits)."""
    blocks = b * cdiv(h, PATCH_H) * cdiv(w, PATCH_W)
    n_blocks = cdiv(co, BLOCK_N)
    splits = split_k(blocks * n_blocks, cdiv(c, BLOCK_K))
    return {"splits": splits, "grid": (blocks, n_blocks, splits),
            "smem_bytes": SMEM_BYTES}


# The int8 kernel's block (csrc/conv3x3_int8.cu): the same patch and Co
# block as the bf16 kernel, C in INT8_BLOCK_K-channel slices; two int8
# halo stages and INT8_B_STAGES K-major weight slices, rows of INT8_ROW_LD
# bytes.
INT8_BLOCK_K, INT8_B_STAGES = 64, 4
INT8_ROW_LD = INT8_BLOCK_K + 16
INT8_SMEM_BYTES = (2 * (PATCH_H + 2) * (PATCH_W + 2) * INT8_ROW_LD
                   + INT8_B_STAGES * BLOCK_N * INT8_ROW_LD)


def launch_config_int8(b: int, h: int, w: int, c: int, co: int) -> dict:
    """The int8 kernel's launch for an NHWC (b, h, w, c) -> co conv: the
    number of C splits (``_split.split_k``), the grid (patches, Co blocks,
    splits) and the shared memory."""
    blocks = b * cdiv(h, PATCH_H) * cdiv(w, PATCH_W)
    n_blocks = cdiv(co, BLOCK_N)
    splits = split_k(blocks * n_blocks, cdiv(c, INT8_BLOCK_K))
    return {"splits": splits, "grid": (blocks, n_blocks, splits),
            "smem_bytes": INT8_SMEM_BYTES}


# id(kernel_q) -> (weak reference to kernel_q, its K-major copy)
_KMAJOR = {}


def kmajor_weights(kernel_q: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's weights: (3, 3, C, Co) HWIO int8 -> (9, Co, Cp)
    int8, C contiguous and zero-padded to Cp = C rounded up to 16, so that
    each output channel's channels are a row of 16-byte copies and the s8
    B fragment's 4 consecutive channels come by ldmatrix. Made once per
    ``kernel_q`` and kept while it lives, outside the parameter tree."""
    hit = _KMAJOR.get(id(kernel_q))
    if hit is not None and hit[0]() is kernel_q:
        return hit[1]
    c, co = kernel_q.shape[2], kernel_q.shape[3]
    wt = torch.zeros((9, co, cdiv(c, 16) * 16), dtype=torch.int8,
                     device=kernel_q.device)
    wt[:, :, :c] = kernel_q.reshape(9, c, co).transpose(1, 2)
    key = id(kernel_q)
    _KMAJOR[key] = (weakref.ref(kernel_q, lambda _: _KMAJOR.pop(key, None)),
                    wt)
    return wt


def set_conv_int8(flag: bool, act_amax: Optional[float] = "unset"):
    """Toggle the int8 conv mode; optionally set the static activation amax
    (None = dynamic per-call max-abs)."""
    global _CONV_INT8, _CONV_INT8_ACT_AMAX
    _CONV_INT8 = bool(flag)
    if act_amax != "unset":
        _CONV_INT8_ACT_AMAX = act_amax


def conv_int8_enabled() -> bool:
    return _CONV_INT8


def set_winograd(flag: bool):
    global _WINOGRAD
    _WINOGRAD = bool(flag)


def winograd_enabled() -> bool:
    return _WINOGRAD


def quantize_kernel_i8(kern: torch.Tensor):
    """(3, 3, C, Co) conv or (K, N) linear kernel -> (int8 kernel, per-
    output-channel fp32 scales): ws = max(amax, 1e-20) / 127 over every axis
    but the last, wq = clip(round(w / ws), +-127), a true division rounded
    half to even (the JAX package's ``_quantize_kernel_i8``)."""
    wf = kern.float()
    ws = torch.clamp_min(wf.abs().amax(dim=tuple(range(wf.dim() - 1))),
                         1e-20) * INV127
    return torch.clamp(torch.round(wf / ws), -127, 127).to(torch.int8), ws


def _hot_kernel(k, name) -> bool:
    if not isinstance(k, torch.Tensor):
        return False
    conv33 = k.dim() == 4 and tuple(k.shape[:2]) == (3, 3)
    hot_linear = name in _LINEAR_INT8_NAMES and (
        k.dim() == 2 or (k.dim() == 4 and tuple(k.shape[:2]) == (1, 1)))
    return conv33 or hot_linear


def quantize_conv_tree(params):
    """Pre-quantize a param tree for the int8 mode: ``kernel_q`` (int8) and
    ``w_scale`` (per-output-channel fp32) beside every (3, 3, C, Co) conv
    ``kernel`` and every transformer projection kernel named in
    ``_LINEAR_INT8_NAMES`` (the JAX package's leaf filter). Idempotent; every
    other leaf is passed through as the same object."""
    def walk(p, name):
        if isinstance(p, dict):
            out = {k: walk(v, k) for k, v in p.items()}
            if "kernel_q" not in p and _hot_kernel(p.get("kernel"), name):
                out["kernel_q"], out["w_scale"] = quantize_kernel_i8(
                    p["kernel"])
            return out
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, None) for v in p)
        return p

    return walk(params, None)


def _per_batch(t: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(C,) or (B, C) -> contiguous fp32 (B, C)."""
    return t.float().expand(b, c).contiguous()


def _prologue(x: torch.Tensor, scale: torch.Tensor,
              shift: Optional[torch.Tensor]) -> torch.Tensor:
    """silu(x * scale + shift) in fp32, rounded to x's dtype."""
    b, c = x.shape[0], x.shape[3]
    xf = x.float() * _per_batch(scale, b, c)[:, None, None, :]
    if shift is not None:
        xf = xf + _per_batch(shift, b, c)[:, None, None, :]
    return F.silu(xf).to(x.dtype)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version (the JAX package's ``_xla_reference``): the
    prologue in fp32, cast to x's dtype, zero padding, then the conv in fp32
    plus bias, cast back. x: (B, H, W, C) NHWC; w: (3, 3, C, Co) HWIO."""
    dtype = x.dtype
    if scale is not None:
        x = _prologue(x, scale, shift)
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   w.float().permute(3, 2, 0, 1), padding=1)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype).contiguous()


def act_scale(act: torch.Tensor, act_amax: Optional[float]) -> torch.Tensor:
    """The int8 mode's ONE activation scale, a (1,) fp32 tensor on act's
    device: act_amax / 127, or max(max |act|, 1e-20) / 127 when act_amax is
    None (one max over the whole call, every batch row together)."""
    if act_amax is not None:
        return torch.full((1,), act_amax / 127.0, dtype=torch.float32,
                          device=act.device)
    return (torch.clamp_min(act.abs().amax().float(), 1e-20)
            * INV127).reshape(1)


def conv3x3_int8_reference(x: torch.Tensor, kernel_q: torch.Tensor,
                           w_scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           scale: Optional[torch.Tensor] = None,
                           shift: Optional[torch.Tensor] = None,
                           act_amax: Optional[float] = 12.0) -> torch.Tensor:
    """The plain version of the int8 mode (the JAX package's int8 branch of
    ``_conv3x3``): the prologue rounded to x's dtype, the activation
    quantized as clip(round(a / xs), +-127) with a true division, zero
    padding, the integer conv, then float(acc) * (xs * w_scale) + bias in
    fp32, cast back to x's dtype."""
    if scale is not None:
        x = _prologue(x, scale, shift)
    xs = act_scale(x, act_amax)
    xq = torch.clamp(torch.round(x.float() / xs), -127, 127)
    # the integer sum exactly: |acc| <= 9 * C * 127^2 < 2^53 in fp64
    acc = F.conv2d(xq.double().permute(0, 3, 1, 2),
                   kernel_q.double().permute(3, 2, 0, 1), padding=1)
    out = acc.permute(0, 2, 3, 1).float() * (xs * w_scale.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype).contiguous()


def _check_args(name, x, w, scale, shift, device_tensors):
    """The checks both kernels share. -> (b, h, w, c, co)."""
    if not (x.is_cuda and all(t.device == x.device for t in device_tensors)):
        raise ValueError(f"{name}: x and the weights must share one CUDA "
                         f"device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype {x.dtype}; the kernel takes bf16 "
                         f"or fp32")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3,
                                                               x.shape[3]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    if shift is not None and scale is None:
        raise ValueError(f"{name}: shift needs scale")
    b, h, wd, c = x.shape
    co = w.shape[3]
    if min(b, h, wd, c, co) < 1:
        raise ValueError(f"{name}: empty shape x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    return b, h, wd, c, co


def _epilogue_args(x, co, bias, scale, shift):
    """fp32 bias (Co,) and fp32 (B, C) scale/shift (or None) on x's device."""
    b, c, dev = x.shape[0], x.shape[3], x.device
    bias32 = (torch.zeros(co, device=dev) if bias is None
              else _build.as_f32(bias, dev, co))
    if scale is None:
        return bias32, None, None
    shift32 = (torch.zeros(b, c, device=dev) if shift is None
               else _build.as_f32(shift, dev, b, c))
    return bias32, _build.as_f32(scale, dev, b, c), shift32


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None,
            kernel_q: Optional[torch.Tensor] = None,
            w_scale: Optional[torch.Tensor] = None,
            u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, H, W, C) NHWC, w: (3, 3, C, Co) HWIO, both contiguous and of
    one dtype (bf16 or fp32); bias (Co,); scale/shift (B, C) or (C,) ->
    (B, H, W, Co). CPU tensors take the plain version. Differentiable in x,
    w, bias, scale and shift (``Conv3x3VJP``).

    With the int8 mode on (``set_conv_int8``) the forward is
    ``conv3x3_int8``, with the pre-quantized ``kernel_q``/``w_scale`` from
    ``quantize_conv_tree`` or, without them, w quantized here. Otherwise,
    with the Winograd switch on and even H and W, the call goes to
    ``winograd.conv3x3_winograd``, with the pre-transformed ``u`` from
    ``winograd.transform_conv_tree`` or, without it, w transformed there;
    it has no backward."""
    if _CONV_INT8:
        if kernel_q is None:
            kernel_q, w_scale = quantize_kernel_i8(w)
        return Conv3x3VJP.apply(x, w, bias, scale, shift, functools.partial(
            _int8_forward, kernel_q=kernel_q, w_scale=w_scale))
    if _WINOGRAD and x.dim() == 4 and x.shape[1] % 2 == 0 \
            and x.shape[2] % 2 == 0:
        from blobctrl_torch.ops import winograd
        return winograd.conv3x3_winograd(x, w, bias, scale, shift, u=u)
    return Conv3x3VJP.apply(x, w, bias, scale, shift, _conv3x3_forward)


def conv3x3_vjp(x, w, bias, scale, shift, g, needs):
    """The exact VJP of ``conv3x3_reference`` at the raw inputs for the
    output cotangent g, recomputed in fp32 (the JAX package's
    ``_diff_conv3x3`` backward), TF32 off on the card for the call
    (``strict_fp32``), whatever the process has set: gradients for (x, w,
    bias, scale, shift), each in its input's dtype, None where ``needs``
    says none is wanted or the input is None."""
    args = [x, w, bias, scale, shift]
    with torch.enable_grad(), strict_fp32(x.device):
        leaves = [a.detach().requires_grad_() if a is not None and n else
                  a for a, n in zip(args, needs)]
        want = [i for i, a in enumerate(leaves)
                if a is not None and a.requires_grad]
        grads = torch.autograd.grad(conv3x3_reference(*leaves), [
            leaves[i] for i in want], g) if want else ()
    out = [None] * 5
    for i, gr in zip(want, grads):
        out[i] = gr
    return out


class Conv3x3VJP(torch.autograd.Function):
    """A 3x3 conv kernel's forward (exact or int8), the exact fp32 plain
    backward: the only way ``conv3x3`` reaches those kernels, so that an
    output made under grad mode has a ``grad_fn``."""

    @staticmethod
    def forward(ctx, x, w, bias, scale, shift, forward):
        ctx.save_for_backward(x, w, bias, scale, shift)
        return forward(x, w, bias, scale, shift)

    @staticmethod
    def backward(ctx, g):
        return (*conv3x3_vjp(*ctx.saved_tensors, g,
                             ctx.needs_input_grad[:5]), None)


def _int8_forward(x, w, bias, scale, shift, kernel_q, w_scale):
    return conv3x3_int8(x, kernel_q, w_scale, bias, scale, shift,
                        _CONV_INT8_ACT_AMAX)


def _conv3x3_forward(x, w, bias, scale, shift):
    global launches, tc_launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_reference(x, w, bias, scale, shift)
    b, h, wd, c, co = _check_args("conv3x3", x, w, scale, shift, (w,))
    if w.dtype != x.dtype:
        raise ValueError(f"conv3x3: dtypes x {x.dtype}, w {w.dtype}; the "
                         f"kernel takes matching bf16 or fp32")
    bias32, scale32, shift32 = _epilogue_args(x, co, bias, scale, shift)
    splits = (launch_config(b, h, wd, c, co)["splits"]
              if x.dtype == torch.bfloat16 else 1)
    ws = (torch.empty((splits, b, h, wd, co), device=x.device,
                      dtype=torch.float32) if splits > 1 else None)
    fn = _build.entry("conv3x3")
    out = torch.empty((b, h, wd, co), device=x.device, dtype=x.dtype)
    design = ctypes.c_int(-1)
    rc = fn(x.data_ptr(), w.data_ptr(), bias32.data_ptr(), _ptr(scale32),
            _ptr(shift32), out.data_ptr(), b, h, wd, c, co, _DTYPES[x.dtype],
            splits, _ptr(ws), _build.stream(x.device), ctypes.byref(design))
    _build.check("conv3x3", rc)
    launches += 1
    tc_launches += design.value == _build.DESIGN_TENSOR_CORES
    launch_shapes[(b, h, wd, c, co, str(x.dtype), scale is not None)] += 1
    return out


def conv3x3_int8(x: torch.Tensor, kernel_q: torch.Tensor,
                 w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None,
                 act_amax: Optional[float] = 12.0) -> torch.Tensor:
    """The int8 conv. x: (B, H, W, C) NHWC bf16 or fp32; kernel_q: (3, 3, C,
    Co) int8 HWIO; w_scale: (Co,) fp32 -> (B, H, W, Co) in x's dtype. CPU
    tensors take the plain version.

    With a static act_amax the kernel applies the prologue, rounds it to x's
    dtype and quantizes, in a pre-pass over x. With act_amax=None the prologue runs
    here in plain torch first, since its max-abs sets the scale, and the
    kernel takes the activations without a prologue. It has no backward of
    its own: under grad it raises, and ``conv3x3`` in the int8 mode
    differentiates it straight through the exact op."""
    global int8_launches, int8_tc_launches
    _build.refuse_grad("conv3x3_int8", "call conv3x3 under "
                       "set_conv_int8(True)", x, bias, scale, shift)
    if x.device.type == "cpu" and kernel_q.device.type == "cpu":
        return conv3x3_int8_reference(x, kernel_q, w_scale, bias, scale,
                                      shift, act_amax)
    b, h, wd, c, co = _check_args("conv3x3_int8", x, kernel_q, scale, shift,
                                  (kernel_q, w_scale))
    if kernel_q.dtype != torch.int8 or w_scale.shape != (co,):
        raise ValueError(f"conv3x3_int8: kernel_q {kernel_q.dtype}, w_scale "
                         f"{tuple(w_scale.shape)}; the kernel takes int8 "
                         f"weights and ({co},) scales")
    prologue = scale is not None
    if act_amax is None and prologue:
        x, scale, shift = _prologue(x, scale, shift), None, None
    xs = act_scale(x, act_amax)
    bias32, scale32, shift32 = _epilogue_args(x, co, bias, scale, shift)
    ws32 = w_scale.float().contiguous()
    splits = launch_config_int8(b, h, wd, c, co)["splits"]
    work = (torch.empty((splits, b, h, wd, co), device=x.device,
                        dtype=torch.int32) if splits > 1 else None)
    # the quantized activations, rows padded to 16 bytes
    q8 = torch.empty((b, h, wd, cdiv(c, 16) * 16), device=x.device,
                     dtype=torch.int8)
    fn = _build.entry("conv3x3_int8")
    out = torch.empty((b, h, wd, co), device=x.device, dtype=x.dtype)
    design = ctypes.c_int(-1)
    rc = fn(x.data_ptr(), kmajor_weights(kernel_q).data_ptr(),
            ws32.data_ptr(), bias32.data_ptr(), _ptr(scale32), _ptr(shift32),
            xs.data_ptr(), q8.data_ptr(), out.data_ptr(), b, h, wd, c, co,
            _DTYPES[x.dtype], splits, _ptr(work), _build.stream(x.device),
            ctypes.byref(design))
    _build.check("conv3x3_int8", rc)
    int8_launches += 1
    int8_tc_launches += design.value == _build.DESIGN_TENSOR_CORES
    int8_launch_shapes[(b, h, wd, c, co, str(x.dtype), prologue,
                        act_amax)] += 1
    return out
