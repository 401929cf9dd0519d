"""Attention, GEGLU feed-forward and the basic transformer block.

Counterpart of ``blobctrl_tpu/nn/attention.py`` (diffusers ``Attention`` +
``BasicTransformerBlock``, SD-1.5 flavour: no qkv bias, bias on to_out,
pre-LayerNorm blocks, GEGLU feed-forward).

The inner attention takes flash attention (``ops.flash_attention``) for the
long self-attention of the double-width layout, and the plain fp32-softmax
path everywhere else (cross-attention over the text tokens, short maps).
``set_attention_backend(..., qk_int8=True)`` sends the flash calls to the
int8 q.k^T kernel instead, with one global k scale under
``int8_global_k=True`` (the int8-everything mode).

``set_ln_matmul_fuse("on")`` fuses each pre-LayerNorm into the projection
after it (``ops.ln_matmul``): the self-attention QKV, the cross-attention
to_q and the GEGLU proj_in.

Under tensor parallelism (``parallel.kernel_sharding``) to_q/k/v hold this
rank's columns, so the fused QKV concatenates local columns and the heads
are local; GEGLU's proj_in holds matching columns of both halves; to_out
and proj_out are row-parallel, summed over the model group.
"""

from __future__ import annotations

from typing import Optional

import torch

from blobctrl_torch.nn import layers
from blobctrl_torch.ops import flash_attention as flash_op
from blobctrl_torch.ops import ln_matmul as ln_matmul_op
from blobctrl_torch.parallel import kernel_sharding as ks
from blobctrl_torch.parallel.mesh import FF_MULT

# Sequence length at or above which q and kv take the flash kernel.
FLASH_MIN_SEQ = 1024
# Opt-in int8 q.k^T in the flash calls, and with it one global k scale
# instead of per-row k scales (the int8-everything mode uses both).
_ATTENTION_INT8 = False
_ATTENTION_INT8_GLOBAL_K = False
# Pre-LayerNorm -> projection fusion: "on", "off", or "auto" (= off, the JAX
# package's historical name). Off by default, as in the JAX package.
_LN_MATMUL_FUSE = "off"


def set_attention_backend(backend: str = "auto",
                          qk_int8: Optional[bool] = None,
                          int8_global_k: Optional[bool] = None):
    """The JAX package's switch, with its names. The port has one backend,
    "auto" (routing by shape, kernel or plain version by device); qk_int8
    and int8_global_k set the int8 flash mode, None leaves each as it is."""
    global _ATTENTION_INT8, _ATTENTION_INT8_GLOBAL_K
    if backend != "auto":
        raise ValueError(f"attention backend {backend!r}: the port has only "
                         f"'auto'")
    if qk_int8 is not None:
        _ATTENTION_INT8 = bool(qk_int8)
    if int8_global_k is not None:
        _ATTENTION_INT8_GLOBAL_K = bool(int8_global_k)


def set_ln_matmul_fuse(mode: str):
    """The JAX package's switch: "on", "off" or "auto" (off). Its
    "interpret" mode (the Pallas kernel on the CPU) has no counterpart: the
    port's op takes its plain version for CPU tensors under "on"."""
    global _LN_MATMUL_FUSE
    if mode not in ("on", "off", "auto"):
        raise ValueError(f"ln_matmul fuse mode {mode!r}: the port has 'on', "
                         f"'off' and 'auto'")
    _LN_MATMUL_FUSE = mode


def ln_matmul_fuse_mode() -> str:
    return _LN_MATMUL_FUSE


def _ln_linear(norm, x, params):
    """LN(x; norm) @ kernel (+ bias) through the fused op."""
    return ln_matmul_op.ln_matmul(x, norm["scale"], norm.get("bias"),
                                  params["kernel"], params.get("bias"))


def attention_int8_mode() -> tuple:
    """-> (qk_int8, int8_global_k) as set."""
    return _ATTENTION_INT8, _ATTENTION_INT8_GLOBAL_K


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """q, k, v: (B, H, S, D). fp32 scores and softmax, probabilities cast to
    the input dtype before P @ V (the JAX package's ``sdpa_xla``)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def use_flash(q_seq: int, kv_seq: int) -> bool:
    """The JAX package's ``_use_flash`` routing on its card: flash attention
    for kv % 128 == 0 and both sequences >= 1024 (no attention here is
    masked). The shape alone decides; the op picks kernel or plain version
    by device."""
    return (kv_seq % 128 == 0
            and q_seq >= FLASH_MIN_SEQ and kv_seq >= FLASH_MIN_SEQ)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, return_heads: bool = False
                         ) -> torch.Tensor:
    """q: (B, Sq, C), k/v: (B, Sk, C) -> (B, Sq, C), or (B, H, Sq, D) when
    return_heads."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    scale = 1.0 / (d ** 0.5)

    def split(x, s):
        return x.reshape(b, s, heads, d).transpose(1, 2)

    if use_flash(sq, sk):
        def flat(x, s):
            return split(x, s).reshape(b * heads, s, d).contiguous()
        args = (flat(q, sq), flat(k, sk), flat(v, sk), scale)
        if _ATTENTION_INT8:
            out = flash_op.flash_attention_int8(
                *args, global_k=_ATTENTION_INT8_GLOBAL_K)
        else:
            out = flash_op.flash_attention(*args)
        out = out.reshape(b, heads, sq, d)
    else:
        out = sdpa_plain(split(q, sq), split(k, sk), split(v, sk), scale)
    if return_heads:
        return out
    return out.transpose(1, 2).reshape(b, sq, c)


def init_attention(init: layers.ParamInit, query_dim: int,
                   cross_dim: Optional[int] = None):
    kq, kk, kv, ko = init.split(4)
    kv_dim = cross_dim if cross_dim is not None else query_dim
    return {
        "to_q": layers.init_linear(kq, query_dim, query_dim, use_bias=False),
        "to_k": layers.init_linear(kk, kv_dim, query_dim, use_bias=False),
        "to_v": layers.init_linear(kv, kv_dim, query_dim, use_bias=False),
        "to_out": layers.init_linear(ko, query_dim, query_dim),
    }


def attention(params, x: torch.Tensor, heads: int,
              context: Optional[torch.Tensor] = None,
              norm=None) -> torch.Tensor:
    """norm: optional pre-LayerNorm params, applied to x first, or with the
    ln_matmul fusion on, inside the projection that reads the normalized x
    (a biased self-attention keeps the explicit LayerNorm: its k and v
    would read the un-normalized x)."""
    fuse = (norm is not None and _LN_MATMUL_FUSE == "on"
            and not (context is None and "bias" in params["to_q"]))
    if norm is not None and not fuse:
        x = layers.layer_norm(norm, x)
    if context is None and "bias" not in params["to_q"]:
        # self-attention: the three projections as one matmul (in the int8
        # linear path, of the pre-quantized kernels and their scales)
        names = ("to_q", "to_k", "to_v")
        if layers.linear_int8_enabled() and "kernel_q" in params["to_q"]:
            if fuse:  # the int8 product has no LayerNorm prologue
                x = layers.layer_norm(norm, x)
            qkv = layers.matmul_i8(
                x, torch.cat([params[n]["kernel_q"] for n in names], dim=1),
                torch.cat([params[n]["w_scale"] for n in names]), None,
                x.dtype)
            q, k, v = qkv.chunk(3, dim=-1)
            return _attend(params, q, k, v, heads, x.shape[-1])
        w_qkv = torch.cat([params[n]["kernel"] for n in names], dim=1)
        if fuse:
            qkv = _ln_linear(norm, x, {"kernel": w_qkv})
        else:
            qkv = torch.matmul(x, w_qkv.to(x.dtype))
        q, k, v = qkv.chunk(3, dim=-1)
    else:
        q = (_ln_linear(norm, x, params["to_q"]) if fuse
             else layers.linear(params["to_q"], x))
        src = context if context is not None else x
        k = layers.linear(params["to_k"], src)
        v = layers.linear(params["to_v"], src)
    return _attend(params, q, k, v, heads, x.shape[-1])


def _attend(params, q, k, v, heads: int, width: int) -> torch.Tensor:
    """The heads' attention, then the output projection. width: the
    model width; q holding fewer columns means local heads and a
    row-parallel to_out."""
    heads = ks.local_heads(heads, q.shape[-1], width)
    out_h = multi_head_attention(q, k, v, heads, return_heads=True)
    # output projection over (head, d): the head merge folds into the matmul
    b, h, sq, d = out_h.shape
    out = out_h.transpose(1, 2).reshape(b, sq, h * d)
    if h * d != width:
        return ks.row_linear(params["to_out"], out)
    return layers.linear(params["to_out"], out)


def init_feed_forward(init: layers.ParamInit, dim: int):
    k1, k2 = init.split()
    inner = dim * 4
    return {"proj_in": layers.init_linear(k1, dim, inner * 2),
            "proj_out": layers.init_linear(k2, inner, dim)}


def feed_forward(params, x: torch.Tensor, norm=None) -> torch.Tensor:
    """GEGLU: proj_in to 2x inner, h * gelu(gate), proj_out. norm: optional
    pre-LayerNorm params, fused into proj_in with the ln_matmul fusion on."""
    if norm is not None and _LN_MATMUL_FUSE == "on":
        h = _ln_linear(norm, x, params["proj_in"])
    else:
        if norm is not None:
            x = layers.layer_norm(norm, x)
        h = layers.linear(params["proj_in"], x)
    h, gate = h.chunk(2, dim=-1)
    h = h * layers.gelu(gate)
    if ks.current() is not None and ks.split(h.shape[-1],
                                             FF_MULT * x.shape[-1]) > 1:
        return ks.row_linear(params["proj_out"], h)
    return layers.linear(params["proj_out"], h)


def init_transformer_block(init: layers.ParamInit, dim: int,
                           cross_dim: Optional[int]):
    """cross_dim=None builds no cross-attention at all (the BlobNet
    configuration); its key, the second of three, is split all the
    same."""
    k1, k2, k3 = init.split(3)
    p = {"norm1": layers.init_norm(init, dim),
         "attn1": init_attention(k1, dim),
         "norm3": layers.init_norm(init, dim),
         "ff": init_feed_forward(k3, dim)}
    if cross_dim is not None:
        p["norm2"] = layers.init_norm(init, dim)
        p["attn2"] = init_attention(k2, dim, cross_dim=cross_dim)
    return p


def transformer_block(params, x: torch.Tensor, heads: int,
                      context: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = x + attention(params["attn1"], x, heads, norm=params["norm1"])
    if "attn2" in params:
        x = x + attention(params["attn2"], x, heads, context=context,
                          norm=params["norm2"])
    return x + feed_forward(params["ff"], x, norm=params["norm3"])
