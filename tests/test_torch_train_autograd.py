"""The port's autograd through the hand kernels against the JAX package's
custom VJPs, on the CPU, fp32: the flash Function (fixed and running max,
int8 straight through, the q-chunked backward with both thresholds shrunk)
against ``jax.grad`` through ``flash_attention(..., interpret=True)``; the
conv3x3 Function (with and without the GroupNorm + SiLU prologue, bias and
per-batch scale and shift) against ``jax.grad`` through ``conv3x3(...,
interpret=True)``; the gradient through the folded GroupNorm statistics
back to x and the norm's leaves; the four refusals under grad (K9-K12);
remat on and off. The bar is 1e-5 of max |JAX|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_tpu.ops import conv3x3 as jconv
from blobctrl_tpu.ops import flash_attention as jfa
from blobctrl_torch.apps import flagship as tflag
from blobctrl_torch.models import blobnet as tblob
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.nn import layers as tlayers
from blobctrl_torch.nn import resnet as tres
from blobctrl_torch.ops import blob_splat as tsplat
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.ops import flash_attention as tfa
from blobctrl_torch.ops import gn_matmul as tgn
from blobctrl_torch.ops import ln_matmul as tln
from blobctrl_torch.ops import winograd as twino

torch.set_num_threads(2)
TOL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, (what, err)


def _t(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_()


def _attn_inputs(seed, b=1, h=2, s=256, d=40):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(4)]


def _flash_grads(q, k, v, cot, jax_kw, port_fn):
    """(JAX grads, port grads) of sum(attention * cot) in (B, H, S, D)."""
    scale = 1.0 / np.sqrt(q.shape[-1])

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, scale=scale, block_q=128,
                                  block_kv=128, interpret=True, **jax_kw)
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    def flat(a):
        return a.reshape(-1, *a.shape[2:])
    tq, tk, tv = (_t(flat(a)) for a in (q, k, v))
    out = port_fn(tq, tk, tv, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(flat(cot)))
    return want, [g.reshape(a.shape).numpy() for g, a in zip(got, (q, k, v))]


@pytest.mark.parametrize("mode", ["fixed-max", "running-max",
                                  "int8-per-row-k", "int8-global-k"])
def test_flash_function_grads_match_jax(mode):
    q, k, v, cot = _attn_inputs(1)
    jax_kw, port = {
        "fixed-max": ({}, lambda *a: tfa.flash_attention(*a)),
        "running-max": ({"fixed_max": None},
                        lambda *a: tfa.flash_attention(*a, fixed_max=None)),
        "int8-per-row-k": ({"qk_int8": True},
                           lambda *a: tfa.flash_attention_int8(
                               *a, global_k=False)),
        "int8-global-k": ({"qk_int8": True, "int8_global_k": True},
                          lambda *a: tfa.flash_attention_int8(*a)),
    }[mode]
    want, got = _flash_grads(q, k, v, cot, jax_kw, port)
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, f"{mode} d{name}")


def test_flash_exp2_function_grads_are_the_exact_ones():
    """The exp2-folded mode differentiates straight through the exact op."""
    q, k, v, cot = _attn_inputs(2)
    want, got = _flash_grads(q, k, v, cot, {},
                             lambda *a: tfa.flash_attention_exp2(*a))
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, f"exp2 d{name}")


def test_flash_chunked_backward_matches_jax(monkeypatch):
    """Both thresholds shrunk: the q-chunked backward (with a last chunk
    shorter than the others) against JAX's ``_xla_sdpa_chunked``."""
    for mod in (jfa, tfa):
        monkeypatch.setattr(mod, "_CHUNKED_BWD_ELEMS", 0)
        monkeypatch.setattr(mod, "_BWD_CHUNK_Q", 80)  # 320 = 4 chunks
    q, k, v, cot = _attn_inputs(3, s=320, d=24)
    k, v = k[:, :, :256], v[:, :, :256]
    calls = []
    real = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda q, *a: calls.append(q.shape[1]) or real(q, *a))
    want, got = _flash_grads(q, k, v, cot, {},
                             lambda *a: tfa.flash_attention(*a))
    assert calls[1:] == [80, 80, 80, 80]  # the forward, then the chunks
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, f"chunked d{name}")


@pytest.mark.parametrize("case", ["prologue-bias-per-batch",
                                  "prologue-per-channel", "plain",
                                  "bias-only"])
def test_conv3x3_function_grads_match_jax(case):
    rng = np.random.RandomState(4)
    b, h, w, c, co = 2, 8, 8, 16, 32
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    scale = (rng.rand(b, c) + 0.5).astype(np.float32)
    shift = (rng.randn(b, c) * 0.1).astype(np.float32)
    cot = rng.randn(b, h, w, co).astype(np.float32)
    args = {"prologue-bias-per-batch": (x, k, bias, scale, shift),
            "prologue-per-channel": (x, k, None, scale[0], shift[0]),
            "plain": (x, k, None, None, None),
            "bias-only": (x, k, bias, None, None)}[case]
    live = [i for i, a in enumerate(args) if a is not None]

    def loss(*vals):
        full = list(args)
        for i, val in zip(live, vals):
            full[i] = val
        return jnp.sum(jconv.conv3x3(*full, interpret=True) * cot)

    want = jax.grad(loss, argnums=tuple(range(len(live))))(
        *[jnp.asarray(args[i]) for i in live])
    targs = [None if a is None else _t(a) for a in args]
    out = tconv.conv3x3(*targs)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, [targs[i] for i in live],
                              torch.from_numpy(cot))
    for i, g, wnt in zip(live, got, want):
        assert g.dtype == targs[i].dtype
        _close(g.numpy(), wnt, f"{case} arg {i}")


def test_conv3x3_int8_function_is_straight_through(monkeypatch):
    """In the int8 mode the forward is the int8 conv and the gradients are
    the exact op's; a direct int8 call under grad is refused."""
    rng = np.random.RandomState(5)
    x = _t(rng.randn(1, 8, 8, 32).astype(np.float32))
    k = _t((rng.randn(3, 3, 32, 32) * 0.05).astype(np.float32))
    monkeypatch.setattr(tconv, "_CONV_INT8", True)
    out = tconv.conv3x3(x, k)
    with torch.no_grad():
        kq, ws = tconv.quantize_kernel_i8(k)
        assert torch.equal(out, tconv.conv3x3_int8_reference(
            x, kq, ws, act_amax=tconv._CONV_INT8_ACT_AMAX))
    got = torch.autograd.grad(out.sum(), (x, k))
    want = torch.autograd.grad(tconv.conv3x3_reference(x, k).sum(), (x, k))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="set_conv_int8"):
        tconv.conv3x3_int8(x, kq, ws)


def test_gradient_flows_through_the_folded_group_norm():
    """A resnet block's routed conv takes GroupNorm's statistics as a
    prologue (scale, shift in plain torch): its gradients reach x and the
    norm's affine leaves as through GroupNorm -> SiLU -> conv."""
    rng = np.random.RandomState(6)
    x = _t(rng.randn(2, 8, 8, 32).astype(np.float32))
    norm = {"scale": _t((rng.rand(32) + 0.5).astype(np.float32)),
            "bias": _t((rng.randn(32) * 0.1).astype(np.float32))}
    conv = {"kernel": _t((rng.randn(3, 3, 32, 32) * 0.05).astype(
        np.float32)), "bias": _t(rng.randn(32).astype(np.float32))}
    leaves = [x, norm["scale"], norm["bias"], conv["kernel"], conv["bias"]]
    assert tres.route_conv(x)
    cot = torch.from_numpy(rng.randn(2, 8, 8, 32).astype(np.float32))
    s, sh = tlayers.group_norm_scale_shift(norm, x, 8)
    fused = tres._conv3x3_kernel(conv, x, s, sh)
    plain = tlayers.conv2d(conv, tlayers.silu(tlayers.group_norm(norm, x, 8)),
                           padding=1)
    np.testing.assert_allclose(fused.detach(), plain.detach(), atol=1e-5)
    got = torch.autograd.grad(fused, leaves, cot)
    want = torch.autograd.grad(plain, leaves, cot)
    for g, w, name in zip(got, want, ("x", "gamma", "beta", "kernel",
                                      "bias")):
        assert g.abs().max() > 0, name
        _close(g.numpy(), w.numpy(), name)


def _refusal_cases():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(1, 8, 8, 32).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 16).astype(np.float32))
    k = torch.from_numpy((rng.randn(3, 3, 32, 16) * 0.05).astype(np.float32))
    xs = torch.tensor([[0.5]])
    covs = torch.tensor([[[[0.01, 0.0], [0.0, 0.02]]]])
    return {
        "winograd": ("set_winograd", lambda g: twino.conv3x3_winograd(
            x.requires_grad_(g), k)),
        "gn_matmul": ("set_gn_proj_fuse", lambda g: tgn.affine_matmul(
            x.requires_grad_(g), w)),
        "ln_matmul": ("set_ln_matmul_fuse", lambda g: tln.ln_matmul(
            x.requires_grad_(g), torch.ones(32), None, w)),
        "blob_splat": ("detach", lambda g: tsplat.splat_scores(
            xs.clone().requires_grad_(g), xs.clone(), covs, torch.ones(1, 1),
            (8, 8))),
    }


@pytest.mark.parametrize("name", ["winograd", "gn_matmul", "ln_matmul",
                                  "blob_splat"])
def test_kernels_without_a_backward_refuse_under_grad(name):
    """K12, K10, K11, K9: under grad with an input that requires grad they
    raise, naming what to turn off, on the CPU too (no plain fallback);
    under no_grad, or with no input requiring grad, they run."""
    switch, call = _refusal_cases()[name]
    with pytest.raises(RuntimeError, match=switch):
        call(True)
    with torch.no_grad():
        assert call(True).grad_fn is None
    assert call(False).grad_fn is None


def _tiny_loss(remat, seed=8):
    """sum(UNet(x, BlobNet residuals)) of the tiny nets, with the BlobNet
    taps drawn, and the params it differentiates."""
    ucfg, bcfg = tflag.tiny_configs()
    up = tunet.init_unet(ucfg, key=1, device="cpu")
    bp = tblob.init_blobnet(bcfg, key=2, device="cpu", zero_taps=False)
    rng = np.random.RandomState(seed)
    blob_in = torch.from_numpy(rng.randn(1, 8, 16, 21).astype(np.float32))
    unet_in = torch.from_numpy(rng.randn(1, 8, 16, 5).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(1, 7, 16).astype(np.float32))
    leaves = [bp["conv_in"]["kernel"], bp["down_blocks"][0]["resnets"][0]
              ["conv1"]["kernel"], bp["mid_block"]["resnets"][1]["norm2"]
              ["scale"], up["up_blocks"][1]["attentions"][0]["blocks"][0]
              ["attn1"]["to_q"]["kernel"], up["mid_block"]["resnets"][0]
              ["conv2"]["kernel"]]
    for p in leaves:
        p.requires_grad_()

    def crop(r):
        return r[:, :, r.shape[2] - r.shape[1]:, :]
    d, m, u = tblob.blobnet_apply(bp, bcfg, blob_in, 300.0, remat=remat)
    out = tunet.unet_apply(up, ucfg, unet_in, 300.0, ctx, [crop(r) for r in d],
                           crop(m), [crop(r) for r in u], remat=remat)
    return out.square().mean(), leaves


def test_remat_on_and_off_give_equal_gradients():
    want = torch.autograd.grad(*_tiny_loss(False))
    got = torch.autograd.grad(*_tiny_loss(True))
    for g, w in zip(got, want):
        assert w.abs().max() > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * w.abs().max().item())
