"""The int8 linear path (``nn.layers.set_linear_int8``), the port against
the JAX package on the CPU, fp32.

``quantize_act_i8`` and ``matmul_i8`` bit-equal to JAX's (the int32
products exact on both sides: XLA's int32 dot, the port's fp64 product off
the card); the linear layer, the 1x1 proj conv and the self-attention's
fused int8 QKV product take the int8 path only with the switch on and the
weights pre-quantized. End to end, the toy-256 move edit of
``test_torch_int8_pipeline`` in the int8-everything mode with the int8
linears added, on both sides with the card's routing rule on the JAX side,
held to that file's bar measured for this mode: the JAX edit against itself
under a one-ulp nudge of its latents, less 1 dB, capped at 50 dB."""

import numpy as np
import pytest
import torch

from blobctrl_tpu.nn import attention as jattn
from blobctrl_tpu.nn import layers as jlayers
from blobctrl_tpu.nn import resnet as jres
from blobctrl_tpu.ops import conv3x3 as jconv
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.nn import attention as tattn
from blobctrl_torch.nn import layers as tlayers
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.pipeline import blobnet_pipeline as tbp
from blobctrl_torch.train import toy as ttoy
from blobctrl_torch.utils import benchkit as tbench
from tests.test_torch_int8_pipeline import (_card_route_conv, _card_use_flash,
                                            _psnr)
from tests.test_torch_pipeline import _edits

torch.set_num_threads(2)


@pytest.fixture
def linear_int8():
    tlayers.set_linear_int8(True)
    jlayers.set_linear_int8(True)
    yield
    tlayers.set_linear_int8(False)
    jlayers.set_linear_int8(False)


@pytest.mark.parametrize("shape", [(5, 40), (2, 17, 320), (1, 4, 6, 64)])
def test_quantize_act_bit_equal(shape):
    x = (np.random.RandomState(1).randn(*shape) * 6).astype(np.float32)
    x.flat[:4] = [12.0, -12.0, 30.0, 12.0 / 127 * 2.5]   # clip, a tie
    jq, js = jlayers.quantize_act_i8(x)
    tq, ts = tlayers.quantize_act_i8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(np.asarray(js))


@pytest.mark.parametrize("m,k,n,bias", [(7, 40, 120, True), (33, 320, 960,
                                                                False),
                                        (8, 1280, 80, True)])
def test_matmul_i8_bit_equal(m, k, n, bias):
    rng = np.random.RandomState(m + k)
    x = (rng.randn(m, k) * 4).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if bias else None
    kq, ws = tconv.quantize_kernel_i8(torch.from_numpy(w))
    want = np.asarray(jlayers.matmul_i8(x, kq.numpy(), ws.numpy(), b,
                                        np.float32))
    got = tlayers.matmul_i8(torch.from_numpy(x), kq, ws,
                            None if b is None else torch.from_numpy(b),
                            torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # the int32 sums themselves, exact on both sides
    xq, _ = tlayers.quantize_act_i8(torch.from_numpy(x))
    acc = torch.matmul(xq.double(), kq.double())
    assert torch.equal(acc, torch.round(acc))
    assert acc.abs().max() <= 127 * 127 * k


def test_layers_take_the_int8_path_only_when_on(linear_int8, monkeypatch):
    rng = np.random.RandomState(2)
    w = torch.from_numpy((rng.randn(32, 32) / 6).astype(np.float32))
    p = {"kernel": w, "bias": torch.zeros(32)}
    pq = tconv.quantize_conv_tree({"to_out": p})["to_out"]
    conv = {"kernel": w.reshape(1, 1, 32, 32), "bias": torch.zeros(32)}
    cq = tconv.quantize_conv_tree({"proj_in": conv})["proj_in"]
    calls = []
    real = tlayers.matmul_i8
    monkeypatch.setattr(tlayers, "matmul_i8",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    x = torch.randn(2, 3, 4, 32)
    tlayers.linear(p, x)                 # no kernel_q: the float product
    assert calls == []
    y = tlayers.linear(pq, x)
    y2 = tlayers.conv2d(cq, x)
    assert calls == [(32, 32), (32, 32)]
    np.testing.assert_array_equal(y.numpy(), y2.numpy())
    tlayers.set_linear_int8(False)
    tlayers.linear(pq, x)
    assert len(calls) == 2


def _qkv_spy(monkeypatch):
    """-> the shapes of the fused int8 QKV products that run from now on."""
    qkv = []
    real = tlayers.matmul_i8

    def spy(x, kernel_q, *rest):
        if kernel_q.shape[1] == 3 * kernel_q.shape[0]:
            qkv.append(tuple(kernel_q.shape))
        return real(x, kernel_q, *rest)
    monkeypatch.setattr(tlayers, "matmul_i8", spy)
    return qkv


def _check_against_nudge_floor(got, want, nudged, qkv, size, label):
    assert got.shape == want.shape == (1, size, size, 3)
    assert np.isfinite(got).all()
    assert qkv, "the fused int8 QKV product never ran"
    assert tattn.layers is tlayers
    floor = _psnr(nudged, want)
    print(f"{label}: port vs JAX {_psnr(got, want):.2f} dB; JAX vs JAX with "
          f"one-ulp latents {floor:.2f} dB")
    assert _psnr(got, want) >= min(50.0, floor - 1.0), (_psnr(got, want),
                                                       floor)


def _nudged(edit):
    return dict(edit, latents=np.nextafter(edit["latents"],
                                           np.float32(np.inf)))


def test_toy_256_int8_linear_edit_matches_jax(monkeypatch, linear_int8):
    edit = _edits(256)["move"]
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt_256")
    monkeypatch.setattr(jres, "_route_conv", _card_route_conv)
    monkeypatch.setattr(jattn, "_use_flash", _card_use_flash)
    jattn.set_attention_backend("interpret", qk_int8=True, int8_global_k=True)
    jconv.set_conv_int8(True)
    try:
        want = jpipe(**edit).images
        nudged = jpipe(**_nudged(edit)).images
    finally:
        jattn.set_attention_backend("auto", qk_int8=False,
                                    int8_global_k=False)
        jconv.set_conv_int8(False)

    tpipe, _ = ttoy.load_toy("assets/toy_ckpt_256", device="cpu")
    qkv = _qkv_spy(monkeypatch)
    with tbench.int8_everything():
        assert tbp.numeric_state()[-2] is True   # the memos key on it
        got = tpipe(**edit).images
    _check_against_nudge_floor(got, want, nudged, qkv, 256,
                               "int8 + int8 linear toy-256 move edit")


def test_linear_int8_alone_edit_matches_jax(monkeypatch, linear_int8):
    """The switch alone, every other mode exact: the pipeline derives the
    int8 leaves for it (as the JAX package does), so the linears, the 1x1
    proj convs and the fused QKV take the int8 product."""
    edit = _edits(128)["move"]
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt")
    want = jpipe(**edit).images
    nudged = jpipe(**_nudged(edit)).images
    tpipe, _ = ttoy.load_toy("assets/toy_ckpt", device="cpu")
    qkv = _qkv_spy(monkeypatch)
    assert not tconv.conv_int8_enabled()
    got = tpipe(**edit).images
    _check_against_nudge_floor(got, want, nudged, qkv, 128,
                               "int8 linear alone toy-128 move edit")


def test_int8_qkv_with_ln_matmul_fusion_keeps_the_layernorm(linear_int8):
    """The int8 fused QKV product has no LayerNorm prologue, so with the
    LN -> projection fusion on the port applies the LayerNorm first: the
    output equals the unfused int8 output. (The JAX package feeds the
    un-normalized x to its int8 product there, a reference-side hazard.)"""
    k_attn, k_scale, k_bias, k_x = tlayers.ParamInit(3, "cpu").split(4)
    params = tconv.quantize_conv_tree(
        {"attn": tattn.init_attention(k_attn, 64)})["attn"]
    norm = {"scale": 1.0 + 0.1 * k_scale.normal((64,), 1.0),
            "bias": k_bias.normal((64,), 0.5)}
    x = 3.0 + 2.0 * k_x.normal((2, 24, 64), 1.0)
    outs = {}
    try:
        for mode in ("off", "on"):
            tattn.set_ln_matmul_fuse(mode)
            outs[mode] = tattn.attention(params, x, heads=2, norm=norm)
    finally:
        tattn.set_ln_matmul_fuse("off")
    torch.testing.assert_close(outs["on"], outs["off"], rtol=0, atol=0)
    raw = tattn.attention(params, x, heads=2)   # no LayerNorm at all
    assert not torch.equal(raw, outs["on"])
