"""The port's int8 mode against the JAX package, fp32 on the CPU: the
quantizers, the int8 conv3x3 and the int8 flash attention (the wrappers' CPU
routes, i.e. the plain versions, against the Pallas kernels in interpret
mode), ``from_jax`` on pre-quantized trees, and the routing that sends a
UNet's convs and long attentions to the int8 plain versions."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.ops import conv3x3 as jconv
from blobctrl_tpu.ops import flash_attention as jfa
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.nn import attention as tattn
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.ops import flash_attention as tfa
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.train import toy as ttoy
from blobctrl_torch.utils import benchkit as tbench

torch.set_num_threads(2)

t = torch.from_numpy


@pytest.fixture
def conv_int8():
    """Turns the port's int8 conv mode on with a given act_amax; restores
    the previous switches after the test."""
    saved = (tconv._CONV_INT8, tconv._CONV_INT8_ACT_AMAX)
    yield lambda amax: tconv.set_conv_int8(True, act_amax=amax)
    tconv.set_conv_int8(saved[0], act_amax=saved[1])


# ---------------------------------------------------------------------------
# quantizers: bit-equal to the JAX package's (as XLA compiles them, in jit)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 300, 40), (1, 384, 80), (3, 7, 16)])
def test_quantize_rows_bit_equal(shape):
    x = (np.random.RandomState(1).randn(*shape) * 3).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-20 floor
    jq, js = jax.jit(jfa._quantize_rows)(jnp.asarray(x))
    tq, ts = tfa.quantize_rows(t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("global_k", [True, False])
def test_int8_operands_match_jax(global_k):
    """The pre-pass of ``_flash_attention`` (`:426-451`): int8 q and k
    (under the global k scale, or per-row scales) bit-equal, and the fp32
    multipliers rm = qs * (scale * log2 e) * ka or qs * scale within 2 ulp:
    XLA folds the 1/127 factors and scale * log2 e into one constant and
    reassociates the product, which the port's op-by-op order does not."""
    rng = np.random.RandomState(2)
    q, k = (rng.randn(2, 256, 40).astype(np.float32) * s for s in (1.0, 2.5))
    scale = 1.0 / np.sqrt(40)

    @jax.jit
    def jax_prepass(qp, kp):
        qi, qs = jfa._quantize_rows(qp)
        if not global_k:
            ki, ks = jfa._quantize_rows(kp)
            return qi, qs * scale, ki, ks
        ka = jnp.maximum(jnp.max(jnp.abs(kp.astype(jnp.float32))),
                         1e-20) / 127.0
        ki = jnp.clip(jnp.round(kp.astype(jnp.float32) / ka),
                      -127, 127).astype(jnp.int8)
        return qi, (qs * (scale * jfa.LOG2E) * ka).astype(jnp.float32), ki, None

    want = jax_prepass(jnp.asarray(q), jnp.asarray(k))
    got = tfa.int8_operands(t(q), t(k), scale, global_k)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None)
        if g is None:
            continue
        if i == 1:
            np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), 2)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(3, 3, 37, 40), (3, 3, 64, 128),
                                   (32, 24)])
def test_quantize_kernel_i8_matches_jax(shape):
    """Scales bit-equal; weights equal but for one-step flips at rounding
    ties, where XLA may compile w / ws as a reciprocal multiply
    (tests/test_conv3x3_kernel.py explains), on at most 0.1 % of them."""
    k = (np.random.RandomState(3).randn(*shape) * 0.05).astype(np.float32)
    jq, js = jax.jit(jconv._quantize_kernel_i8)(jnp.asarray(k))
    tq, ts = tconv.quantize_kernel_i8(t(k))
    assert tq.dtype == torch.int8 and ts.shape == (shape[-1],)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3


def _leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        out = set()
        for k, v in tree.items():
            out |= _leaf_paths(v, path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = set()
        for i, v in enumerate(tree):
            out |= _leaf_paths(v, path + (i,))
        return out
    return {path}


def test_quantize_conv_tree_same_leaves_as_jax():
    """On a UNet (toy geometry): the same leaves get kernel_q/w_scale, with
    the same values; other leaves pass through as the same objects; a
    second pass changes nothing."""
    ucfg = ttoy.toy_configs()[0]
    jp = junet.init_unet(jax.random.PRNGKey(0), ucfg)
    jq = jconv.quantize_conv_tree(jp)
    tp = from_jax(jp, device="cpu")
    tq = tconv.quantize_conv_tree(tp)
    assert _leaf_paths(tq) == _leaf_paths(jq)
    added = _leaf_paths(tq) - _leaf_paths(tp)
    assert added and all(p[-1] in ("kernel_q", "w_scale") for p in added)

    def get(tree, path):
        for p in path:
            tree = tree[p]
        return tree
    for path in added:
        if path[-1] == "w_scale":
            np.testing.assert_array_equal(get(tq, path).numpy(),
                                          np.asarray(get(jq, path)))
    conv_in = tq["down_blocks"][0]["resnets"][0]["conv1"]
    assert conv_in["kernel"] is tp["down_blocks"][0]["resnets"][0][
        "conv1"]["kernel"]
    assert conv_in["kernel_q"].dtype == torch.int8
    again = tconv.quantize_conv_tree(tq)
    assert again["down_blocks"][0]["resnets"][0]["conv1"]["kernel_q"] \
        is conv_in["kernel_q"]


def test_from_jax_keeps_quantized_leaves():
    """kernel_q stays int8 and w_scale fp32 in a bf16 tree."""
    k = jnp.asarray(np.random.RandomState(4).randn(3, 3, 8, 16) * 0.1,
                    jnp.float32)
    jq = jconv.quantize_conv_tree({"conv": {"kernel": k,
                                            "bias": jnp.zeros((16,))}})
    tq = from_jax(jq, device="cpu", dtype=torch.bfloat16)["conv"]
    assert tq["kernel"].dtype == torch.bfloat16
    assert tq["bias"].dtype == torch.bfloat16
    assert tq["kernel_q"].dtype == torch.int8
    assert tq["w_scale"].dtype == torch.float32
    np.testing.assert_array_equal(tq["w_scale"].numpy(),
                                  np.asarray(jq["conv"]["w_scale"]))
    np.testing.assert_array_equal(tq["kernel_q"].numpy(),
                                  np.asarray(jq["conv"]["kernel_q"]))


# ---------------------------------------------------------------------------
# int8 conv3x3
# ---------------------------------------------------------------------------

# Co = 40 is not a tile multiple; C = 37 is the odd stand-in for 1029
CONV_CASES = [(2, 8, 16, 32, 40), (1, 8, 8, 37, 48), (2, 6, 10, 37, 40)]


def _conv_inputs(b, h, w, c, co, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(b, c)).astype(np.float32)
    shift = rng.randn(b, c).astype(np.float32)
    return x, k, bias, scale, shift


@pytest.mark.parametrize("act_amax", [12.0, 6.0, None])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("b,h,w,c,co", CONV_CASES)
def test_conv3x3_int8_matches_pallas_interpret(b, h, w, c, co, prologue,
                                               act_amax, conv_int8):
    """``conv3x3`` in the int8 mode, with the JAX package's pre-quantized
    weights carried across by ``from_jax``."""
    x, k, bias, scale, shift = _conv_inputs(b, h, w, c, co)
    pro = (scale, shift) if prologue else (None, None)
    jtree = jconv.quantize_conv_tree({"kernel": jnp.asarray(k),
                                      "bias": jnp.asarray(bias)})
    want = np.asarray(jconv.conv3x3(
        jnp.asarray(x), jtree["kernel"], jtree["bias"],
        *(None if p is None else jnp.asarray(p) for p in pro),
        interpret=True, int8=True, act_amax=act_amax,
        kernel_q=jtree["kernel_q"], w_scale=jtree["w_scale"]))
    tp = from_jax(jtree, device="cpu")
    conv_int8(act_amax)
    before = (tconv.launches, tconv.int8_launches)
    got = tconv.conv3x3(t(x), tp["kernel"], tp["bias"],
                        *(None if p is None else t(p) for p in pro),
                        kernel_q=tp["kernel_q"], w_scale=tp["w_scale"])
    assert (tconv.launches, tconv.int8_launches) == before  # no kernel
    assert got.shape == (b, h, w, co)
    # the JAX package's own int8 tolerance, relative to max |y|
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-5 * np.abs(want).max(), rtol=0)


def test_conv3x3_int8_quantizes_unquantized_weights(conv_int8):
    """Without kernel_q the int8 mode quantizes w in the call, as the JAX
    package's in-graph path does."""
    x, k, bias, _, _ = _conv_inputs(1, 8, 8, 37, 48)
    want = np.asarray(jconv.conv3x3(jnp.asarray(x), jnp.asarray(k),
                                    jnp.asarray(bias), interpret=True,
                                    int8=True, act_amax=12.0))
    conv_int8(12.0)
    got = tconv.conv3x3(t(x), t(k), t(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(),
                               rtol=0)


def test_conv3x3_int8_static_amax_saturates(conv_int8):
    """Out-of-range activations saturate to +-amax instead of wrapping (the
    case of tests/test_conv3x3_kernel.py)."""
    x = np.zeros((1, 4, 8, 128), np.float32)
    x[0, 1, 3, 5] = 50.0  # far beyond amax=6
    k = np.zeros((3, 3, 128, 128), np.float32)
    k[1, 1, 5, 0] = 1.0   # center tap passthrough
    want = np.asarray(jconv.conv3x3(jnp.asarray(x), jnp.asarray(k), None,
                                    interpret=True, int8=True, act_amax=6.0))
    conv_int8(6.0)
    got = tconv.conv3x3(t(x), t(k)).numpy()
    np.testing.assert_allclose(got[0, 1, 3, 0], 6.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_conv3x3_int8_reference_is_the_quantized_math():
    """The plain version against explicit numpy integer math: quantize with
    a true division, pad, integer taps, fp32 rescale plus bias."""
    b, h, w, c, co = 1, 6, 10, 37, 40
    x, k, bias, _, _ = _conv_inputs(b, h, w, c, co, seed=5)
    wq, ws = (a.numpy() for a in tconv.quantize_kernel_i8(t(k)))
    xs = np.float32(6.0 / 127.0)
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int64)
    xp = np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = sum(np.einsum("bhwc,cd->bhwd", xp[:, dh:dh + h, dw:dw + w],
                        wq[dh, dw].astype(np.int64))
              for dh in range(3) for dw in range(3))
    ref = acc.astype(np.float32) * (xs * ws) + bias
    got = tconv.conv3x3_int8_reference(t(x), t(wq), t(ws), t(bias),
                                       act_amax=6.0).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# int8 flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("global_k", [True, False])
@pytest.mark.parametrize("b,h,s,d", [(1, 2, 256, 40), (1, 1, 384, 80)])
def test_flash_int8_matches_pallas_interpret(b, h, s, d, global_k):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        interpret=True, qk_int8=True, int8_global_k=global_k))

    def flat(x):
        return t(x.reshape(b * h, s, d))

    before = tfa.int8_launches
    got = tfa.flash_attention_int8(flat(q), flat(k), flat(v), scale,
                                   global_k=global_k)
    assert tfa.int8_launches == before  # the CPU route launches no kernel
    np.testing.assert_allclose(got.numpy().reshape(b, h, s, d), want,
                               atol=2e-5, rtol=1e-4)


def test_flash_int8_refuses_running_max():
    q = torch.zeros(1, 128, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention_int8(q, q, q, 0.25, fixed_max=None)
    with pytest.raises(ValueError):
        jfa.flash_attention(jnp.zeros((1, 1, 128, 16)),
                            jnp.zeros((1, 1, 128, 16)),
                            jnp.zeros((1, 1, 128, 16)), scale=0.25,
                            interpret=True, qk_int8=True, fixed_max=None)


# ---------------------------------------------------------------------------
# routing on the CPU: by shape, into the plain versions
# ---------------------------------------------------------------------------

def _unet_call():
    """A 2-level UNet at 32/64 channels on a double-width 32 x 64 latent:
    routed convs (C >= 32) and 2048-token self-attention at level 0."""
    cfg = ttoy.toy_configs()[0]
    params = tunet.init_unet(cfg, key=0, device="cpu")
    rng = np.random.RandomState(6)
    x = t(rng.randn(1, 32, 64, 5).astype(np.float32))
    ctx = t(rng.randn(1, 7, 16).astype(np.float32))
    with torch.inference_mode():
        return tunet.unet_apply(params, cfg, x, 500.0, ctx)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("int8", [False, True])
def test_routing_reaches_the_plain_versions_on_cpu(monkeypatch, int8):
    """The shape decides the route, the device the implementation: on the
    CPU the routed convs and long attentions reach the ops' plain versions
    (the int8 ones in the int8-everything mode), and no kernel launches."""
    names = ([(tconv, "conv3x3_int8_reference"),
              (tfa, "flash_attention_int8_reference")] if int8 else
             [(tconv, "conv3x3_reference"),
              (tfa, "flash_attention_reference")])
    calls = [_spy(monkeypatch, mod, name) for mod, name in names]
    others = [_spy(monkeypatch, mod, name) for mod, name in
              ([(tconv, "conv3x3_reference"),
                (tfa, "flash_attention_reference")] if int8 else
               [(tconv, "conv3x3_int8_reference"),
                (tfa, "flash_attention_int8_reference")])]
    before = (tconv.launches, tconv.int8_launches, tfa.launches,
              tfa.int8_launches)
    if int8:
        with tbench.int8_everything():
            assert tattn.attention_int8_mode() == (True, True)
            out = _unet_call()
        assert tattn.attention_int8_mode() == (False, False)
        assert not tconv.conv_int8_enabled()
    else:
        out = _unet_call()
    assert torch.isfinite(out).all()
    assert all(len(c) > 0 for c in calls), [len(c) for c in calls]
    assert all(len(c) == 0 for c in others), [len(c) for c in others]
    assert (tconv.launches, tconv.int8_launches, tfa.launches,
            tfa.int8_launches) == before


def test_attention_backend_switch():
    with pytest.raises(ValueError):
        tattn.set_attention_backend("xla")
    tattn.set_attention_backend("auto", qk_int8=True)
    try:
        assert tattn.attention_int8_mode() == (True, False)
    finally:
        tattn.set_attention_backend("auto", qk_int8=False)
