"""The fused-kernel edit's four ops against the JAX package, fp32 on the CPU:
the exp2-folded flash attention, GroupNorm -> 1x1 projection (gn_proj,
matmul_residual), LayerNorm -> projection (ln_matmul) and the Winograd
F(2x2, 3x3) conv. Each port op takes its plain version for CPU tensors;
the JAX side runs its Pallas kernels in interpret mode. Then the routing:
with the four switches on, a UNet and a BlobNet call reach each plain
version, and no kernel launches."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blobctrl_tpu.ops import flash_attention as jfa
from blobctrl_tpu.ops import gn_matmul as jgn
from blobctrl_tpu.ops import ln_matmul as jln
from blobctrl_tpu.ops import winograd as jwg
from blobctrl_torch import ops as tops
from blobctrl_torch.models import blobnet as tblob
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.nn import attention as tattn
from blobctrl_torch.nn import layers as tlayers
from blobctrl_torch.nn import transformer_2d as tt2d
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.ops import flash_attention as tfa
from blobctrl_torch.ops import gn_matmul as tgn
from blobctrl_torch.ops import ln_matmul as tln
from blobctrl_torch.ops import winograd as twg
from blobctrl_torch.train import toy as ttoy
from blobctrl_torch.utils import benchkit as tbench
from tests.test_torch_int8_ops import _spy

torch.set_num_threads(2)

t = torch.from_numpy


# ---------------------------------------------------------------------------
# exp2-folded flash attention
# ---------------------------------------------------------------------------

@pytest.fixture
def exp2_fold():
    saved = tfa.exp2_fold_enabled()
    tfa.set_exp2_fold(True)
    yield
    tfa.set_exp2_fold(saved)


@pytest.mark.parametrize("bh,s,d", [(2, 256, 40), (1, 384, 80),
                                    (1, 256, 160)])
def test_exp2_fold_matches_pallas_interpret(exp2_fold, monkeypatch, bh, s,
                                            d):
    rng = np.random.RandomState(bh * s + d)
    q, k, v = (rng.randn(1, bh, s, d).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=scale, interpret=True, exp2_fold=True)
    calls = _spy(monkeypatch, tfa, "flash_attention_exp2_reference")
    got = tfa.flash_attention(t(q[0]), t(k[0]), t(v[0]), scale)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], atol=2e-5,
                               rtol=1e-4)


def test_exp2_operands_round_to_q_dtype():
    """q' and the shift round to q's dtype, with JAX's constants: its
    weakly typed Python scalars take the array's dtype first."""
    rng = np.random.RandomState(0)
    q = rng.randn(2, 64, 40).astype(np.float32)
    scale = 40 ** -0.5
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jq = jnp.asarray(q, jdt)
        want_q = (jq * (scale * jfa.LOG2E)).astype(jdt)
        want_shift = jnp.full((1,), -20.0 * jfa.LOG2E, jdt)
        got_q, got_shift = tfa.exp2_operands(t(q).to(tdt), scale, 20.0)
        assert got_q.dtype == tdt
        np.testing.assert_array_equal(got_q.float().numpy(),
                                      np.asarray(want_q, np.float32))
        assert got_shift == float(np.asarray(want_shift, np.float32)[0])


def test_exp2_fold_does_not_apply_without_fixed_max_or_with_int8(
        exp2_fold, monkeypatch):
    """As in the JAX package (`_flash_attention`, `:368`): the fold needs a
    numeric fixed_max and no int8 q.k^T."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 2, 256, 40).astype(np.float32) for _ in range(3))
    scale = 40 ** -0.5
    calls = _spy(monkeypatch, tfa, "flash_attention_exp2_reference")
    args = tuple(t(a[0]) for a in (q, k, v)) + (scale,)
    for jkw, got, want in (
            (dict(fixed_max=None), tfa.flash_attention(*args, fixed_max=None),
             tfa.flash_attention_reference(*args)),
            (dict(qk_int8=True, int8_global_k=True),
             tfa.flash_attention_int8(*args),
             tfa.flash_attention_int8_reference(*args))):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        jargs = tuple(jnp.asarray(a) for a in (q, k, v))
        folded = jfa.flash_attention(*jargs, scale=scale, interpret=True,
                                     exp2_fold=True, **jkw)
        plain = jfa.flash_attention(*jargs, scale=scale, interpret=True,
                                    exp2_fold=False, **jkw)
        np.testing.assert_array_equal(np.asarray(folded), np.asarray(plain))
        np.testing.assert_allclose(got.numpy(), np.asarray(folded)[0],
                                   atol=2e-5, rtol=1e-4)
    assert not calls


# ---------------------------------------------------------------------------
# GroupNorm -> 1x1 projection
# ---------------------------------------------------------------------------

def _gn_setup(b, h, w, c, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    norm = {"scale": (rng.randn(c) * 0.2 + 1.0).astype(np.float32),
            "bias": (rng.randn(c) * 0.1).astype(np.float32)}
    conv = {"kernel": (rng.randn(1, 1, c, n) / np.sqrt(c)).astype(np.float32),
            "bias": (rng.randn(n) * 0.1).astype(np.float32)}
    res = rng.randn(b, h, w, n).astype(np.float32)
    return x, norm, conv, res


def _jax_tree(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch_tree(p):
    return {k: t(v) for k, v in p.items()}


def test_gn_affine_matches_jax():
    x, norm, _, _ = _gn_setup(2, 8, 16, 64, 32, seed=4)
    js, jt = jgn.gn_affine(jnp.asarray(x), _jax_tree(norm), 8, 1e-6)
    ts, tt = tgn.gn_affine(t(x), _torch_tree(norm), 8, 1e-6)
    for got, want in ((ts, js), (tt, jt)):
        assert got.dtype == torch.float32 and got.shape == (2, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(want)).max())


# (b, h, w, c, n, groups, block_m): the cases of tests/test_gn_matmul_kernel.py
GN_CASES = [(1, 8, 16, 32, 32, 8, 32), (2, 8, 8, 64, 64, 8, 32),
            (2, 4, 8, 32, 64, 8, 32), (1, 4, 8, 32, 48, 4, 16)]


@pytest.mark.parametrize("b,h,w,c,n,groups,block_m", GN_CASES)
@pytest.mark.parametrize("residual", [False, True])
def test_gn_proj_matches_pallas_interpret(b, h, w, c, n, groups, block_m,
                                          residual):
    x, norm, conv, res = _gn_setup(b, h, w, c, n, seed=b + h + c + n)
    want = jgn.gn_proj(jnp.asarray(x), _jax_tree(norm), _jax_tree(conv),
                       groups=groups, eps=1e-6,
                       residual=jnp.asarray(res) if residual else None,
                       interpret=True, block_m=block_m, block_n=128)
    got = tgn.gn_proj(t(x), _torch_tree(norm), _torch_tree(conv),
                      groups=groups, eps=1e-6,
                      residual=t(res) if residual else None)
    assert got.shape == (b, h, w, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_matmul_residual_matches_pallas_interpret():
    x, _, conv, res = _gn_setup(2, 8, 16, 64, 64, seed=2)
    want = jgn.matmul_residual(jnp.asarray(x), _jax_tree(conv),
                               jnp.asarray(res), interpret=True, block_m=32,
                               block_n=128)
    got = tgn.matmul_residual(t(x), _torch_tree(conv), t(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_gn_proj_any_hw_matches_unfused():
    """h * w = 9 (no multiple of 8, where the Pallas kernel's block-size
    fallback leaves rows unwritten): the port's plain version against the
    unfused GroupNorm -> 1x1 conv of its own layers."""
    x, norm, conv, _ = _gn_setup(2, 3, 3, 32, 40, seed=9)
    want = tlayers.conv2d(_torch_tree(conv), tlayers.group_norm(
        _torch_tree(norm), t(x), 8, eps=1e-6))
    got = tgn.gn_proj(t(x), _torch_tree(norm), _torch_tree(conv), groups=8,
                      eps=1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# LayerNorm -> projection
# ---------------------------------------------------------------------------

# (m, c, n): the cases of tests/test_ln_matmul_kernel.py
@pytest.mark.parametrize("m,c,n", [(256, 320, 960), (512, 64, 128),
                                   (300, 320, 320), (128, 1280, 640)])
def test_ln_matmul_matches_pallas_interpret(m, c, n):
    rng = np.random.RandomState(m + c + n)
    x = rng.randn(m, c).astype(np.float32)
    gamma = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.randn(c) * 0.1).astype(np.float32)
    w = (rng.randn(c, n) / np.sqrt(c)).astype(np.float32)
    wb = (rng.randn(n) * 0.1).astype(np.float32)
    want = jln.ln_matmul(*(jnp.asarray(a) for a in (x, gamma, beta, w, wb)),
                         interpret=True)
    got = tln.ln_matmul(t(x), t(gamma), t(beta), t(w), t(wb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_ln_matmul_no_bias_batched_matches_pallas_interpret():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 77, 64).astype(np.float32)
    gamma = (rng.randn(64) * 0.3 + 1.0).astype(np.float32)
    beta = (rng.randn(64) * 0.1).astype(np.float32)
    w = (rng.randn(64, 128) / 8.0).astype(np.float32)
    want = jln.ln_matmul(jnp.asarray(x), jnp.asarray(gamma),
                         jnp.asarray(beta), jnp.asarray(w), None,
                         interpret=True)
    got = tln.ln_matmul(t(x), t(gamma), t(beta), t(w))
    assert got.shape == (2, 77, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# Winograd F(2x2, 3x3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 8, 8), (3, 3, 37, 40),
                                   (3, 3, 320, 64)])
def test_transform_weights_bit_equal(shape):
    k = (np.random.RandomState(1).randn(*shape) * 0.3).astype(np.float32)
    want = np.asarray(jwg.transform_weights(jnp.asarray(k)))
    got = twg.transform_weights(t(k))
    assert got.dtype == torch.float32 and got.shape == (16,) + shape[2:]
    np.testing.assert_array_equal(got.numpy(), want)


def _max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# the cases of tests/test_winograd.py, plus C = 37 into Co = 40
@pytest.mark.parametrize("b,h,w,c,co", [
    (2, 8, 16, 320, 320), (1, 6, 10, 64, 128), (2, 4, 8, 1280, 1280),
    (1, 8, 8, 320, 640), (2, 16, 4, 32, 32), (1, 8, 8, 37, 40)])
def test_winograd_matches_pallas_interpret(b, h, w, c, co):
    rng = np.random.RandomState(c + co)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    want = jwg.conv3x3_winograd(jnp.asarray(x), jnp.asarray(k),
                                jnp.asarray(bias), interpret=True)
    got = twg.conv3x3_winograd(t(x), t(k), t(bias))
    assert got.shape == (b, h, w, co)
    assert _max_rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("c,co", [(64, 64), (37, 40)])
def test_winograd_prologue_matches_pallas_interpret(c, co):
    """The silu(x * scale + shift) prologue, with per-batch (B, C) terms
    (as the resnet's GroupNorm fold gives them) and zero padding after it."""
    b, h, w = 2, 8, 8
    rng = np.random.RandomState(c)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    sc = (rng.randn(b, c) * 0.5 + 1.0).astype(np.float32)
    sh = rng.randn(b, c).astype(np.float32)
    want = jwg.conv3x3_winograd(*(jnp.asarray(a) for a in (x, k, bias, sc,
                                                           sh)),
                                interpret=True)
    got = twg.conv3x3_winograd(*(t(a) for a in (x, k, bias, sc, sh)))
    assert _max_rel(got.numpy(), want) < 1e-5


def test_winograd_refuses_odd_shapes():
    x = torch.zeros(1, 7, 8, 32)
    k = torch.zeros(3, 3, 32, 16)
    with pytest.raises(ValueError):
        twg.conv3x3_winograd(x, k)
    with pytest.raises(ValueError):
        twg.conv3x3_winograd(x.transpose(1, 2), k)


def test_winograd_uses_the_pretransformed_weights():
    rng = np.random.RandomState(5)
    x = t(rng.randn(1, 8, 8, 32).astype(np.float32))
    k = t((rng.randn(3, 3, 32, 16) * 0.1).astype(np.float32))
    u = twg.transform_weights(k)
    a = twg.conv3x3_winograd(x, None, u=u)
    np.testing.assert_array_equal(a.numpy(),
                                  twg.conv3x3_winograd(x, k).numpy())
    # the conv3x3 route passes u through
    tconv.set_winograd(True)
    try:
        b = tconv.conv3x3(x, torch.zeros_like(k), u=u)
    finally:
        tconv.set_winograd(False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# switches and routing on the CPU
# ---------------------------------------------------------------------------

def test_switches():
    with pytest.raises(ValueError):
        tattn.set_ln_matmul_fuse("interpret")
    with tbench.fused_kernels():
        assert tfa.exp2_fold_enabled() and tt2d.gn_proj_fuse_enabled()
        assert tattn.ln_matmul_fuse_mode() == "on"
        assert tconv.winograd_enabled()
    assert not (tfa.exp2_fold_enabled() or tt2d.gn_proj_fuse_enabled()
                or tconv.winograd_enabled())
    assert tattn.ln_matmul_fuse_mode() == "off"
    tattn.set_ln_matmul_fuse("auto")  # the JAX package's name for off
    try:
        assert tattn.ln_matmul_fuse_mode() == "auto"
    finally:
        tattn.set_ln_matmul_fuse("off")


FUSED = [(tfa, "flash_attention_exp2_reference"),
         (tgn, "affine_matmul_reference"), (tln, "ln_matmul_reference"),
         (twg, "conv3x3_winograd_reference")]


def _unet_blobnet_call():
    """The toy-256 UNet and BlobNet (3 levels, 32/64/96 channels) on a
    double-width 32 x 64 latent: routed convs at every level, 2048-token
    self-attention at level 0, cross-attention in the UNet."""
    ucfg, bcfg, _ = ttoy.toy_configs(size=256)
    up = tunet.init_unet(ucfg, key=0, device="cpu")
    bp = tblob.init_blobnet(bcfg, key=1, device="cpu")
    rng = np.random.RandomState(6)
    x = t(rng.randn(1, 32, 64, 5).astype(np.float32))
    blob_in = t(rng.randn(1, 32, 64, 21).astype(np.float32))
    ctx = t(rng.randn(1, 7, 16).astype(np.float32))
    def crop(r):  # the right half, as the pipeline injects it
        return r[:, :, r.shape[2] - r.shape[1]:, :]
    with torch.inference_mode():
        d, m, u = tblob.blobnet_apply(bp, bcfg, blob_in, 500.0)
        return tunet.unet_apply(up, ucfg, x, 500.0, ctx,
                                down_block_add_samples=[crop(r) for r in d],
                                mid_block_add_sample=crop(m),
                                up_block_add_samples=[crop(r) for r in u])


def test_fused_routing_reaches_the_plain_versions_on_cpu(monkeypatch):
    """With the four switches on, a UNet + BlobNet call reaches each fused
    op's plain version (no exact conv3x3 or flash call is left: every
    routed conv has even H and W), no kernel launches, and the output
    agrees with the exact route's; a conv with odd H still reaches
    ``conv3x3_reference``."""
    want = _unet_blobnet_call()
    calls = [_spy(monkeypatch, mod, name) for mod, name in FUSED]
    others = [_spy(monkeypatch, tconv, "conv3x3_reference"),
              _spy(monkeypatch, tfa, "flash_attention_reference")]
    tops.reset_counts()
    with tbench.fused_kernels():
        got = _unet_blobnet_call()
        odd = tconv.conv3x3(torch.zeros(1, 7, 8, 32),
                            torch.zeros(3, 3, 32, 16))
    assert all(len(c) > 0 for c in calls), [len(c) for c in calls]
    assert len(others[0]) == 1 and not others[1]  # the odd-H conv alone
    assert odd.shape == (1, 7, 8, 16)
    assert all(getattr(mod, count) == 0
               for mod, count, _ in tops.KERNELS.values())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
