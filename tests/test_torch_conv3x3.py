"""The port's conv3x3 (the wrapper's CPU route, i.e. the plain version)
against the JAX package's Pallas conv in interpret mode, fp32, with and
without the GroupNorm+SiLU prologue."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blobctrl_tpu.ops.conv3x3 import conv3x3 as jconv3x3
from blobctrl_torch.ops import conv3x3 as tconv

torch.set_num_threads(2)

# Co = 40 is not a tile multiple; C = 37 is the odd stand-in for 1029
CASES = [(2, 8, 16, 32, 40), (1, 8, 8, 37, 48), (2, 6, 10, 37, 40)]


def _inputs(b, h, w, c, co, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(b, c)).astype(np.float32)
    shift = rng.randn(b, c).astype(np.float32)
    return x, k, bias, scale, shift


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("b,h,w,c,co", CASES)
def test_conv3x3_matches_pallas_interpret(b, h, w, c, co, prologue):
    x, k, bias, scale, shift = _inputs(b, h, w, c, co)
    pro = (scale, shift) if prologue else (None, None)
    want = np.asarray(jconv3x3(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
        *(None if p is None else jnp.asarray(p) for p in pro),
        interpret=True))
    t = torch.from_numpy
    before = tconv.launches
    got = tconv.conv3x3(t(x), t(k), t(bias),
                        *(None if p is None else t(p) for p in pro)).numpy()
    assert tconv.launches == before  # the CPU route launches no kernel
    assert got.shape == (b, h, w, co)
    # fp32, K = 9*C terms summed in another order: relative to max |y|
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    # the border rows and columns, where padding meets the prologue
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[sl], want[sl],
                                   atol=1e-5 * np.abs(want).max(), rtol=0)


def test_prologue_pads_after_activation():
    """Taps outside the image contribute 0, not silu(shift): padding before
    the activation gives different borders, and the JAX kernel agrees with
    the pad-after rule."""
    b, h, w, c, co = 1, 8, 8, 37, 40
    x, k, bias, scale, shift = _inputs(b, h, w, c, co)
    want = np.asarray(jconv3x3(jnp.asarray(x), jnp.asarray(k),
                               jnp.asarray(bias), jnp.asarray(scale),
                               jnp.asarray(shift), interpret=True))
    t = torch.from_numpy
    act = torch.nn.functional.silu(t(x) * t(scale)[:, None, None]
                                   + t(shift)[:, None, None])
    pad_after = tconv.conv3x3_reference(act, t(k), t(bias)).numpy()
    xp = torch.nn.functional.pad(t(x), (0, 0, 1, 1, 1, 1))
    actp = torch.nn.functional.silu(xp * t(scale)[:, None, None]
                                    + t(shift)[:, None, None])
    pad_before = torch.nn.functional.conv2d(
        actp.permute(0, 3, 1, 2), t(k).permute(3, 2, 0, 1)).permute(
            0, 2, 3, 1).numpy() + bias
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(pad_after, want, atol=tol, rtol=0)
    np.testing.assert_allclose(pad_before[:, 1:-1, 1:-1],
                               want[:, 1:-1, 1:-1], atol=tol, rtol=0)
    assert np.abs(pad_before[:, 0] - want[:, 0]).max() > 100 * tol
