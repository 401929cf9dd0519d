"""The port's BlobNet -> right-half crop -> UNet-with-injections step
against the JAX package's, at ``apps/flagship.tiny_configs`` with JAX-init
weights carried by ``from_jax``, on a double-width input, fp32. The taps
are non-zero so that every one of the down, mid and up injections matters.
JAX runs once with its Pallas kernels in interpret mode and once on XLA."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blobctrl_tpu.apps import flagship as jflag
from blobctrl_tpu.models import blobnet as jblob
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.nn import attention as jattn
from blobctrl_tpu.nn import resnet as jres
from blobctrl_torch.apps import flagship as tflag
from blobctrl_torch.models import blobnet as tblob
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.params.from_jax import from_jax

torch.set_num_threads(2)

T = 421.0


def _jax_params():
    ucfg, bcfg = jflag.tiny_configs()
    up = junet.init_unet(jax.random.PRNGKey(1), ucfg)
    bp = jblob.init_blobnet(jax.random.PRNGKey(2), bcfg)
    rng = np.random.RandomState(3)

    def randomize(tap):
        return {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.3)
                for k, v in tap.items()}

    bp["zero_down"] = [randomize(p) for p in bp["zero_down"]]
    bp["zero_mid"] = randomize(bp["zero_mid"])
    bp["zero_up"] = [randomize(p) for p in bp["zero_up"]]
    return ucfg, bcfg, up, bp


def _inputs(h=8, w=16, batch=2):
    rng = np.random.RandomState(4)
    blob_in = rng.randn(1, h, w, 21).astype(np.float32)
    unet_in = rng.randn(batch, h, w, 5).astype(np.float32)
    ctx = rng.randn(batch, 7, 16).astype(np.float32)
    return blob_in, unet_in, ctx


def _crop_bcast(r, batch, lib):
    r = r[:, :, r.shape[2] - r.shape[1]:, :]
    return lib.concatenate([r] * batch, 0) if lib is jnp else \
        torch.cat([r] * batch, 0)


def _run_jax(ucfg, bcfg, up, bp, blob_in, unet_in, ctx):
    d, m, u = jblob.blobnet_apply(bp, bcfg, jnp.asarray(blob_in),
                              jnp.asarray(T), 1.3)
    b = unet_in.shape[0]
    return np.asarray(junet.unet_apply(
        up, ucfg, jnp.asarray(unet_in), jnp.asarray(T), jnp.asarray(ctx),
        [_crop_bcast(r, b, jnp) for r in d], _crop_bcast(m, b, jnp),
        [_crop_bcast(r, b, jnp) for r in u]))


def _run_torch(up, bp, blob_in, unet_in, ctx):
    ucfg, bcfg = tflag.tiny_configs()
    d, m, u = tblob.blobnet_apply(bp, bcfg, torch.from_numpy(blob_in), T,
                                  1.3)
    b = unet_in.shape[0]
    return tunet.unet_apply(
        up, ucfg, torch.from_numpy(unet_in), T, torch.from_numpy(ctx),
        [_crop_bcast(r, b, torch) for r in d], _crop_bcast(m, b, torch),
        [_crop_bcast(r, b, torch) for r in u]).numpy()


@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_injected_step_matches_jax(backend):
    ucfg, bcfg, up, bp = _jax_params()
    blob_in, unet_in, ctx = _inputs()
    jattn.set_attention_backend(backend)
    jres.set_conv_backend(backend)
    try:
        want = _run_jax(ucfg, bcfg, up, bp, blob_in, unet_in, ctx)
    finally:
        jattn.set_attention_backend("auto")
        jres.set_conv_backend("auto")
    got = _run_torch(from_jax(up, device="cpu"), from_jax(bp, device="cpu"),
                     blob_in, unet_in, ctx)
    assert got.shape == want.shape == (2, 8, 16, 4)
    # fp32 through ~60 layers, sums in another order
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(),
                               rtol=0)
    # the injections matter: without them the output moves far
    plain = tunet.unet_apply(from_jax(up, device="cpu"), tflag.tiny_configs()[0],
                             torch.from_numpy(unet_in), T,
                             torch.from_numpy(ctx)).numpy()
    assert np.abs(plain - want).max() > 100 * 2e-4 * np.abs(want).max()


def test_square_input_injection_matches_jax():
    """W == H: residuals add over the whole map."""
    ucfg, bcfg, up, bp = _jax_params()
    blob_in, unet_in, ctx = _inputs(h=8, w=8, batch=1)
    want = _run_jax(ucfg, bcfg, up, bp, blob_in, unet_in, ctx)
    got = _run_torch(from_jax(up, device="cpu"), from_jax(bp, device="cpu"),
                     blob_in, unet_in, ctx)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(),
                               rtol=0)


def test_residual_count_and_zero_taps():
    ucfg, bcfg = tflag.tiny_configs()
    up = tunet.init_unet(ucfg, key=1, device="cpu")
    bp = tblob.init_blobnet(bcfg, key=2, device="cpu")  # zero taps
    blob_in, unet_in, ctx = (torch.from_numpy(a) for a in _inputs())
    d, m, u = tblob.blobnet_apply(bp, bcfg, blob_in, T)
    assert (len(d), 1, len(u)) == tblob.num_residuals(bcfg)
    d, m, u = ([_crop_bcast(r, 2, torch) for r in d],
               _crop_bcast(m, 2, torch), [_crop_bcast(r, 2, torch) for r in u])
    plain = tunet.unet_apply(up, ucfg, unet_in, T, ctx)
    injected = tunet.unet_apply(up, ucfg, unet_in, T, ctx, d, m, u)
    assert torch.equal(plain, injected)  # zero taps inject exact zeros
    with pytest.raises(IndexError):
        tunet.unet_apply(up, ucfg, unet_in, T, ctx, d[:-1], m, u)
    with pytest.raises(ValueError):
        tunet.unet_apply(up, ucfg, unet_in, T, ctx, d + d[:1], m, u)
