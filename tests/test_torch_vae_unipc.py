"""The port's toy VAE, UniPC tables and UniPC trajectory against the JAX
package, and its numpy-only safetensors reader against ``safetensors``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.schedulers import unipc as junipc
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.models import vae as tvae
from blobctrl_torch.params import from_jax as fj
from blobctrl_torch.schedulers import unipc as tunipc

torch.set_num_threads(2)

CKPT = "assets/toy_ckpt/toy.safetensors"


def test_safetensors_reader_matches_library():
    from safetensors.numpy import load_file
    want = load_file(CKPT)
    got = fj.load_safetensors(CKPT)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_toy_vae_encode_decode_match_jax():
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt")
    cfg_j = jpipe.vae_cfg
    tp = fj.from_jax(jpipe.vae_params, device="cpu")
    cfg_t = tvae.VAEConfig(**{f: getattr(cfg_j, f) for f in (
        "in_channels", "out_channels", "latent_channels",
        "block_out_channels", "layers_per_block", "norm_num_groups",
        "scaling_factor")})
    img = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jvae.encode_to_scaled_latents(jpipe.vae_params, cfg_j,
                                                    jnp.asarray(img)))
    got = tvae.encode_to_scaled_latents(tp, cfg_t, torch.from_numpy(img))
    # fp32 through the encoder, sums in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    lat = np.random.RandomState(1).randn(2, 8, 8, 4).astype(np.float32)
    want = np.asarray(jvae.decode_from_scaled_latents(
        jpipe.vae_params, cfg_j, jnp.asarray(lat)))
    got = tvae.decode_from_scaled_latents(tp, cfg_t, torch.from_numpy(lat))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("steps", [1, 6, 20, 50])
def test_unipc_tables_match_jax(steps):
    """The float64 host tables, rounded to fp32 as the step reads them, are
    bit-equal to the JAX package's fp32 tables."""
    j, t = junipc.make(steps), tunipc.make(steps)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    for name in ("conv_a", "conv_s", "cc_x", "cc_m0", "cc_B", "cc_mt",
                 "cc_hist", "cp_x", "cp_m0", "cp_B", "cp_hist"):
        tab = getattr(t, name)
        assert tab.dtype == np.float64, name
        np.testing.assert_array_equal(tab.astype(np.float32),
                                      np.asarray(getattr(j, name)), name)


def test_unipc_trajectory_matches_jax():
    steps = 10
    rng = np.random.RandomState(2)
    x0 = rng.randn(2, 4, 6, 4).astype(np.float32)
    outs = rng.randn(steps, 2, 4, 6, 4).astype(np.float32)
    js, ts = junipc.make(steps), tunipc.make(steps)
    jstate = junipc.init_state(js, jnp.asarray(x0))
    tstate = tunipc.init_state(ts, torch.from_numpy(x0))
    for i in range(steps):
        jstate = junipc.step(js, i, jnp.asarray(outs[i]), jstate)
        tstate = tunipc.step(ts, i, torch.from_numpy(outs[i]), tstate)
        # fp32 multiply-adds in the same order; 1 ulp of slack per step
        np.testing.assert_allclose(tstate[0].numpy(), np.asarray(jstate[0]),
                                   atol=1e-5, rtol=1e-5, err_msg=f"step {i}")
