"""The toy's training half in the port against the JAX package's, on the
CPU: ``build_dataset`` (n = 8 at 128^2, one- and two-object scenes) with
its images and text bit-equal and its splatted scores and appearance
within 1e-6 (the two packages' exponentials differ in the last bit),
``encode_dataset`` through a carried-across toy VAE within 1e-4 of max
|JAX| (fp32 through a 4-level encoder, sums in another order, as
``test_torch_vae_unipc.py`` holds the encoder), ``train_toy_vae`` and
``train_toy_diffusion`` for a few steps at tiny sizes with a finite,
falling loss, and ``save_toy``'s file read by the JAX package's
``load_toy`` bit-equal to the fp16-rounded trees."""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.apps import flagship as tflag
from blobctrl_torch.models import blobnet as tblob
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.models import vae as tvae
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.train import toy as ttoy

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [{}, {"p_two_objects": 0.5, "seed": 4}])
def test_build_dataset_matches_jax(kw):
    want = jtoy.build_dataset(8, size=128, **kw)
    got = ttoy.build_dataset(8, size=128, **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k in ("fg_score", "bg_score", "appearance"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["appearance"].reshape(8, -1).any(1)).sum() >= 5


def test_encode_dataset_matches_jax():
    data = jtoy.build_dataset(6, size=64, seed=2)
    _, _, vcfg = jtoy.toy_configs(size=128)
    vcfg = dataclasses.replace(vcfg, scaling_factor=0.7)
    params = jvae.init_vae(jax.random.PRNGKey(5), vcfg)
    want = jtoy.encode_dataset(params, vcfg, data, batch=4)
    got = ttoy.encode_dataset(from_jax(params, "cpu"),
                              tvae.VAEConfig(**dataclasses.asdict(vcfg)),
                              data, batch=4)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def _logged(text, name):
    return [float(x) for x in re.findall(rf"{name} step \d+/\d+ \w+ "
                                         r"([-0-9.e]+)", text)]


def test_train_toy_vae_loss_falls(capsys):
    images = ttoy.build_dataset(8, size=32, seed=1)["image"]
    vcfg = tvae.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                          norm_num_groups=4)
    params, cfg, mse = ttoy.train_toy_vae(images, vcfg, steps=24, batch=4,
                                          lr=3e-3, log_every=1,
                                          device="cpu")
    mses = _logged(capsys.readouterr().out, "vae")
    assert len(mses) == 24 and np.isfinite(mses).all()
    assert np.mean(mses[-4:]) < 0.7 * np.mean(mses[:4]), mses
    assert abs(mse - mses[-1]) <= 5e-6  # the log prints 5 decimals
    assert np.isfinite(cfg.scaling_factor) and cfg.scaling_factor > 0
    assert all(not p.requires_grad for p in jax.tree_util.tree_leaves(
        params, is_leaf=torch.is_tensor))


def test_train_toy_diffusion_loss_falls(capsys):
    ucfg, bcfg = tflag.tiny_configs()
    rng = np.random.RandomState(2)
    n = 8
    data = {"x0_latents": rng.randn(n, 8, 8, 4).astype(np.float32) * 0.5,
            "fg_latents": rng.randn(n, 8, 8, 4).astype(np.float32),
            "bg_latents": rng.randn(n, 8, 8, 4).astype(np.float32),
            "fg_score": rng.rand(n, 8, 8, 1).astype(np.float32),
            "bg_score": rng.rand(n, 8, 8, 1).astype(np.float32),
            "fg_feats": rng.randn(n, 8, 8, 16).astype(np.float32),
            "text_embeds": rng.randn(n, 7, 16).astype(np.float32)}
    unet, blobnet, loss = ttoy.train_toy_diffusion(
        data, ucfg, bcfg, steps=40, batch=4, lr=3e-3, log_every=1,
        device="cpu")
    losses = _logged(capsys.readouterr().out, "diff")
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < 0.8 * np.mean(losses[:8]), losses
    assert loss == pytest.approx(losses[-1], rel=1e-4)
    assert set(unet) == set(tunet.init_unet(ucfg, device="cpu"))
    assert set(blobnet) == set(tblob.init_blobnet(bcfg, device="cpu"))


def test_save_toy_read_by_jax_load_toy(tmp_path):
    ucfg, bcfg, vcfg = ttoy.toy_configs(size=128)
    trees = {"unet": tunet.init_unet(ucfg, 1, "cpu"),
             "blobnet": tblob.init_blobnet(bcfg, 2, "cpu", zero_taps=False),
             "vae": tvae.init_vae(vcfg, 3, "cpu")}
    meta = {"ctx": 16, "dino_c": 16, "size": 128,
            "vae_scaling_factor": 0.913, "steps": 3}
    ttoy.save_toy(str(tmp_path), trees["unet"], trees["blobnet"],
                  trees["vae"], meta)
    with open(tmp_path / "toy.json") as f:
        assert json.load(f) == meta
    pipe, back_meta = jtoy.load_toy(str(tmp_path))
    assert back_meta == meta
    for name, loaded in (("unet", pipe.unet_params),
                         ("blobnet", pipe.blobnet_params),
                         ("vae", pipe.vae_params)):
        flat_t, flat_j = dict(_flat(trees[name])), dict(_flat(loaded))
        assert set(flat_t) == set(flat_j), name
        for k, v in flat_t.items():
            np.testing.assert_array_equal(
                np.asarray(flat_j[k]),
                v.numpy().astype(np.float16).astype(np.float32), err_msg=k)
    # and the port's own loader reads it back the same
    tpipe, _ = ttoy.load_toy(str(tmp_path), device="cpu")
    back = dict(_flat(tpipe.unet_params))
    for k, v in _flat(trees["unet"]):
        np.testing.assert_array_equal(
            back[k].numpy(), v.numpy().astype(np.float16).astype(np.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree
