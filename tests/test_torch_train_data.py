"""The port's training data against the JAX package's on the CPU, fp32:
``build_example`` (with and without a white-out ellipse) and
``BlobDataLoader`` on a tiny pipeline whose weights are carried across
with ``from_jax``. Host arrays (scores, text) within 1e-6, encoder
outputs within 1e-4 of max |JAX| (the fg image is mostly the white
canvas, and the VAE's GroupNorm over a near-constant map amplifies the
two packages' rounding: 3.5e-5 measured), the batch order equal, the
zero-batch error."""

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.apps import flagship as jflag
from blobctrl_tpu.models import blobnet as jblob
from blobctrl_tpu.models import dinov2 as jdino
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.pipeline import BlobNetPipeline as JaxPipeline
from blobctrl_tpu.train import data as jdata
from blobctrl_torch.blob import viz as tviz
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.pipeline import BlobNetPipeline
from blobctrl_torch.train import data as tdata

torch.set_num_threads(2)
SIZE = 64


@pytest.fixture(scope="module")
def pipes():
    key = jax.random.PRNGKey(0)
    ucfg, bcfg = jflag.tiny_configs(dino_c=16, ctx=16)
    vcfg = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16),
                          layers_per_block=1, norm_num_groups=4)
    dcfg = jdino.DINOv2Config(hidden_size=16, num_layers=1, num_heads=2,
                              intermediate_size=32, patch_size=14,
                              image_size=28)
    trees = {"unet": junet.init_unet(key, ucfg),
             "blobnet": jblob.init_blobnet(key, bcfg),
             "vae": jvae.init_vae(jax.random.PRNGKey(1), vcfg),
             "dino": jdino.init(jax.random.PRNGKey(2), dcfg)}
    jpipe = JaxPipeline(unet_cfg=ucfg, unet_params=trees["unet"],
                        blobnet_cfg=bcfg, blobnet_params=trees["blobnet"],
                        vae_cfg=vcfg, vae_params=trees["vae"], dino_cfg=dcfg,
                        dino_params=trees["dino"], dino_image_size=28)
    t = {k: from_jax(v, "cpu") for k, v in trees.items()}
    tpipe = BlobNetPipeline(unet_cfg=ucfg, unet_params=t["unet"],
                            blobnet_cfg=bcfg, blobnet_params=t["blobnet"],
                            vae_cfg=vcfg, vae_params=t["vae"], dino_cfg=dcfg,
                            dino_params=t["dino"], dino_image_size=28,
                            device="cpu")
    return jpipe, tpipe


def _data(n=5):
    rng = np.random.RandomState(0)
    images, masks, pes = [], [], []
    for i in range(n):
        images.append(rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8))
        masks.append(tviz.ellipse_mask(((30.0 + i, 31.0 - i),
                                        (18.0 + 2 * i, 26.0), 15.0 * i),
                                       SIZE, SIZE))
        pes.append(rng.randn(7, 16).astype(np.float32))
    return images, masks, pes


def _assert_example_close(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        if k in ("fg_score", "bg_score", "text_embeds"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("whiteout", [None, ((14.0, 50.0), (12.0, 9.0),
                                             30.0)])
def test_build_example_matches_jax(pipes, whiteout):
    jpipe, tpipe = pipes
    images, masks, pes = _data(1)
    want = jdata.build_example(jpipe, images[0], masks[0], pes[0], SIZE,
                               whiteout_ellipse=whiteout)
    got = tdata.build_example(tpipe, images[0], masks[0], pes[0], SIZE,
                              whiteout_ellipse=whiteout)
    _assert_example_close(got, want)
    assert got["x0_latents"].shape == (8, 8, 4)
    assert got["fg_feats"].shape == (8, 8, 16)
    assert np.abs(got["fg_feats"]).max() > 0


def test_loader_matches_jax_batch_order(pipes):
    jpipe, tpipe = pipes
    images, masks, pes = _data(5)
    jl = jdata.BlobDataLoader(jpipe, images, masks, pes, batch_size=2,
                              size=SIZE, seed=3)
    tl = tdata.BlobDataLoader(tpipe, images, masks, pes, batch_size=2,
                              size=SIZE, seed=3)
    for epoch in range(2):  # each epoch its own permutation
        want, got = list(jl), list(tl)
        assert len(got) == len(want) == 2  # the odd example dropped
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["text_embeds"], w["text_embeds"])
            _assert_example_close(g, w)
    with pytest.raises(ValueError, match="zero batches"):
        tdata.BlobDataLoader(tpipe, images[:1], masks[:1], pes[:1],
                             batch_size=2, size=SIZE)
