"""The port's training data against the JAX package's on the CPU, fp32:
``build_example`` (with and without a white-out ellipse, and on a
non-elliptic mask) and
``BlobDataLoader`` on a tiny pipeline whose weights are carried across
with ``from_jax``. Host arrays (scores, text) within 1e-6, encoder
outputs within 1e-4 of max |JAX| (the fg image is mostly the white
canvas, and the VAE's GroupNorm over a near-constant map amplifies the
two packages' rounding: 3.5e-5 measured), the batch order equal, the
zero-batch error; the loader's compact examples and its batches,
bit-equal to the stacked examples."""

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


def test_build_example_matches_jax_on_a_non_elliptic_mask(pipes):
    """A polygon plus one full-width row: a 5-point hull, which cv2 fits
    with its direct fit (an ellipse over the canvas, 64 px long)."""
    cv2 = pytest.importorskip("cv2")
    jpipe, tpipe = pipes
    images, _, pes = _data(1)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    cv2.fillPoly(mask, [np.array([[9, 16], [21, 24], [31, 23], [27, 24]],
                                 np.int32)], 255)
    mask[13] = 255
    want = jdata.build_example(jpipe, images[0], mask, pes[0], SIZE)
    got = tdata.build_example(tpipe, images[0], mask, pes[0], SIZE)
    _assert_example_close(got, want)


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


def test_loader_holds_compact_examples_and_batches_bit_equal(pipes):
    """The loader keeps the pooled DINOv2 vector and forms each batch's
    fg_feats when it collates: its batches bit-equal to the stacked
    ``build_example`` outputs of the same indices; with ``rows`` it yields
    those rows of the same batches."""
    _, tpipe = pipes
    images, masks, pes = _data(5)
    full = [tdata.build_example(tpipe, im, mk, pe, SIZE)
            for im, mk, pe in zip(images, masks, pes)]
    loader = tdata.BlobDataLoader(tpipe, images, masks, pes, batch_size=2,
                                  size=SIZE, seed=3)
    part = tdata.BlobDataLoader(tpipe, images, masks, pes, batch_size=2,
                                size=SIZE, seed=3, rows=range(1, 2))
    assert all("fg_feats" not in e and e["dino_pooled"].shape == (16,)
               for e in loader.examples)
    order = np.random.RandomState(3)
    for _ in range(2):
        perm = order.permutation(5)
        got, rows = list(loader), list(part)
        for i, (g, r) in enumerate(zip(got, rows)):
            idx = perm[2 * i:2 * i + 2]
            assert list(g) == list(full[0])   # the keys in their order
            for k, v in g.items():
                want = np.stack([full[j][k] for j in idx])
                assert v.dtype == want.dtype
                np.testing.assert_array_equal(v, want, err_msg=k)
                np.testing.assert_array_equal(r[k], want[1:], err_msg=k)
