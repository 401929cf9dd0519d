"""The single edit's opt-in paths and input forms, the port against the JAX
pipeline on the trained 128^2 toy checkpoint (fp32 on the CPU, the move
edit of ``test_torch_pipeline``, 6 UniPC steps, the same explicit latents),
to the bar of ``test_torch_pipeline``: the encoder cache (interval 3,
warm-up 2), guidance-interval CFG (0.0, 0.6), float and mixed uint8 /
float images; and the conditioning-latent memo (the port's own
behaviour: a repeat uploads and encodes nothing, an 8-entry FIFO, keys
that see the numeric switches)."""

import numpy as np
import pytest
import torch
from PIL import Image

from blobctrl_tpu.pipeline import blobnet_pipeline as jpipe_mod
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.models import blobnet as tblobnet
from blobctrl_torch.models import unet as tunet
from blobctrl_torch.models import vae as tvae
from blobctrl_torch.ops import conv3x3
from blobctrl_torch.pipeline import blobnet_pipeline as tpipe_mod
from blobctrl_torch.train import toy as ttoy
from tests.test_torch_pipeline import _assert_u8_close, _edits

torch.set_num_threads(2)

SIZE = 128
CKPT = "assets/toy_ckpt"


@pytest.fixture(scope="module")
def pipes():
    jpipe, _ = jtoy.load_toy(CKPT)
    tpipe, _ = ttoy.load_toy(CKPT, device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def edit():
    return _edits(SIZE)["move"]


def _counter(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_encoder_cache_matches_jax(pipes, edit, monkeypatch):
    """Key steps 0, 1 (warm-up), 3 (interval) and 5 (the last) run BlobNet
    and the UNet encoder; steps 2 and 4 only the decoder."""
    jpipe, tpipe = pipes
    kw = dict(edit, encoder_cache_interval=3, encoder_cache_warmup=2)
    want = jpipe(**kw).images
    blob = _counter(monkeypatch, tblobnet, "blobnet_apply")
    enc = _counter(monkeypatch, tunet, "unet_encode")
    dec = _counter(monkeypatch, tunet, "unet_decode")
    got = tpipe(**kw).images
    assert (len(blob), len(enc), len(dec)) == (4, 4, 6)
    _assert_u8_close(got, want, "encoder cache")


def test_guidance_interval_cfg_matches_jax(pipes, edit, monkeypatch):
    """CFG on steps 0-2 (UNet at batch 2), the conditional rows alone on
    steps 3-5 (batch 1)."""
    jpipe, tpipe = pipes
    kw = dict(edit, cfg_guidance_start=0.0, cfg_guidance_end=0.6)
    want = jpipe(**kw).images
    enc = _counter(monkeypatch, tunet, "unet_encode")
    got = tpipe(**kw).images
    assert [a[2].shape[0] for a in enc] == [2, 2, 2, 1, 1, 1]
    _assert_u8_close(got, want, "guidance interval")


def _float_images(edit):
    rng = np.random.RandomState(8)
    fg = edit["fg_image"].astype(np.float32) / 255.0
    fg96 = np.asarray(Image.fromarray(edit["fg_image"]).resize(
        (96, 96), Image.BILINEAR), np.float32) / 255.0
    bg = edit["bg_image"].astype(np.float64)  # 0..255 floats: / 255
    return {"fg_float_resized": fg96, "fg_float": fg,
            "bg_float_255": bg, "bg_u8": edit["bg_image"],
            "noise_4d_int": rng.randint(0, 256, (1, 80, 112, 3)),
            "noise_f32": rng.rand(1, SIZE, SIZE, 3).astype(np.float32)}


def test_float_transport_matches_jax(edit):
    """Float images resample in float (PIL mode "F", the port's copy);
    integer 4-D arrays take the float path too; a mixed pair goes through
    the common float transport. Within 1e-6 of the JAX package's."""
    ims = _float_images(edit)
    for name, im in ims.items():
        got = tpipe_mod.preprocess_image_transport(im, SIZE, SIZE)
        want = jpipe_mod.preprocess_image_transport(im, SIZE, SIZE)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)
    pair = [tpipe_mod.preprocess_image_transport(ims[n], SIZE, SIZE)
            for n in ("fg_float_resized", "bg_u8")]
    got = tpipe_mod._uniform_transport(pair)
    want = jpipe_mod._uniform_transport(pair)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pair", [("fg_float_resized", "bg_float_255"),
                                  ("fg_float_resized", "bg_u8")])
def test_float_image_edit_matches_jax(pipes, edit, pair):
    jpipe, tpipe = pipes
    ims = _float_images(edit)
    kw = dict(edit, fg_image=ims[pair[0]], bg_image=ims[pair[1]],
              fg_vae_image=ims[pair[0]])
    want = jpipe(**kw).images
    got = tpipe(**kw).images
    _assert_u8_close(got, want, "+".join(pair))


def test_conditioning_latent_memo(edit, monkeypatch):
    """A repeat call encodes nothing and gives the same image; the memo is
    an 8-entry FIFO; a numeric switch (Winograd) is part of the key."""
    pipe, _ = ttoy.load_toy(CKPT, device="cpu")
    kw = dict(edit, num_inference_steps=2)
    encodes = _counter(monkeypatch, tvae, "encode_to_scaled_latents")
    first = pipe(**kw).images
    assert len(encodes) == 1 and len(pipe._cond_lat_cache) == 1
    again = pipe(**kw).images
    assert len(encodes) == 1
    np.testing.assert_array_equal(again, first)
    conv3x3.set_winograd(True)
    try:
        pipe(**kw)
    finally:
        conv3x3.set_winograd(False)
    assert len(encodes) == 2 and len(pipe._cond_lat_cache) == 2
    pipe(**kw)
    assert len(encodes) == 2  # the switch off: the first entry hits again
    keys = []
    rng = np.random.RandomState(1)
    for j in range(9):
        bg = rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
        pair = np.concatenate([
            tpipe_mod.preprocess_image_transport(edit["fg_image"], SIZE,
                                                 SIZE),
            tpipe_mod.preprocess_image_transport(bg, SIZE, SIZE)])
        keys.append(pipe._cond_lat_key(pair, SIZE, SIZE))
        pipe._cond_latents(pair, SIZE, SIZE, pipe.vae_params)
    assert len(pipe._cond_lat_cache) == tpipe_mod.COND_LAT_MEMO == 8
    assert list(pipe._cond_lat_cache) == keys[1:]  # oldest out first
    assert len(encodes) == 11
