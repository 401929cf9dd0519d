"""The safety checker on the pipeline's path: the port's ``BlobNetPipeline``
against the JAX package's, fp32 on the CPU, on the trained 256^2 toy
checkpoint (``tests/test_torch_pipeline``'s move edit, 4 UniPC steps).

Both pipelines get the same callable, which records the images it is
handed and flags a fixed pattern, so the flags are equal by construction
and what is compared is where and on what the checker runs: after the
decode, on every image of ``__call__`` and every row of ``edit_batch``
(one flag each), never for ``output_type="latent"``; the flagged rows are
zero under ``blackout_nsfw``; the rest, and the images the checker saw,
meet the uint8 bar (<= 1 level at >= 99.9 % of pixels, <= 2 everywhere).
Both sides draw ``edit_batch``'s noise from each request's seed by their
own code."""

import numpy as np
import pytest
import torch

from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.train import toy as ttoy
from tests.test_torch_pipeline import _assert_u8_close, _edits

torch.set_num_threads(2)

STEPS = 4
CKPT = "assets/toy_ckpt_256"


class Recorder:
    """A checker: records the images, flags ``pattern``'s first rows."""

    def __init__(self, pattern):
        self.pattern = list(pattern)
        self.seen = []

    def __call__(self, images):
        self.seen.append(np.array(images))
        return np.array(self.pattern[:len(images)])


@pytest.fixture(scope="module")
def pipes():
    jpipe, _ = jtoy.load_toy(CKPT)
    tpipe, _ = ttoy.load_toy(CKPT, device="cpu")
    return jpipe, tpipe


def edit():
    return dict(_edits(256)["move"], num_inference_steps=STEPS)


def run(pipe, pattern, blackout, fn):
    pipe.safety_checker = rec = Recorder(pattern)
    pipe.blackout_nsfw = blackout
    try:
        return fn(pipe), rec
    finally:
        pipe.safety_checker, pipe.blackout_nsfw = None, False


@pytest.mark.parametrize("flag", [False, True], ids=["clean", "flagged"])
def test_call_screens_the_decoded_image(pipes, flag):
    outs = [run(p, [flag], True, lambda p: p(**edit())) for p in pipes]
    (jout, jrec), (tout, trec) = outs
    for out, rec in outs:
        assert out.nsfw_content_detected.tolist() == [flag]
        assert len(rec.seen) == 1 and rec.seen[0].shape == (1, 256, 256, 3)
    _assert_u8_close(trec.seen[0], jrec.seen[0], "checked image")
    if flag:
        assert not tout.images.any() and not jout.images.any()
    else:
        _assert_u8_close(tout.images, jout.images, "clean image")
        assert np.array_equal(tout.images, trec.seen[0])


def test_flag_without_blackout_keeps_the_image(pipes):
    _, tpipe = pipes
    out, rec = run(tpipe, [True], False, lambda p: p(**edit()))
    assert out.nsfw_content_detected.tolist() == [True]
    assert out.images.any() and np.array_equal(out.images, rec.seen[0])


def batch_requests():
    per = {k: v for k, v in edit().items()
           if k in ("fg_image", "bg_image", "gs_score", "prompt_embeds",
                    "negative_prompt_embeds", "fg_dino_feats")}
    return [dict(per, seed=s) for s in (3, 4, 5)]


def test_edit_batch_flags_each_row(pipes):
    """Three rows, the middle one flagged: its own flag, zeroed; the
    others as JAX's."""
    jpipe, tpipe = pipes
    kw = dict(height=256, width=256, num_inference_steps=STEPS,
              guidance_scale=4.0)
    pattern = [False, True, False]
    jout, jrec = run(jpipe, pattern, True,
                     lambda p: p.edit_batch(batch_requests(), **kw))
    tout, trec = run(tpipe, pattern, True,
                     lambda p: p.edit_batch(batch_requests(), **kw))
    assert tout.nsfw_content_detected.tolist() == pattern
    assert jout.nsfw_content_detected.tolist() == pattern
    assert trec.seen[0].shape == (3, 256, 256, 3) and len(trec.seen) == 1
    _assert_u8_close(trec.seen[0], jrec.seen[0], "checked rows")
    assert not tout.images[1].any() and not jout.images[1].any()
    _assert_u8_close(tout.images[[0, 2]], jout.images[[0, 2]], "clean rows")
    assert np.array_equal(tout.images[[0, 2]], trec.seen[0][[0, 2]])


def test_latent_output_is_not_screened(pipes):
    _, tpipe = pipes
    kw = dict(edit(), num_inference_steps=1, output_type="latent")
    out, rec = run(tpipe, [True], True, lambda p: p(**kw))
    assert out.nsfw_content_detected is None and rec.seen == []
    assert out.images.shape == (1, 32, 32, 4) and out.images.any()
    out, rec = run(tpipe, [True] * 3, True, lambda p: p.edit_batch(
        batch_requests(), height=256, width=256, num_inference_steps=1,
        output_type="latent"))
    assert out.nsfw_content_detected is None and rec.seen == []
