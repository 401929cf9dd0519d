"""``BlobNetPipeline.edit_batch``, the port against the JAX package's and
against its own solo ``__call__``, fp32 on the CPU at size 64 on the tiny
nets of ``test_torch_session`` (tiny CLIP text and DINOv2, BlobNet's taps
nonzero, string prompts and object images): three requests with distinct
seeds, ellipses and images, under UniPC and DPM-Solver++ 2M SDE.

Each package draws every request's noise from its seed by its own code:
the port's ``_seed_noise`` gives JAX's draws (``normal(PRNGKey(seed))``
for the latents, ``normal(fold_in(fold_in(PRNGKey(seed), 0x5de), i))``
for step i's variance noise, ``utils.threefry``), and nothing of JAX's is
put into the port. Bar: <= 1 uint8 level at >= 99.9 % of pixels, <= 2
everywhere (PERF.md §2), not bit-equality: a batched op may sum in
another order."""

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.blob import math as jmath
from blobctrl_torch.pipeline import blobnet_pipeline as tbp
from tests.test_torch_session import _assert_u8_close, pipelines  # noqa: F401

torch.set_num_threads(2)

SIZE = 64
STEPS = 3
SHARED = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
              guidance_scale=7.5, blobnet_conditioning_scale=1.2,
              blobnet_control_guidance_end=0.9)


def requests(n=3):
    rng = np.random.RandomState(5)
    out = []
    for b in range(n):
        e = ((24.0 + 6 * b, 30.0 - 3 * b), (18.0 + 2 * b, 26.0), 15.0 * b)
        out.append(dict(
            prompt=["a red ball", "a blue cup on a desk", "green"][b % 3],
            fg_image=rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8),
            bg_image=rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8),
            gs_score=np.asarray(jmath.blob_score_from_ellipse(
                e, SIZE, SIZE, (SIZE // 8, SIZE // 8))),
            seed=100 + 7 * b))
    return out


@pytest.fixture(scope="module")
def runs(pipelines):  # noqa: F811
    """{scheduler: (JAX batch, port batch, [port solo])}."""
    jpipe, tpipe = pipelines
    out = {}
    for sched in ("unipc", "dpm_sde"):
        kw = dict(SHARED, scheduler=sched)
        want = jpipe.edit_batch(requests(), **kw).images
        got = tpipe.edit_batch(requests(), **kw)
        solo = [tpipe(**r, **kw).images for r in requests()]
        out[sched] = (want, got, solo)
    return out


@pytest.mark.parametrize("sched", ["unipc", "dpm_sde"])
def test_edit_batch_matches_jax(runs, sched):
    want, got, _ = runs[sched]
    assert got.images.shape == want.shape == (3, SIZE, SIZE, 3)
    assert got.nsfw_content_detected is None
    _assert_u8_close(got.images, want, f"edit_batch {sched}")


@pytest.mark.parametrize("sched", ["unipc", "dpm_sde"])
def test_each_batched_row_is_its_solo_edit(runs, sched):
    _, got, solo = runs[sched]
    got = got.images
    for b, one in enumerate(solo):
        assert one.shape == (1, SIZE, SIZE, 3)
        _assert_u8_close(got[b:b + 1], one, f"{sched} row {b}")
    # distinct requests, distinct images
    assert not np.array_equal(got[0], got[1])


def test_dino_misses_share_one_encode(pipelines, monkeypatch):  # noqa: F811
    _, tpipe = pipelines
    tpipe._dino_cache.clear()
    calls = []
    real = tpipe._encode_dino

    def spy(px):
        calls.append(px.shape[0])
        return real(px)
    monkeypatch.setattr(tpipe, "_encode_dino", spy)
    reqs = requests()
    tpipe.edit_batch(reqs, **dict(SHARED, num_inference_steps=1))
    assert calls == [3]      # the three misses in one encode
    tpipe.edit_batch(reqs[:2], **dict(SHARED, num_inference_steps=1))
    assert calls == [3]      # hits: no encode


def _bad(kind):
    reqs = requests(2)
    if kind == "empty":
        return [], "at least one request"
    if kind == "mixed embeds":
        reqs[0]["prompt_embeds"] = np.zeros((1, 7, 16), np.float32)
        reqs[0]["negative_prompt_embeds"] = reqs[0]["prompt_embeds"]
        return reqs, "all requests must carry prompt_embeds"
    if kind == "blob count":
        reqs[1]["gs_score"] = np.concatenate(
            [reqs[1]["gs_score"], reqs[1]["gs_score"][..., 1:]], -1)
        return reqs, "same blob count"
    reqs[0]["fg_dino_feats"] = np.zeros((3, 16), np.float32)
    return reqs, "appearance embeddings"


@pytest.mark.parametrize("kind", ["empty", "mixed embeds", "blob count",
                                  "appearance rows"])
def test_edit_batch_refuses_what_the_jax_package_refuses(pipelines, kind):  # noqa: F811,E501
    jpipe, tpipe = pipelines
    reqs, match = _bad(kind)
    with pytest.raises(ValueError, match=match):
        tpipe.edit_batch(reqs, **dict(SHARED, num_inference_steps=1))
    with pytest.raises((ValueError, AssertionError)):
        jpipe.edit_batch(_bad(kind)[0], **dict(SHARED,
                                               num_inference_steps=1))


def test_seed_noise_is_the_single_edits_draw():
    """``_seed_noise``: the JAX pipeline's draws for the seed, the latents
    from ``PRNGKey(seed)`` and step i's variance noise from
    ``fold_in(fold_in(PRNGKey(seed), 0x5de), i)``, bit-equal; a solo
    shape's row is the first row of a draw for n images; a list of seeds
    draws each row as its seed's solo draw."""
    key = jax.random.PRNGKey(11)
    vkey = jax.random.fold_in(key, 0x5de)
    lat, draw = tbp.BlobNetPipeline._seed_noise(11, (1, 8, 8, 4))
    np.testing.assert_array_equal(lat.numpy(), np.asarray(
        jax.random.normal(key, (1, 8, 8, 4))))
    for i in (0, 3):
        np.testing.assert_array_equal(draw(i, (1, 8, 8, 4)).numpy(),
                                      np.asarray(jax.random.normal(
                                          jax.random.fold_in(vkey, i),
                                          (1, 8, 8, 4))))
    a = draw(0, (1, 8, 8, 4))
    _, draw2 = tbp.BlobNetPipeline._seed_noise(11, (1, 8, 8, 4))
    assert torch.equal(draw2(0, (1, 8, 8, 4)), a)
    assert not torch.equal(a, lat)
    lat2, _ = tbp.BlobNetPipeline._seed_noise(11, (2, 8, 8, 4))
    assert torch.equal(lat2[:1], lat)
    # edit_batch's rows: each request's draws at the solo shape, all rows
    # in one draw
    lats, draws = tbp.BlobNetPipeline._seed_noise([5, 11], (1, 8, 8, 4))
    assert tuple(lats.shape) == (2, 8, 8, 4)
    assert torch.equal(lats[1:], lat)
    assert torch.equal(draws(3, (2, 8, 8, 4))[1:], draw(3, (1, 8, 8, 4)))
    lat5, draw5 = tbp.BlobNetPipeline._seed_noise(5, (1, 8, 8, 4))
    assert torch.equal(lats[:1], lat5)
    assert torch.equal(draws(3, (2, 8, 8, 4))[:1], draw5(3, (1, 8, 8, 4)))
