"""The single edit's samplers and arguments, the port against the JAX
pipeline on the trained 128^2 toy checkpoint (fp32 on the CPU, the move
edit of ``test_torch_pipeline``, 6 steps, the same explicit latents):
DDIM (eta 0 and 0.5), DPM-Solver++ (Karras, heun, SDE Karras), UniPC on
custom timesteps, ``output_type="latent"``, the step callback, and the
refusals. Images to the bar of ``test_torch_pipeline`` (<= 1 uint8 level at
>= 99.9 % of pixels, <= 2 everywhere); latents within 1e-3.

The stochastic samplers draw their variance noise differently (JAX: a
PRNG key folded with the step; the port: a CPU ``torch.Generator``), so
here the port's ``_variance_noise`` is replaced by JAX's draws for the
same seed, ``normal(fold_in(fold_in(PRNGKey(seed), 0x5de), i))``; nothing
in the JAX package changes. The encoder cache, guidance-interval CFG, the
conditioning-latent memo and float images are in
``test_torch_pipeline_options``."""

import jax
import numpy as np
import pytest
import torch

from blobctrl_tpu.train import toy as jtoy
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


def jax_variance_noise(seed):
    """The JAX package's per-step variance noise for ``seed``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5de)

    def draw(i, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, i), tuple(shape), np.float32)))
    return draw


CASES = {
    "ddim": dict(scheduler="ddim"),
    "ddim_eta0.5": dict(scheduler="ddim", eta=0.5),
    "dpm_sde_karras": dict(scheduler="dpm_sde_karras"),
    "dpm_karras": dict(scheduler="dpm_karras"),
    "dpm_heun": dict(scheduler="dpm_heun"),
    "unipc_timesteps": dict(scheduler="unipc",
                            timesteps=[999, 749, 499, 333, 166, 21]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sampler_edit_matches_jax(pipes, edit, name, monkeypatch):
    jpipe, tpipe = pipes
    kw = dict(edit, **CASES[name])
    want = jpipe(**kw).images
    calls = []
    draw = jax_variance_noise(kw["seed"])

    def noise(i, shape):
        calls.append(i)
        return draw(i, shape)
    monkeypatch.setattr(tpipe, "_variance_noise", noise)
    got = tpipe(**kw).images
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    _assert_u8_close(got, want, name)
    stochastic = kw.get("eta", 0) > 0 or "sde" in kw["scheduler"]
    assert calls == (list(range(len(kw.get("timesteps") or range(6))))
                     if stochastic else [])


@pytest.fixture(scope="module")
def latent_callback_runs(pipes, edit):
    """One run on each side with output_type="latent" and a callback every
    2nd step (and the last) that records (i, t, latents) and returns an
    update, which both sides ignore with a warning."""
    jpipe, tpipe = pipes
    kw = dict(edit, scheduler="dpm_karras", output_type="latent",
              callback_interval=2)
    out = {}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        seen = []

        def cb(p, i, t, tensors):
            assert p is pipe
            seen.append((i, t, np.array(tensors["latents"])))
            return {"latents": tensors["latents"] * 0}
        with pytest.warns(UserWarning, match="ignored|IGNORED"):
            res = pipe(**kw, callback_on_step_end=cb)
        out[name] = (res.images, seen)
    return out


def test_latent_output_matches_jax(latent_callback_runs):
    want, _ = latent_callback_runs["jax"]
    got, _ = latent_callback_runs["port"]
    assert got.shape == want.shape == (1, SIZE // 8, SIZE // 8, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_step_callback_matches_jax(latent_callback_runs):
    _, want = latent_callback_runs["jax"]
    _, got = latent_callback_runs["port"]
    assert [(i, t) for i, t, _ in got] == [(i, t) for i, t, _ in want]
    assert [i for i, _, _ in got] == [0, 2, 4, 5]
    for (_, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    # the returned update was ignored: the last callback saw the output
    np.testing.assert_array_equal(got[-1][2],
                                  latent_callback_runs["port"][0])


REFUSALS = {
    "ip_adapter_image": (dict(ip_adapter_image=np.zeros((8, 8, 3),
                                                        np.uint8)),
                         NotImplementedError),
    "ip_adapter_image_embeds": (dict(ip_adapter_image_embeds=np.zeros(
        (1, 4), np.float32)), NotImplementedError),
    "return_sample": (dict(return_sample=True), NotImplementedError),
    "cross_attention_kwargs": (dict(cross_attention_kwargs={"scale": 1.0,
                                                            "foo": 2}),
                               NotImplementedError),
    "lora_scale_without_adapter": (dict(cross_attention_kwargs={
        "scale": 0.5}), ValueError),
    "cache_with_cfg_interval": (dict(encoder_cache_interval=3,
                                     cfg_guidance_end=0.6), ValueError),
    "callback_interval": (dict(callback_interval=0), ValueError),
    "callback_tensor_inputs": (dict(
        callback_on_step_end_tensor_inputs=("latents", "image_embeds")),
        ValueError),
    "scheduler": (dict(scheduler="dpm_sd"), ValueError),
    "timesteps": (dict(timesteps=[10, 500]), ValueError),
    "karras_timesteps": (dict(scheduler="dpm_karras",
                              timesteps=[900, 500, 10]), ValueError),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(pipes, edit, name):
    """What the JAX package refuses, the port refuses with the same
    exception type (and, for its own messages, the same message)."""
    jpipe, tpipe = pipes
    extra, exc = REFUSALS[name]
    kw = dict(edit, num_inference_steps=2, **extra)
    with pytest.raises(exc) as want:
        jpipe(**kw)
    with pytest.raises(exc) as got:
        tpipe(**kw)
    if name in ("scheduler", "cache_with_cfg_interval", "callback_interval"):
        assert str(got.value) == str(want.value)
