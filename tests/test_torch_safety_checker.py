"""The port's CLIP vision tower and safety checker
(``blobctrl_torch.models.clip_vision``, ``models.safety_checker``) against
the JAX package, on the CPU in fp32 at tiny configs.

The weights are a transformers ``CLIPVisionModel`` (width 16, two layers,
patch 14, the config of ``tests/test_safety_checker.py`` but at 224^2, the
size the JAX ``check`` preprocesses to whatever the config says) drawn
from a seed, wrapped into diffusers' StableDiffusionSafetyChecker key
layout (``vision_model.`` + the model's own keys, the projection, 17
concept and 3 special-care embeddings with their thresholds, numpy-seeded).
Both packages' converters must give bit-equal leaves, the JAX tree goes
across with ``from_jax``. Bars: hidden states and the pooled embedding
within 1e-4 of max |JAX|; ``preprocess`` bit-equal; the flags equal on a
suite whose concept scores lie beyond 1e-4 of 0 (asserted)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_tpu.models import clip_vision as jclip
from blobctrl_tpu.models import safety_checker as jsafety
from blobctrl_tpu.nn import layers as jlayers
from blobctrl_torch.models import clip_vision as tclip
from blobctrl_torch.models import safety_checker as tsafety
from blobctrl_torch.params import export
from blobctrl_torch.params.from_jax import from_jax
from tests.test_torch_sam import close, leaves_equal

torch.set_num_threads(2)

PROJ = 8


def checker_state_dict(seed: int = 0):
    from transformers import CLIPVisionConfig, CLIPVisionModel
    torch.manual_seed(seed)
    model = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=16, intermediate_size=32, num_hidden_layers=2,
        num_attention_heads=2, image_size=224, patch_size=14)).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    sd = {"vision_model." + k: (v + 0.05 * torch.randn(v.shape,
                                                        generator=gen))
          if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    rng = np.random.RandomState(seed)
    sd["visual_projection.weight"] = torch.from_numpy(
        rng.randn(PROJ, 16).astype(np.float32) / 4)
    sd["concept_embeds"] = torch.from_numpy(
        rng.randn(17, PROJ).astype(np.float32))
    sd["special_care_embeds"] = torch.from_numpy(
        rng.randn(3, PROJ).astype(np.float32))
    sd["concept_embeds_weights"] = torch.from_numpy(
        rng.uniform(0.0, 0.3, 17).astype(np.float32))
    sd["special_care_embeds_weights"] = torch.from_numpy(
        rng.uniform(0.0, 0.3, 3).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def tiny():
    sd = checker_state_dict()
    jparams = jsafety.convert_safety_checker(sd)
    jcfg = jclip.CLIPVisionConfig(hidden_size=16, intermediate_size=32,
                                  num_layers=2, num_heads=2, image_size=224,
                                  patch_size=14)
    return dict(sd=sd, jparams=jparams, tparams=from_jax(jparams, "cpu"),
                jcfg=jcfg,
                tcfg=tclip.CLIPVisionConfig(**dataclasses.asdict(jcfg)))


def test_converters_give_bit_equal_leaves(tiny):
    sd = tiny["sd"]
    leaves_equal(tsafety.convert_safety_checker(sd), tiny["jparams"])
    vis = {k[len("vision_model."):]: v for k, v in sd.items()
           if k.startswith("vision_model.")}
    leaves_equal(tsafety.convert_clip_vision(vis),
                 jsafety.convert_clip_vision(vis))


def test_state_dict_exporter_round_trips(tiny):
    """``safety_checker_state_dict`` writes diffusers' keys: every key of
    the source but the position_ids buffer, and the JAX converter reads it
    back into the same tree."""
    sd = export.safety_checker_state_dict(tiny["tparams"])
    assert set(sd) == {k for k in tiny["sd"] if "position_ids" not in k}
    leaves_equal(tiny["tparams"], jsafety.convert_safety_checker(
        {k: v.contiguous() for k, v in sd.items()}))


def test_clip_vision_apply(tiny):
    px = np.random.RandomState(1).randn(3, 224, 224, 3).astype(np.float32)
    jh, jp = jclip.apply(tiny["jparams"]["vision"], tiny["jcfg"],
                         jnp.asarray(px))
    th, tp = tclip.apply(tiny["tparams"]["vision"], tiny["tcfg"], px,
                         device="cpu")
    assert th.shape == (3, 257, 16) and tp.shape == (3, 16)
    close(th, jh, "hidden")
    close(tp, jp, "pooled")


def test_apply_needs_the_card(tiny):
    px = np.zeros((1, 28, 28, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tclip.apply(tiny["tparams"]["vision"], tiny["tcfg"], px)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsafety.check(tiny["tparams"], tiny["tcfg"],
                      np.zeros((1, 28, 28, 3), np.float32))


@pytest.mark.parametrize("hw", [(28, 28), (40, 28), (30, 57), (512, 512)])
def test_preprocess_bit_equal(hw):
    """Non-square float images, values beyond [0, 1] included (clipped),
    and the uint8-transport floats the pipeline hands over (k / 255, whose
    truncating cast takes some down a level)."""
    rng = np.random.RandomState(hw[1])
    imgs = rng.uniform(-0.1, 1.1, (2,) + hw + (3,)).astype(np.float32)
    imgs[1] = rng.randint(0, 256, hw + (3,)).astype(np.float32) / 255.0
    for size in (28, 224):
        want = jclip.preprocess(imgs, size)
        got = tclip.preprocess(imgs, size)
        assert got.dtype == np.float32 and got.shape == (2, size, size, 3)
        assert np.array_equal(got, want)


def jax_concept_scores(params, cfg, images):
    """JAX's check before its ``any``."""
    px = jclip.preprocess(images, cfg.image_size)
    _, pooled = jclip.apply(params["vision"], cfg, jnp.asarray(px))
    emb = jlayers.linear(params["visual_projection"], pooled)
    special = (jsafety._cosine(emb, params["special_care_embeds"])
               - params["special_care_embeds_weights"][None])
    adj = jnp.where(jnp.any(special > 0, -1, keepdims=True), 0.01, 0.0)
    return np.asarray(jsafety._cosine(emb, params["concept_embeds"])
                      - params["concept_embeds_weights"][None] + adj)


def test_check_flags_equal(tiny):
    """A seeded suite of 12 images and three threshold settings: the flags
    are JAX's, the scores within 1e-4, no score within 1e-4 of 0."""
    images = np.random.RandomState(2).rand(12, 40, 36, 3).astype(np.float32)
    seen = set()
    for shift in (0.0, -0.45, 0.6):
        jp = jax.tree_util.tree_map(np.asarray, tiny["jparams"])
        jp = dict(jp, concept_embeds_weights=jp["concept_embeds_weights"]
                  + np.float32(shift))
        tp = from_jax(jp, "cpu")
        want = jax_concept_scores(jp, tiny["jcfg"], images)
        assert np.abs(want).min() > 1e-4
        _, _, got = tsafety.scores(tp, tiny["tcfg"], images, device="cpu")
        close(got, want, "concept scores")
        flags = tsafety.check(tp, tiny["tcfg"], images, device="cpu")
        assert flags.dtype == bool and flags.shape == (12,)
        assert np.array_equal(flags, jsafety.check(jp, tiny["jcfg"], images))
        seen.update(flags.tolist())
    assert seen == {True, False}


def test_blackout():
    imgs = np.random.RandomState(3).rand(3, 8, 8, 3).astype(np.float32)
    flags = np.array([True, False, True])
    got = tsafety.blackout(imgs, flags)
    assert np.array_equal(got, jsafety.blackout(imgs, flags))
    assert not got[[0, 2]].any() and np.array_equal(got[1], imgs[1])
    assert imgs[0].any()  # the input is left as it was


def test_init_has_the_converted_structure(tiny):
    drawn = export.flatten(tsafety.init(tiny["tcfg"], projection_dim=PROJ,
                                        device="cpu"))
    conv = export.flatten(tiny["tparams"])
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {
        k: tuple(v.shape) for k, v in conv.items()}
    assert not drawn["concept_embeds_weights"].any()
    assert not drawn["special_care_embeds_weights"].any()
