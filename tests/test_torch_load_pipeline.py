"""``load_pipeline`` from a whole reference-layout ``models_root``, the
port against the JAX package, fp32 on the CPU.

The root is written by the port's ``params/export.write_models_root`` (what
``chip_smoke.py`` writes at full width on the card; its UNet layout is held
against the JAX exporter in ``test_torch_loaders``): the trained 128^2 toy
UNet (its conv_in cut to SD-1.5's 4 input channels, so both loaders widen
it), BlobNet and VAE, tiny random CLIP text and DINOv2, a random PEFT LoRA
(attention, feed-forward, 1x1 and 3x3 conv adapters) with ``lora_alpha``
in its adapter_config.json, a DINOv2 preprocessor config whose crop (28)
is not 224, and a byte-level tokenizer's vocab.json and merges.txt. Both
loaders must agree on every config and the DINOv2 input size, load the
nets bit-equal (the LoRA-merged UNet within 1e-6 relative), and run the
toy move edit from a text prompt and the object image with the same
latents to the bar of ``test_torch_pipeline`` (<= 1 uint8 level at >= 99.9
% of pixels, <= 2 everywhere), also after a runtime LoRA rescale through
``cross_attention_kwargs``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_tpu.params import io as jio
from blobctrl_torch.models import clip_text as tclip
from blobctrl_torch.params import export as texport
from blobctrl_torch.params import io as tio
from blobctrl_torch.train import toy as ttoy
from blobctrl_torch.utils import benchkit
from tests.test_torch_loaders import (assert_trees_close, assert_trees_equal,
                                      lora_tree, tiny_trees)
from tests.test_torch_pipeline import _assert_u8_close, _edits

torch.set_num_threads(2)

SIZE = 128
CROP = 28
ALPHA = 8.0


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models_root"))
    trees, cfgs = tiny_trees(seed=2)
    toy, _ = ttoy.load_toy("assets/toy_ckpt", device="cpu")
    for net in ("unet", "blobnet", "vae"):
        trees[net] = jax.tree_util.tree_map(lambda t: t.numpy(),
                                            getattr(toy, net + "_params"))
        cfgs[net] = getattr(toy, net + "_cfg")
    trees["unet"]["conv_in"]["kernel"] = trees["unet"]["conv_in"][
        "kernel"][:, :, :4]
    cfgs["unet"] = dataclasses.replace(cfgs["unet"], in_channels=4)
    lora = lora_tree(trees["unet"], seed=3)
    texport.write_models_root(
        root, unet=trees["unet"], unet_cfg=cfgs["unet"],
        blobnet=trees["blobnet"], blobnet_cfg=cfgs["blobnet"],
        vae=trees["vae"], vae_cfg=cfgs["vae"], clip=trees["clip"],
        clip_cfg=cfgs["clip"], dino=trees["dino"], dino_cfg=cfgs["dino"],
        lora=lora, lora_alpha=ALPHA,
        tokenizer=benchkit.byte_level_tokenizer(), dino_image_size=CROP,
        float_dtype=None)
    return root, cfgs


@pytest.fixture(scope="module")
def pipes(models_root):
    root, _ = models_root
    return (jio.load_pipeline(root, dtype=jnp.float32),
            tio.load_pipeline(root, dtype=torch.float32, device="cpu"))


def test_configs_and_weights_match_jax(pipes, models_root):
    jpipe, tpipe = pipes
    _, cfgs = models_root
    for name, want_cfg in (("unet_cfg", dataclasses.replace(
            cfgs["unet"], in_channels=5)), ("blobnet_cfg", cfgs["blobnet"]),
            ("vae_cfg", cfgs["vae"]), ("clip_cfg", cfgs["clip"]),
            ("dino_cfg", cfgs["dino"])):
        got, want = getattr(tpipe, name), getattr(jpipe, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got == want_cfg, name
    assert tpipe.dino_image_size == jpipe.dino_image_size == CROP
    assert tpipe.tokenizer.encoder == jpipe.tokenizer.encoder
    assert tpipe.tokenizer.bpe_ranks == jpipe.tokenizer.bpe_ranks
    for name in ("blobnet_params", "vae_params", "clip_params",
                 "dino_params"):
        assert_trees_equal(getattr(tpipe, name), getattr(jpipe, name))
    assert_trees_close(tpipe.unet_params, jpipe.unet_params)
    assert tpipe._lora_alpha == jpipe._lora_alpha == ALPHA
    assert tpipe._lora_scale == jpipe._lora_scale == 1.0
    assert set(tpipe._lora_tree) == set(jpipe._lora_tree)


def _text_edit():
    """The toy move edit with a text prompt for CLIP and the object image
    for DINOv2 in place of the class embeddings."""
    kw = dict(_edits(SIZE)["move"], prompt="a red ball")
    for k in ("prompt_embeds", "negative_prompt_embeds", "fg_dino_feats"):
        del kw[k]
    return kw


def test_text_prompt_edit_matches_jax(pipes, monkeypatch):
    """The edit from a text prompt (tokenizer, CLIP and DINOv2 of the
    loaded root), then again at LoRA scale 0.5: the rescale replaces the
    UNet tree but keeps the prompt memo (its key is the CLIP tree's)."""
    jpipe, tpipe = pipes
    kw = _text_edit()
    want = jpipe(**kw).images
    got = tpipe(**kw).images
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    _assert_u8_close(got, want, "text edit")
    clip_calls = []
    apply = tclip.encode_with_clip_skip

    def spy(*args, **kwargs):
        clip_calls.append(1)
        return apply(*args, **kwargs)
    monkeypatch.setattr(tclip, "encode_with_clip_skip", spy)
    unet_before = tpipe.unet_params
    kw2 = dict(kw, cross_attention_kwargs={"scale": 0.5})
    want2 = jpipe(**kw2).images
    got2 = tpipe(**kw2).images
    assert tpipe._lora_scale == jpipe._lora_scale == 0.5
    assert tpipe.unet_params is not unet_before
    assert not clip_calls and len(tpipe._prompt_cache) == 1
    _assert_u8_close(got2, want2, "text edit, LoRA scale 0.5")
    assert np.abs(got2 - got).max() > 0  # the rescale changed the edit
