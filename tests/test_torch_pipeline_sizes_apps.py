"""The batch and the CLI at a photo's own size (the edits themselves are
in ``test_torch_pipeline_sizes`` and ``test_torch_pipeline_sizes_ragged``;
a file each, so that none passes ~30 s under xdist: the JAX side compiles
once a shape): fp32 on the CPU, ``edit_batch`` of two requests at 128 x 96
on the trained 128^2 toy against JAX's ``edit_batch`` (each package draws
its requests' noise from their seeds), at the uint8 bar of
``test_torch_pipeline``; and the port's CLI at a 120 x 88 photo, on a
models root written around the toy (``benchkit.write_training_root``:
tiny CLIP text and DINOv2, a LoRA), against its own pipeline called
directly with the same arguments (bit-equal, as
``test_torch_cli.test_cli_edit_mode``) and against the JAX package's CLI
run on the same root and photos (the uint8 bar). About 30 s."""

import os

import numpy as np
import pytest
import torch

import chip_smoke

from blobctrl_torch.apps import cli
from blobctrl_torch.blob import math as tmath
from blobctrl_torch.params import io as tio
from blobctrl_torch.utils import benchkit, png
from tests.test_torch_pipeline import _assert_u8_close
from tests.test_torch_pipeline_sizes import STEPS, pipes  # noqa: F401

torch.set_num_threads(2)

PHOTO_W, PHOTO_H = 120, 88
ELLIPSE = "70,40,30,44,25"
PROMPT = "a red apple on a table"


def photo_batch(w: int = 128, h: int = 96):
    """-> (two distinct toy requests at W x H, each with its own ellipse
    and seed; the shared sampler kwargs)."""
    move = chip_smoke.toy_edits(h, STEPS, width=w)["move"]
    shared = {k: move[k] for k in ("height", "width", "num_inference_steps",
                                   "guidance_scale")}
    reqs = []
    for b in range(2):
        dst = ((w * (0.45 + 0.2 * b), h * 0.55), (36.0, 30.0), 20.0 + 50 * b)
        reqs.append(dict(
            {k: move[k] for k in ("fg_image", "bg_image", "prompt_embeds",
                                  "negative_prompt_embeds",
                                  "fg_dino_feats")},
            gs_score=tmath.blob_score_from_ellipse(
                dst, w, h, (h // 8, w // 8)).numpy(), seed=40 + b))
    return reqs, shared


def test_edit_batch_at_a_photo_size_matches_jax(pipes):  # noqa: F811
    jpipe, tpipe = pipes
    w, h = 128, 96
    reqs, shared = photo_batch(w, h)
    want = jpipe.edit_batch([dict(r) for r in reqs], **shared).images
    got = tpipe.edit_batch([dict(r) for r in reqs], **shared).images
    assert got.shape == want.shape == (2, h, w, 3)
    _assert_u8_close(got, want, "edit_batch 128x96")
    assert not np.array_equal(got[0], got[1])


@pytest.fixture(scope="module")
def models_root(pipes, tmp_path_factory):  # noqa: F811
    toy = pipes[1]
    root = str(tmp_path_factory.mktemp("models"))
    benchkit.write_training_root(root, toy.unet_params, toy.unet_cfg,
                                 toy.blobnet_params, toy.blobnet_cfg,
                                 toy.vae_params, toy.vae_cfg)
    return root


def _argv(models_root, paths, out_dir, device=None):
    return (["--models_root", models_root]
            + (["--device", device] if device else [])
            + ["--object_image", paths["object"],
               "--edited_background", paths["background"],
               "--scene_prompt", PROMPT, "--ellipse", ELLIPSE,
               "--num_inference_steps", "2", "--dtype", "f32",
               "--output_dir", out_dir])


@pytest.fixture(scope="module")
def cli_photo(models_root, tmp_path_factory):
    """The port's CLI on a seeded 120 x 88 photo: -> (photos' paths, their
    arrays, the PNG it wrote)."""
    d = tmp_path_factory.mktemp("photo")
    rng = np.random.RandomState(3)
    arrays, paths = {}, {}
    for name in ("object", "background"):
        arrays[name] = rng.randint(0, 255, (PHOTO_H, PHOTO_W, 3)).astype(
            np.uint8)
        paths[name] = str(d / f"{name}.png")
        with open(paths[name], "wb") as f:
            f.write(png.encode_png(arrays[name]))
    out_dir = str(d / "port")
    outs = cli.run(cli.build_parser().parse_args(
        _argv(models_root, paths, out_dir, device="cpu")))
    assert outs == [os.path.join(out_dir, "edit_0.png")]
    with open(outs[0], "rb") as f:
        return paths, arrays, png.decode_png(f.read())


def test_cli_at_a_photo_size(models_root, cli_photo, capsys):
    paths, arrays, got = cli_photo
    capsys.readouterr()
    w, h = PHOTO_W, PHOTO_H
    pipe = tio.load_pipeline(models_root, dtype=torch.float32, device="cpu")
    want = pipe(prompt=[PROMPT], negative_prompt=None,
                fg_image=arrays["object"], bg_image=arrays["background"],
                gs_score=tmath.blob_score_from_ellipse(
                    ((70.0, 40.0), (30.0, 44.0), 25.0), w, h,
                    (h // 8, w // 8)).numpy(),
                height=h, width=w, seed=1248464818, guidance_scale=7.5,
                blobnet_conditioning_scale=1.2,
                blobnet_control_guidance_start=0.0,
                blobnet_control_guidance_end=0.9,
                num_inference_steps=2).images
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, (want[0] * 255).astype(np.uint8))


def test_cli_at_a_photo_size_matches_the_jax_cli(models_root, cli_photo,
                                                 tmp_path, capsys):
    """The JAX package's CLI on the same root and photos: its PNG, read
    back, within the uint8 bar of the port's (the wiring of the photo's
    W and H into the blob score and the latents held against JAX's
    own)."""
    from PIL import Image

    from blobctrl_tpu.apps import cli as jcli
    paths, _, got = cli_photo
    out_dir = str(tmp_path / "jax")
    outs = jcli.run(jcli.build_parser().parse_args(
        _argv(models_root, paths, out_dir)))
    capsys.readouterr()
    assert outs == [os.path.join(out_dir, "edit_0.png")]
    want = np.asarray(Image.open(outs[0]).convert("RGB"))
    assert want.shape == got.shape == (PHOTO_H, PHOTO_W, 3)
    _assert_u8_close(got / 255.0, want / 255.0, "CLI 120x88")
