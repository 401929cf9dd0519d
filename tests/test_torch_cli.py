"""The port's CLI (``blobctrl_torch.apps.cli``) end to end on the CPU:
argv -> ``run`` -> PNG files, on a models root that the port's
``params/export.write_models_root`` writes from tiny random trees and a
LoRA (no download); every output equals the pipeline loaded from the same root and
called directly with the same arguments, in edit mode (two rounds of
ellipses, the last one used; two samples; the ellipse overlay, drawn as
``cv2.ellipse`` draws it) and in remove mode (the background from the
original image and the mask's luma, as PIL's ``convert("L")`` gives it).
The ellipse parser refuses the JAX CLI test's garbage."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from blobctrl_torch.apps import cli
from blobctrl_torch.blob import math as tmath
from blobctrl_torch.params import export as texport
from blobctrl_torch.params import io as tio
from blobctrl_torch.utils import benchkit, png
from tests.test_torch_loaders import lora_tree, tiny_trees

torch.set_num_threads(2)

SIZE = 64


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    trees, cfgs = tiny_trees(seed=4)
    texport.write_models_root(
        root, unet=trees["unet"], unet_cfg=cfgs["unet"],
        blobnet=trees["blobnet"], blobnet_cfg=cfgs["blobnet"],
        vae=trees["vae"], vae_cfg=cfgs["vae"], clip=trees["clip"],
        clip_cfg=cfgs["clip"], dino=trees["dino"], dino_cfg=cfgs["dino"],
        lora=lora_tree(trees["unet"], seed=5), lora_alpha=8.0,
        tokenizer=benchkit.byte_level_tokenizer(), dino_image_size=28,
        float_dtype=None)
    return root


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.RandomState(0)
    arrays = {name: rng.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)
              for name in ("object", "background", "original")}
    mask = np.zeros((SIZE, SIZE, 3), np.uint8)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    mask[((xx - 32) / 12.0) ** 2 + ((yy - 30) / 8.0) ** 2 <= 1.0] = 255
    mask[0, :4] = [[1, 0, 0], [0, 1, 0], [2, 0, 0], [0, 0, 5]]  # luma 0, 1
    arrays["mask"] = mask
    paths = {}
    for name, arr in arrays.items():
        paths[name] = os.path.join(str(d), f"{name}.png")
        with open(paths[name], "wb") as f:
            f.write(png.encode_png(arr))
    return paths, arrays


@pytest.fixture(scope="module")
def pipe(models_root):
    return tio.load_pipeline(models_root, dtype=torch.float32, device="cpu")


def _read(path):
    with open(path, "rb") as f:
        return png.decode_png(f.read())


def _direct(pipe, **kw):
    out = pipe(height=SIZE, width=SIZE, seed=1248464818,
               guidance_scale=7.5, blobnet_control_guidance_start=0.0,
               blobnet_control_guidance_end=0.9, num_inference_steps=2, **kw)
    return (out.images * 255).astype(np.uint8)


def test_cli_edit_mode(models_root, inputs, pipe, tmp_path, capsys):
    paths, arrays = inputs
    out_dir = str(tmp_path / "out")
    args = cli.build_parser().parse_args([
        "--models_root", models_root, "--device", "cpu",
        "--object_image", paths["object"],
        "--edited_background", paths["background"],
        "--scene_prompt", "a red apple on a table",
        "--negative_prompt", "blurry",
        "--ellipse", "20,20,10,16,0", "--ellipse", "32,30,14,22,35",
        "--num_samples", "2", "--num_inference_steps", "2", "--dtype", "f32",
        "--output_dir", out_dir, "--plot_ellipse"])
    outs = cli.run(args)
    assert len(outs) == 4 and all(os.path.exists(p) for p in outs)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["outputs"] == outs and rec["seconds"] > 0
    ellipse = ((32.0, 30.0), (14.0, 22.0), 35.0)
    want = _direct(pipe, prompt=["a red apple on a table"] * 2,
                   negative_prompt="blurry", fg_image=arrays["object"],
                   bg_image=arrays["background"],
                   gs_score=tmath.blob_score_from_ellipse(
                       ellipse, SIZE, SIZE, (8, 8)).numpy(),
                   blobnet_conditioning_scale=1.2)
    cv2 = pytest.importorskip("cv2")
    for i in range(2):
        np.testing.assert_array_equal(_read(outs[2 * i]), want[i])
        drawn = want[i].copy()
        cv2.ellipse(drawn, ((32, 30), (14, 22), 35.0), [0, 255, 0], 3)
        np.testing.assert_array_equal(_read(outs[2 * i + 1]), drawn)
        assert not np.array_equal(drawn, want[i])


def test_cli_remove_mode(models_root, inputs, pipe, tmp_path, capsys):
    paths, arrays = inputs
    args = cli.build_parser().parse_args([
        "--models_root", models_root, "--device", "cpu",
        "--object_image", paths["object"],
        "--original_image", paths["original"],
        "--ellipse_mask", paths["mask"],
        "--scene_prompt", "an empty table", "--ellipse", "32,30,14,22,35",
        "--remove", "--num_inference_steps", "2", "--dtype", "f32",
        "--scheduler", "ddim", "--output_dir", str(tmp_path / "out")])
    outs = cli.run(args)
    assert len(outs) == 1
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    Image = pytest.importorskip("PIL.Image")
    luma = np.asarray(Image.fromarray(arrays["mask"]).convert("L"))
    np.testing.assert_array_equal(cli.to_luma(arrays["mask"]), luma)
    bg = np.where((luma > 0)[..., None], 255, arrays["original"]).astype(
        np.uint8)
    want = _direct(pipe, prompt=["an empty table"], negative_prompt=None,
                   fg_image=arrays["object"], bg_image=bg,
                   gs_score=tmath.removal_score((8, 8)).numpy(),
                   blobnet_conditioning_scale=0.0, scheduler="ddim")
    np.testing.assert_array_equal(_read(outs[0]), want[0])


def test_cli_ellipse_parser_rejects_garbage():
    assert cli.parse_ellipse("(32, 30), (14, 22), 35") == \
        ((32.0, 30.0), (14.0, 22.0), 35.0)
    for bad in ("1,2,3", "a,b,c,d,e", "__import__('os')"):
        with pytest.raises((argparse.ArgumentTypeError, ValueError)):
            cli.parse_ellipse(bad)


def test_cli_refuses_mesh_and_needs_the_card(models_root, inputs):
    """A mesh of more ranks than cards is refused (one card a rank; gloo is
    never picked for the card on its own); without CUDA the CLI needs the
    card."""
    paths, _ = inputs
    base = ["--models_root", models_root, "--object_image", paths["object"],
            "--scene_prompt", "x", "--ellipse", "1,2,3,4,5"]
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match="needs 2 cards"):
            cli.run(cli.build_parser().parse_args(base + ["--mesh",
                                                          "data=2,model=1"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(base)


def test_chip_smokes_photo_check_of_the_cli_runs_on_the_cpu(models_root,
                                                           monkeypatch):
    """``chip_smoke.py`` phase 6's CLI check at a photo's size (the CLI as
    a process against the pipeline called directly, <= 1 uint8 level), on
    this root and the CPU at 96 x 72 (W x H); the CLI's process on two
    threads, as this one."""
    import chip_smoke
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    chip_smoke.cli_photo_phase(models_root, device="cpu", steps=2,
                               wh=(96, 72))
    assert chip_smoke.PHOTO_SECONDS["phase 6"] > 0
