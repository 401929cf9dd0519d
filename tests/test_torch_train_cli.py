"""The port's training CLI (``blobctrl_torch.apps.train_cli``) on the CPU,
on a models root that ``params/export.write_models_root`` writes from
tiny random trees: ``load_dataset`` against the JAX CLI's (PIL) on PNG and
JPEG images and RGB masks of another size; 2 steps with a checkpoint, a
resume to 4 (starting at step 2) and the export, which reloads through
the port's loaders bit-equal to the final state; the refused
multi-process flags."""

import io
import json
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

from blobctrl_tpu.apps import train_cli as jcli
from blobctrl_torch.apps import train_cli as tcli
from blobctrl_torch.params import export as texport
from blobctrl_torch.params import io as tio
from blobctrl_torch.train import checkpoint as tckpt
from blobctrl_torch.utils import benchkit, png
from tests.test_torch_loaders import lora_tree, tiny_trees

torch.set_num_threads(2)
SIZE = 64


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    trees, cfgs = tiny_trees(seed=6)
    texport.write_models_root(
        root, unet=trees["unet"], unet_cfg=cfgs["unet"],
        blobnet=trees["blobnet"], blobnet_cfg=cfgs["blobnet"],
        vae=trees["vae"], vae_cfg=cfgs["vae"], clip=trees["clip"],
        clip_cfg=cfgs["clip"], dino=trees["dino"], dino_cfg=cfgs["dino"],
        lora=lora_tree(trees["unet"], seed=7), lora_alpha=8.0,
        tokenizer=benchkit.byte_level_tokenizer(), dino_image_size=28,
        float_dtype=None)
    return root


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Four scenes at 80 x 96 (resized and cropped to SIZE): PNG and
    JPEG images, masks as gray or RGB PNGs, prompts for three of them, and
    an image without a mask (skipped)."""
    root = tmp_path_factory.mktemp("data")
    os.makedirs(root / "images")
    os.makedirs(root / "masks")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:80, :96]
    for i in range(4):
        img = rng.randint(0, 256, (80, 96, 3)).astype(np.uint8)
        inside = ((xx - 44 - 2 * i) / 20.0) ** 2 + ((yy - 38) / 14.0) ** 2
        mask = np.where(inside <= 1.0, 230, 12).astype(np.uint8)
        name = f"scene{i}.png"
        if i % 2:  # a JPEG body under the .png name, as PIL reads it
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=90)
            (root / "images" / name).write_bytes(buf.getvalue())
            mask = np.stack([mask, mask // 2, 255 - mask], -1)  # RGB mask
        else:
            (root / "images" / name).write_bytes(png.encode_png(img))
        (root / "masks" / name).write_bytes(png.encode_png(mask))
    (root / "images" / "unmasked.png").write_bytes(png.encode_png(img))
    (root / "prompts.json").write_text(json.dumps(
        {"scene0": "a red ball", "scene1": "a cup", "scene3": "a hat"}))
    return str(root)


def test_load_dataset_matches_jax(data_root):
    want = jcli.load_dataset(data_root, SIZE)
    got = tcli.load_dataset(data_root, SIZE)
    assert got[2] == want[2] == ["a red ball", "a cup", "", "a hat"]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert all(m.any() and (m == 255).any() for m in got[1])


def _argv(models_root, data_root, tmp, *extra):
    return ["--models_root", models_root, "--data_root", data_root,
            "--size", str(SIZE), "--batch_size", "2", "--ckpt_every", "2",
            "--log_every", "1", "--lora_rank", "4", "--learning_rate",
            "1e-3", "--ckpt_dir", str(tmp / "ckpts"), "--device", "cpu",
            *extra]


def _events(caplog, name):
    out = []
    for rec in caplog.records:
        try:
            ev = json.loads(rec.getMessage())
        except ValueError:
            continue
        if ev.get("event") == name:
            out.append(ev)
    return out


def test_train_checkpoint_resume_export(models_root, data_root, tmp_path,
                                        caplog):
    caplog.set_level(logging.INFO, logger="blobctrl_torch")
    state = tcli.main(_argv(models_root, data_root, tmp_path,
                            "--steps", "2"))
    assert state["step"] == 2
    assert [e["step"] for e in _events(caplog, "train")] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in _events(caplog, "train"))
    assert tckpt.latest_step(str(tmp_path / "ckpts")) == 2
    caplog.clear()
    state = tcli.main(_argv(models_root, data_root, tmp_path, "--steps", "4",
                            "--resume", "--export_dir",
                            str(tmp_path / "export")))
    assert _events(caplog, "resumed") == [{"event": "resumed", "step": 2}]
    assert [e["step"] for e in _events(caplog, "train")] == [3, 4]
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["step_00000002",
                                                      "step_00000004"]
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    # the export reloads through the port's loaders as the final state
    blob = tio.load_blobnet(str(tmp_path / "export" / "blobnet"),
                            device="cpu")
    for a, b in zip(texport.flatten(blob).items(),
                    texport.flatten(state["params"]["blobnet"]).items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1].detach())
    lora, alpha = tio.load_lora_dir(str(tmp_path / "export" / "unet_lora"),
                                    device="cpu")
    assert alpha is None and set(lora) == set(state["params"]["lora"])
    moved = 0
    for k, ab in state["params"]["lora"].items():
        for n in ("A", "B"):
            assert torch.equal(lora[k][n], ab[n].detach())
        moved += bool(ab["B"].any())
    assert moved == len(lora)  # every B left zero


@pytest.mark.parametrize("flags", [["--coordinator", "localhost:1234"],
                                   ["--num_processes", "2"],
                                   ["--process_id", "0"],
                                   ["--data_parallel", "2"]])
def test_multi_process_flags_refused(flags, tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP item 17"):
        tcli.main(["--data_root", str(tmp_path), "--device", "cpu", *flags])
