"""The port's checkpoint-day dry run (``blobctrl_torch.apps.checkpoint_day``)
beside the JAX package's, fp32 on the CPU, on one reference-layout models
root that the port's ``params/export.write_models_root`` writes at the toy
geometry (``test_torch_load_pipeline``'s root: the trained 128^2 toy nets,
tiny CLIP and DINOv2, a LoRA, a byte-level tokenizer) and one demo root of
two states that the port's session writes (a move with tracking points and
its editable-blob golden, and a remove), each with a results gallery.

Each side loads the root through its own ``load_pipeline`` (injected)
and draws each state's noise from its seed by its own code; the JAX
scorer's WebP cache hop is the identity (the port has no WebP codec). The
two reports agree on the stage list, the ``ok`` flags, the UI goldens' counts, each
mode's mean PSNR (within 0.5 dB; fp32, 2 steps) and the gates. Also: the
download stage refuses (never fetches) when the layout is absent, the int8
switches are off after the run, and the report serialises to JSON."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_tpu.apps import checkpoint_day as jcd
from blobctrl_tpu.apps import ui_render as jui
from blobctrl_tpu.params import io as jio
from blobctrl_torch.apps import checkpoint_day as tcd
from blobctrl_torch.apps import session as tsession
from blobctrl_torch.nn import attention
from blobctrl_torch.ops import conv3x3
from blobctrl_torch.params import io as tio
from blobctrl_torch.utils import png
from tests.test_torch_load_pipeline import models_root  # noqa: F401

torch.set_num_threads(2)

SIZE = 64
NAMES = ["move_thing", "remove_thing"]


def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png.encode_png(np.asarray(arr, np.uint8)))


@pytest.fixture(scope="module")
def demo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo"))
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    img = np.stack([xx * 4, yy * 4, (xx + yy) * 2], -1).astype(np.uint8)
    mask = (((xx - 30) / 12.0) ** 2 + ((yy - 28) / 9.0) ** 2 <= 1.0)
    for name in NAMES:
        s = tsession.BlobCtrlSession(None, size=SIZE, device="cpu")
        s.set_image(img)
        s.set_mask(mask.astype(np.uint8) * 255)
        s.generate_blob()
        remove = name.startswith("remove")
        if not remove:
            s.add_tracking_point(30, 28)
            s.add_tracking_point(40, 36)
        d = os.path.join(root, name)
        s.save_state(d, prompt="a red ball", remove=remove, num_samples=1,
                     num_inference_steps=2, seed=11)
        if not remove:
            _write_png(os.path.join(d, "editable_blob", "editable_blob.png"),
                       s.tracking_overlay())
        recorded = (img.astype(np.int32) + rs.randint(-20, 20, img.shape))
        _write_png(os.path.join(d, "results_gallery", "results_gallery_0.png"),
                   recorded.clip(0, 255))
    return root


@pytest.fixture(scope="module")
def reports(models_root, demo_root):  # noqa: F811
    root, _ = models_root

    port = tcd.run_checkpoint_day(
        models_root=root, demo_root=demo_root, steps=2, num_samples=1,
        names=NAMES, load_pipeline=lambda r: tio.load_pipeline(
            r, dtype=torch.float32, device="cpu"), device="cpu")
    port_flags = (conv3x3.conv_int8_enabled(), attention.attention_int8_mode())
    webp = jui.webp_cache_roundtrip
    jui.webp_cache_roundtrip = lambda x: np.asarray(x)
    try:
        ref = jcd.run_checkpoint_day(
            models_root=root, demo_root=demo_root, steps=2, num_samples=1,
            names=NAMES, load_pipeline=lambda r: jio.load_pipeline(
                r, dtype=jnp.float32))
    finally:
        jui.webp_cache_roundtrip = webp
    return port, ref, port_flags


def test_stages_flags_counts_and_gates_match_jax(reports):
    port, ref, _ = reports
    expected = ["download", "load", "ui_goldens", "exact", *tcd.FAST_MODES]
    assert [s["stage"] for s in port["stages"]] == expected
    assert [s["stage"] for s in ref["stages"]] == expected
    ps = {s["stage"]: s for s in port["stages"]}
    rs = {s["stage"]: s for s in ref["stages"]}
    for name in expected:
        assert ps[name]["ok"] == rs[name]["ok"], (name, ps[name].get("error"),
                                                  rs[name].get("error"))
        assert ps[name]["ok"], (name, ps[name].get("error"))
    assert ps["download"]["skipped"] and ps["download"]["reason"] == \
        rs["download"]["reason"]
    assert ps["load"]["total_params"] == rs["load"]["total_params"] > 0
    # the move state's editable blob and edited background, both exact
    assert ps["ui_goldens"]["artifacts"] == rs["ui_goldens"]["artifacts"] == 2
    assert ps["ui_goldens"]["bit_exact"] == rs["ui_goldens"]["bit_exact"] == 2
    for mode in ("exact", *tcd.FAST_MODES):
        assert [r["name"] for r in ps[mode]["rows"]] == NAMES
        p, r = ps[mode]["mean_psnr_db"], rs[mode]["mean_psnr_db"]
        assert np.isfinite(p) and abs(p - r) <= 0.5, (mode, p, r)
    for mode in tcd.FAST_MODES:
        assert abs(ps[mode]["psnr_drop_db"] - rs[mode]["psnr_drop_db"]) <= 1.0
    assert port["gates"] == ref["gates"]
    assert set(port["gates"]) == {"exact", "overall", *tcd.FAST_MODES}


def test_int8_switches_off_and_report_serialises(reports, capsys):
    port, _, (conv_on, (qk_on, gk_on)) = reports
    assert not conv_on and not qk_on and not gk_on
    json.loads(json.dumps(port))
    tcd.print_report(port)
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == {"gates":
                                                        port["gates"]}


def test_download_refused_without_the_layout(tmp_path):
    called = []
    rep = tcd.run_checkpoint_day(
        models_root=str(tmp_path / "empty"), demo_root=str(tmp_path),
        load_pipeline=lambda r: called.append(r))
    assert [s["stage"] for s in rep["stages"]] == ["download"]
    row = rep["stages"][0]
    assert not row["ok"] and "write_models_root" in row["error"]
    assert rep["gates"] == {"overall": False} and not called
    rep = tcd.run_checkpoint_day(
        models_root=str(tmp_path / "empty"), demo_root=str(tmp_path),
        skip_download=True, load_pipeline=lambda r: 1 / 0)
    assert [s["stage"] for s in rep["stages"]] == ["download", "load"]
    assert rep["stages"][0]["skipped"] and not rep["stages"][1]["ok"]
    assert "ZeroDivisionError" in rep["stages"][1]["error"]
    assert rep["gates"]["overall"] is False


def test_main_exit_code_and_json(tmp_path, capsys):
    out = str(tmp_path / "r.json")
    rc = tcd.main(["--models_root", str(tmp_path / "none"), "--demo_root",
                   str(tmp_path), "--json_out", out])
    assert rc == 1
    with open(out) as f:
        assert json.load(f)["gates"] == {"overall": False}
    with pytest.raises(AssertionError, match="unknown fast mode"):
        tcd.main(["--fast_modes", "int9"])
