"""Replayable state files across both packages, and the port's replay,
fp32 on the CPU at size 64 on the tiny nets of ``test_torch_session``.

A session edits (a fitted blob moved, then a compositional target with
its tracking points) and saves its state; the port's state directory
loads in the JAX package's session and the JAX one in the port's, with the
same images, the same ``state.json``, the same editor entries and tracking
points. ``apps/replay.replay`` of the saved state equals the session's own
run bit for bit (same seed, the PNGs lossless), and a state the JAX
session wrote replays in the port as in JAX (uint8 bar); a remove-mode state
replays as the session's remove run; ``outside_mask_psnr`` equals the JAX
package's; a state with a recorded ``results_gallery`` scores through
``score_all`` and ``print_score_table``."""

import json
import os

import numpy as np
import pytest
import torch

from blobctrl_tpu.apps import replay as jreplay
from blobctrl_tpu.apps import session as jsession
from blobctrl_tpu.blob import viz as jviz
from blobctrl_torch.apps import replay as treplay
from blobctrl_torch.apps import session as tsession
from blobctrl_torch.utils import png
from tests.test_torch_session import _assert_u8_close, pipelines  # noqa: F401

torch.set_num_threads(2)

SIZE = 64
STEPS = 2
PROMPT = "a red ball on a table"
RUN = dict(seed=17, num_inference_steps=STEPS, guidance_scale=5.0,
           blobnet_control_strength=1.1)


def _session(lib, pipe, compositional=False):
    s = lib.BlobCtrlSession(pipe, size=SIZE)
    rng = np.random.RandomState(1)
    s.set_image(rng.randint(0, 256, (80, 120, 3)).astype(np.uint8))
    # a tilted ellipse: the two fits agree on it (test_torch_session)
    s.set_mask(jviz.ellipse_mask(((30.0, 34.0), (22.0, 30.0), 15.0), SIZE,
                                 SIZE))
    s.generate_blob()
    s.move(8, -4)
    s.rotate(20)
    if compositional:
        s.set_init_ellipse((0.5, 0.4, 0.2, 0.3, 45.0))
        s.set_object_image(rng.randint(0, 256, (70, 50, 3)).astype(np.uint8))
    return s


def _files(d):
    out = {}
    for sub, _, names in os.walk(d):
        for n in names:
            path = os.path.join(sub, n)
            out[os.path.relpath(path, d)] = path
    return out


@pytest.mark.parametrize("compositional", [False, True])
def test_state_dirs_load_across_packages(pipelines, tmp_path,  # noqa: F811
                                         compositional):
    jpipe, tpipe = pipelines
    dirs = {}
    for name, lib, pipe in (("jax", jsession, jpipe),
                            ("port", tsession, tpipe)):
        s = _session(lib, pipe, compositional)
        dirs[name] = s.save_state(str(tmp_path / name), PROMPT, **RUN)
    files = {k: _files(d) for k, d in dirs.items()}
    assert set(files["port"]) == set(files["jax"])
    assert "state/state.json" in files["port"]
    for rel in files["port"]:
        if rel.endswith(".json"):
            assert (json.load(open(files["port"][rel]))
                    == json.load(open(files["jax"][rel]))), rel
        else:  # the pixels, whatever each codec's bytes
            np.testing.assert_array_equal(
                png.decode_png(open(files["port"][rel], "rb").read()),
                png.decode_png(open(files["jax"][rel], "rb").read()))
    state = json.load(open(files["port"]["state/state.json"]))
    assert len(state["tracking_points"]) == (2 if compositional else 0)
    # each package's directory loads in the other's session
    for src, lib, pipe in (("port", jsession, jpipe),
                           ("jax", tsession, tpipe)):
        s = lib.BlobCtrlSession(pipe, size=SIZE)
        got = s.load_state(dirs[src])
        ref = _session(tsession if lib is jsession else jsession,
                       tpipe if lib is jsession else jpipe, compositional)
        assert got == state
        np.testing.assert_array_equal(s.original_image, ref.original_image)
        np.testing.assert_array_equal(s.fg_image, ref.fg_image)
        assert s.tracking_points == [list(p) for p in ref.tracking_points]
        assert len(s.editor.entries) == len(ref.editor.entries)
        for (e, p, t), (re_, rp, rt) in zip(s.editor.entries,
                                            ref.editor.entries):
            np.testing.assert_allclose(np.hstack([e[0], e[1], e[2]]),
                                       np.hstack([re_[0], re_[1], re_[2]]),
                                       atol=1e-12, rtol=0)
            assert tuple(p) == tuple(rp) and t == rt


@pytest.mark.parametrize("remove", [False, True])
def test_replay_equals_the_sessions_run(pipelines, tmp_path,  # noqa: F811
                                        remove):
    _, tpipe = pipelines
    s = _session(tsession, tpipe)
    if remove:
        s.set_remove_mode(True)
    d = s.save_state(str(tmp_path / "state"), PROMPT, remove=remove, **RUN)
    want = s.run(PROMPT, remove=remove, **RUN).images
    images, state, final = treplay.replay(tpipe, d)
    assert state["remove_blob_box"] is remove
    assert images.shape == want.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_array_equal(images, want)
    e = s.editor.initial if remove else s.editor.current
    np.testing.assert_allclose(np.hstack([final[0], final[1], final[2]]),
                               np.hstack([e[0], e[1], e[2]]), atol=1e-9)


@pytest.mark.parametrize("remove", [False, True])
def test_a_jax_state_dir_replays_as_jax_replays_it(
        pipelines, tmp_path, remove):  # noqa: F811
    """A state directory the JAX session wrote, replayed by the port with
    no latents given: its seed draws JAX's noise, so the images meet the
    uint8 bar against JAX's own replay. 2-7 s each."""
    jpipe, tpipe = pipelines
    s = _session(jsession, jpipe)
    if remove:
        s.set_remove_mode(True)
    d = s.save_state(str(tmp_path / "state"), PROMPT, remove=remove, **RUN)
    want, jstate, _ = jreplay.replay(jpipe, d)
    got, state, _ = treplay.replay(tpipe, d)
    assert state == jstate and state["seed"] == RUN["seed"]
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    _assert_u8_close(got, want, f"replay remove={remove}")


def test_outside_mask_psnr_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.rand(SIZE, SIZE, 3).astype(np.float32)
    b = (rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    ells = [((30.0, 34.0), (22.0, 30.0), 15.0), ((40.0, 20.0), (10, 12), 80)]
    want = jreplay.outside_mask_psnr(a, b, ells, SIZE, SIZE)
    assert treplay.outside_mask_psnr(a, b, ells, SIZE, SIZE) == want
    assert treplay.outside_mask_psnr(a, a, ells, SIZE, SIZE) == float("inf")


def test_score_all_reads_a_results_gallery(pipelines, tmp_path,  # noqa: F811
                                           capsys):
    _, tpipe = pipelines
    s = _session(tsession, tpipe)
    root = tmp_path / "demo"
    d = s.save_state(str(root / "move_cup"), PROMPT, **RUN)
    out = s.run(PROMPT, **RUN).images
    gallery = os.path.join(d, "results_gallery")
    os.makedirs(gallery)
    with open(os.path.join(gallery, "0.png"), "wb") as f:
        f.write(png.encode_png((out[0] * 255).round().astype(np.uint8)))
    rows = treplay.score_all(tpipe, str(root))
    assert [r["name"] for r in rows] == ["move_cup"]
    assert rows[0]["num_scored"] == 1 and rows[0]["psnr_db"] == float("inf")
    summary = treplay.print_score_table(rows)
    assert summary["states_scored"] == 1
    assert "move_cup" in capsys.readouterr().out
