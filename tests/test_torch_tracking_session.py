"""The port's click-to-move tracking points, point-click segmentation,
preview galleries, compositional add and remove-mode toggle, step for step
beside the JAX session: every case of ``tests/test_tracking_session.py``
runs on both sessions (``pipeline=None``, size 256, the port on the CPU),
and after each step the editor entries and tracking points are equal and
every overlay is bit-equal (the tracking overlay is the host float64
renderer on both sides). The blob view returned with the first-click
warning is the device splat on the port's side, held to the blob view's
bar (<= 1 level, >= 99.9 % of pixels equal). ``click`` with the
``FakeSam`` double gives the JAX session's mask and blob; a saved state
replays
into the same overlay; ``replay --score_ui`` scores a written state."""

import json
import os

import numpy as np
import pytest

from blobctrl_tpu.apps import gradio_app as jgradio
from blobctrl_tpu.apps import session as jsession
from blobctrl_torch.apps import gradio_app as tgradio
from blobctrl_torch.apps import replay as treplay
from blobctrl_torch.apps import session as tsession
from tests.test_gradio_wiring import FakeSam

SIZE = 256
START = ((100.0, 100.0), (60.0, 90.0), 20.0)


class Pair:
    """The JAX session and the port's, driven by the same calls."""

    def __init__(self, size=SIZE, sam=False, **kw):
        self.j = jsession.BlobCtrlSession(
            pipeline=kw.get("jpipe"), size=size,
            sam_predictor=FakeSam() if sam else None)
        self.t = tsession.BlobCtrlSession(
            pipeline=kw.get("tpipe"), size=size, device="cpu",
            sam_predictor=FakeSam() if sam else None)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            return (getattr(self.j, name)(*args, **kwargs),
                    getattr(self.t, name)(*args, **kwargs))
        return call

    def check(self):
        assert self.t.editor.entries == self.j.editor.entries
        assert self.t.tracking_points == self.j.tracking_points
        np.testing.assert_array_equal(self.t.tracking_overlay(),
                                      self.j.tracking_overlay())


def _equal_images(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _view_close(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                       (d == 0).mean())


@pytest.fixture
def pair():
    p = Pair()
    for s in (p.j, p.t):
        s.original_image = np.full((SIZE, SIZE, 3), 120, np.uint8)
        s.editor.init_from_ellipse(START)
    return p


def test_first_click_guard_and_center_selection(pair):
    (jo, jw), (to, tw) = pair.add_tracking_point(240, 240)
    assert jw == tw and tw is not None and pair.t.tracking_points == []
    _view_close(to, jo)
    (jo, jw), (to, tw) = pair.add_tracking_point(105, 102)
    assert jw is None and tw is None
    assert pair.t.tracking_points == [[100, 100]]
    assert pair.t.editor.current[0] == (100.0, 100.0)
    _equal_images(jo, to)
    pair.check()


def test_subsequent_clicks_move_by_delta(pair):
    for x, y in ((100, 100), (150, 120), (160, 100)):
        (jo, _), (to, _) = pair.add_tracking_point(x, y)
        _equal_images(jo, to)
        pair.check()
    assert pair.t.editor.current[0] == (160.0, 100.0)
    jo, to = pair.undo_tracking_point()
    _equal_images(jo, to)
    assert pair.t.editor.current[0] == (150.0, 120.0)
    pair.check()
    jo, to = pair.reset_tracking_points()
    _equal_images(jo, to)
    assert pair.t.tracking_points == [] and \
        pair.t.editor.current[0] == (100.0, 100.0)
    pair.check()
    # undo down to nothing, then once more (resets)
    pair.add_tracking_point(100, 100)
    pair.add_tracking_point(130, 140)
    for _ in range(3):
        jo, to = pair.undo_tracking_point()
        _equal_images(jo, to)
        pair.check()


def test_no_blob_yet_warns():
    p = Pair()
    (jo, jw), (to, tw) = p.add_tracking_point(10, 10)
    assert jo is None and to is None and jw == tw


def test_tracking_overlay_draws(pair):
    pair.add_tracking_point(100, 100)
    pair.add_tracking_point(170, 150)
    jimg, timg = pair.tracking_overlay()
    assert timg.shape == (SIZE, SIZE, 3) and timg.dtype == np.uint8
    np.testing.assert_array_equal(timg, jimg)
    jb, tb = pair.blob_visualization()
    _view_close(tb, jb)
    assert np.abs(timg.astype(int) - tb.astype(int)).max() > 0


def test_many_points_repeated_and_off_canvas(pair):
    for x, y in ((101, 99), (140, 60), (140, 60), (250, 250), (300, -20),
                 (10, 200)):
        pair.add_tracking_point(x, y)
        pair.check()


def test_preview_galleries(pair):
    pair.add_tracking_point(100, 100)
    pair.add_tracking_point(180, 150)
    jori, tori = pair.ori_preview_gallery()
    assert len(tori) == 5
    for a, b in zip(jori, tori):
        _equal_images(a, b)
    jed, ted = pair.edited_preview_gallery()
    assert len(ted) == 2
    for a, b in zip(jed, ted):
        _equal_images(a, b)
    np.testing.assert_array_equal(ted[0], pair.t.build_edited_background())


def test_set_init_ellipse_and_object(pair):
    jt, tt = pair.set_init_ellipse([0.5, 0.5, 0.2, 0.1, 45.0])
    assert jt == tt and tt[0] == (128.0, 128.0)
    assert pair.t.editor.initial[1] == (1e-5, 1e-5)
    pair.check()
    obj = np.full((300, 300, 3), 255, np.uint8)
    obj[100:200, 120:220] = 30
    jfg, tfg = pair.set_object_image(obj)
    np.testing.assert_array_equal(tfg, jfg)
    for a, b in zip(*pair.ori_preview_gallery()):
        _equal_images(a, b)


def test_remove_mode_toggle_idempotent(pair):
    for flag in (True, True, False):
        ja, ta = pair.set_remove_mode(flag)
        assert ja == ta
        pair.check()


def test_remove_mode_keeps_resize_during(pair):
    pair.set_remove_mode(True)
    pair.resize_start_blob(0.9, 0)
    pair.set_remove_mode(False)
    pair.check()
    np.testing.assert_array_equal(pair.t.build_edited_background(),
                                  pair.j.build_edited_background())


def test_parse_init_ellipse_and_list_examples(tmp_path):
    for text in ("[0.5, 0.5, 0.2, 0.2, 180]", "(0.1,0.2,0.3,0.4,5)"):
        assert tgradio.parse_init_ellipse(text) == \
            jgradio.parse_init_ellipse(text)
    for bad in ("[1,2,3]", "__import__('os')"):
        with pytest.raises(ValueError):
            tgradio.parse_init_ellipse(bad)
    for name in ("move_hat", "remove_cow", "not_an_example"):
        os.makedirs(tmp_path / name / "state")
    assert tgradio.list_examples(str(tmp_path)) == \
        jgradio.list_examples(str(tmp_path))


def test_click_gives_the_jax_mask():
    p = Pair(size=64, sam=True)
    img = np.full((80, 90, 3), 200, np.uint8)
    img[20:60, 25:65] = 60
    ji, ti = p.set_image(img)
    np.testing.assert_array_equal(ti, ji)
    for x, y, lb in ((32, 32, 1), (10, 12, 0)):
        jm, tm = p.click(x, y, lb)
        assert tm.dtype == np.uint8
        np.testing.assert_array_equal(tm, jm)
    assert p.t.selected_points == p.j.selected_points
    je, te = p.generate_blob()
    assert te == je             # the disc's fit: angle 0, as cv2 gives it
    np.testing.assert_array_equal(p.t.fg_image, p.j.fg_image)
    p.add_tracking_point(*p.t.editor.initial[0])
    p.add_tracking_point(40, 20)
    p.check()
    # set_image calls the predictor's set_image and clears the points
    p.set_image(img[:, ::-1].copy())
    assert p.t.selected_points == [] and p.t.sam.hw == (64, 64)


def test_session_run_forwards_encoder_cache_interval():
    seen = {}

    class _StubPipe:
        device = "cpu"

        def __call__(self, **kw):
            seen.update(kw)

            class _Out:
                images = np.zeros((1, 64, 64, 3), np.float32)
            return _Out()

    s = tsession.BlobCtrlSession(_StubPipe(), size=64)
    s.original_image = np.zeros((64, 64, 3), np.uint8)
    s.fg_image = np.zeros((64, 64, 3), np.uint8)
    s.editor.init_from_ellipse(((32.0, 32.0), (20.0, 28.0), 0.0))
    s.run("a thing", num_inference_steps=2, encoder_cache_interval=3)
    assert seen.get("encoder_cache_interval") == 3


def test_saved_state_replays_into_the_same_overlay(pair, tmp_path):
    for x, y in ((100, 100), (150, 130), (170, 90)):
        pair.add_tracking_point(x, y)
    want = pair.t.tracking_overlay()
    out = pair.t.save_state(str(tmp_path / "st"), prompt="p")
    for s in (tsession.BlobCtrlSession(None, size=SIZE, device="cpu"),
              jsession.BlobCtrlSession(None, size=SIZE)):
        state = s.load_state(out)
        assert state["tracking_points"] == [[100, 100], [150, 130],
                                            [170, 90]]
        np.testing.assert_array_equal(s.tracking_overlay(), want)


def test_save_load_state_roundtrip_remove_flag(tmp_path):
    s = tsession.BlobCtrlSession(None, size=64, device="cpu")
    s.original_image = np.zeros((64, 64, 3), np.uint8)
    s.fg_image = np.zeros((64, 64, 3), np.uint8)
    s.editor.init_from_ellipse(((32.0, 32.0), (20.0, 28.0), 0.0))
    s.tracking_points = [[32, 32], [40, 36]]
    s.set_remove_mode(True)
    out = s.save_state(str(tmp_path / "st"), prompt="p", remove=True)
    s2 = tsession.BlobCtrlSession(None, size=64, device="cpu")
    state = s2.load_state(out)
    assert state["remove_blob_box"] is True and s2._remove_inflated is True
    assert state["tracking_points"] == [[32, 32], [40, 36]]


def test_replay_score_ui_runs_on_a_written_dir(pair, tmp_path, capsys):
    from PIL import Image
    for x, y in ((100, 100), (160, 140)):
        pair.add_tracking_point(x, y)
    d = str(tmp_path / "demo" / "move_thing")
    pair.t.save_state(d, prompt="p")
    os.makedirs(os.path.join(d, "editable_blob"))
    Image.fromarray(pair.j.tracking_overlay()).save(
        os.path.join(d, "editable_blob", "editable_blob.png"))
    treplay.main(["--demo_root", str(tmp_path / "demo"), "--score_ui"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    # editable_blob and edited_result_gallery_0 are written: both exact
    assert summary == {"metric": "ui_golden_pixels_vs_reference",
                       "artifacts_scored": 2, "artifacts_bit_exact": 2}


@pytest.mark.parametrize("box", [((28.0, 30.0), (18.0, 26.0), 0.0),
                                 ((28.0, 30.0), (26.0, 18.0), 0.0),
                                 ((30.0, 33.0), (18.0, 26.0), 90.0),
                                 ((32.0, 32.0), (30.0, 30.0), 0.0)])
def test_axis_aligned_and_circular_masks_fit_as_cv2(box):
    """Masks of axis-aligned ellipses and of a circle: the fit's cross
    term is at rounding level, and the angle must still be cv2's."""
    from blobctrl_tpu.blob import editor as jeditor
    from blobctrl_tpu.blob import viz as jviz
    from blobctrl_torch.blob import editor as teditor
    m = jviz.ellipse_mask(box, 64, 64)
    assert teditor.ellipse_from_mask(m) == jeditor.ellipse_from_mask(m)
