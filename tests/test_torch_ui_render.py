"""The port's UI renderer (``blobctrl_torch.apps.ui_render``) and the
drawing calls under it (``blob/raster``), bit-equal to what the JAX package
draws: each raster call against cv2 5.0 (``line`` at thickness 1 and
thicker, ``arrowedLine``, ``drawMarker`` cross and triangle-up, ellipse
outlines of thickness 2 and 3 that cv2 draws at LINE_8 and at lineType
-1) over seeded points, sizes, angles and
borders, points off the image included, into float64 RGBA and uint8 RGB
images; ``alpha_composite`` against PIL; ``blob_vis_exact``,
``render_editable_blob``, ``render_tracking_ui`` and ``render_ori_gallery``
against the JAX functions over seeded tracking states (0, 1, 2 and 5
points, repeated points, degenerate start ellipses, ellipses across the
border); and the scorer on demo directories that the test writes from the
JAX renderer's PNGs, every artifact exact, with the rows of the JAX scorer
(whose WebP cache hop is replaced by the identity here: the port has no
WebP codec and compares the render as it is, ``hops`` 0)."""

import io
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from blobctrl_tpu.apps import ui_render as jui
from blobctrl_torch.apps import ui_render as tui
from blobctrl_torch.blob import raster

# ---------------------------------------------------------------------------
# raster calls vs cv2
# ---------------------------------------------------------------------------


def _canvas(kind, h, w, rs):
    if kind == "f64_rgba":
        return np.zeros((h, w, 4)), (0, 0, 255, 255)
    return rs.randint(0, 255, (h, w, 3)).astype(np.uint8), (0, 255, 0)


def _points(rs, h, w):
    return [(int(x), int(y)) for x, y in zip(rs.randint(-30, w + 30, 2),
                                             rs.randint(-30, h + 30, 2))]


def _draw_line(rs, a, b, col, h, w):
    p0, p1 = _points(rs, h, w)
    th = int(rs.choice([1, 2, 3, 5]))
    cv2.line(a, p0, p1, col, th)
    raster.line(b, p0, p1, col, th)


def _draw_arrow(rs, a, b, col, h, w):
    p0, p1 = _points(rs, h, w)
    if p0 == p1:
        p1 = (p1[0] + 3, p1[1])
    seg = np.sqrt((p1[0] - p0[0]) ** 2 + (p1[1] - p0[1]) ** 2)
    tip = float(rs.choice([8 / seg, 0.1, 0.4]))
    th = int(rs.choice([1, 2, 3]))
    cv2.arrowedLine(a, p0, p1, col, th, tipLength=tip)
    raster.arrowed_line(b, p0, p1, col, th, tip)


def _draw_marker(rs, a, b, col, h, w):
    p0, _ = _points(rs, h, w)
    mt = int(rs.choice([cv2.MARKER_CROSS, cv2.MARKER_TRIANGLE_UP]))
    size, th = int(rs.choice([7, 10, 20])), int(rs.choice([1, 2, 5]))
    cv2.drawMarker(a, p0, col, markerType=mt, markerSize=size, thickness=th)
    raster.draw_marker(b, p0, col, mt, size, th)


def _draw_ellipse(rs, a, b, col, h, w):
    box = ((float(rs.uniform(-15, w + 15)), float(rs.uniform(-15, h + 15))),
           (float(rs.uniform(0, 70)), float(rs.uniform(0, 70))),
           float(rs.uniform(-180, 360)))
    th, lt = int(rs.choice([2, 3])), int(rs.choice([8, -1]))
    cv2.ellipse(a, box, col, th, lt)
    raster.ellipse(b, box, col, th)


CALLS = {"line": _draw_line, "arrowed_line": _draw_arrow,
         "draw_marker": _draw_marker, "ellipse_outline": _draw_ellipse}


@pytest.mark.parametrize("kind", ["f64_rgba", "u8_rgb"])
@pytest.mark.parametrize("call", list(CALLS))
def test_raster_call_bit_equal_to_cv2(call, kind):
    rs = np.random.RandomState(sorted(CALLS).index(call) * 2
                               + (kind == "u8_rgb"))
    for _ in range(150):
        h, w = (int(v) for v in rs.randint(4, 72, 2))
        a, col = _canvas(kind, h, w, rs)
        b = a.copy()
        CALLS[call](rs, a, b, col, h, w)
        np.testing.assert_array_equal(b, a)


def test_demo_marker_and_arrow_at_full_size():
    """The renderer's own calls at 512^2: the size-20, thickness-5
    triangle and a thickness-2 arrow with an 8-pixel tip, near borders."""
    for p0, p1 in (((256, 256), (300, 200)), ((3, 509), (508, 2)),
                   ((-5, 40), (40, -5))):
        a = np.zeros((512, 512, 4))
        b = a.copy()
        cv2.drawMarker(a, p0, (0, 0, 255, 255), markerType=5, markerSize=20,
                       thickness=5)
        raster.draw_marker(b, p0, (0, 0, 255, 255), 5, 20, 5)
        seg = np.sqrt((p1[0] - p0[0]) ** 2 + (p1[1] - p0[1]) ** 2)
        cv2.arrowedLine(a, p0, p1, (0, 0, 255, 255), 2, tipLength=8 / seg)
        raster.arrowed_line(b, p0, p1, (0, 0, 255, 255), 2, 8 / seg)
        np.testing.assert_array_equal(b, a)


def test_alpha_composite_bit_equal_to_pil():
    rs = np.random.RandomState(0)
    for _ in range(40):
        h, w = rs.randint(1, 40, 2)
        d = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
        s = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
        s[rs.rand(h, w) < 0.3, 3] = 0
        s[rs.rand(h, w) < 0.2, 3] = 255
        d[rs.rand(h, w) < 0.3, 3] = 0
        want = np.asarray(Image.alpha_composite(Image.fromarray(d),
                                                Image.fromarray(s)))
        np.testing.assert_array_equal(raster.alpha_composite(d, s), want)
    with pytest.raises(ValueError):
        raster.alpha_composite(np.zeros((2, 2, 4), np.uint8),
                               np.zeros((2, 2, 3), np.uint8))


# ---------------------------------------------------------------------------
# the renderer vs the JAX renderer
# ---------------------------------------------------------------------------

def _entry(e):
    return [[list(e[0]), list(e[1]), e[2]], [0, 0], "move"]


def tracking_states(size, seed):
    """Seeded (name, tracking_points, ellipse_lists) cases."""
    rs = np.random.RandomState(seed)
    out = []
    for n_points in (0, 1, 2, 5):
        c = rs.uniform(0.2, 0.8, 2) * size
        e0 = ((float(c[0]), float(c[1])),
              (float(rs.uniform(20, 80)), float(rs.uniform(60, 140))),
              float(rs.uniform(0, 180)))
        pts = [[int(c[0]), int(c[1])]]
        ents = [_entry(e0)]
        for _ in range(max(n_points - 1, 0)):
            d = rs.randint(-60, 61, 2)
            pts.append([pts[-1][0] + int(d[0]), pts[-1][1] + int(d[1])])
            ents.append(_entry(((float(pts[-1][0]), float(pts[-1][1])),
                                e0[1], e0[2])))
        out.append((f"{n_points}_points", pts[:n_points], ents))
    # repeated points: duplicates are dropped from the polyline
    out.append(("repeated", [[100, 100], [100, 100], [150, 120], [150, 120],
                             [170, 90]],
                [_entry(((100.0, 100.0), (40.0, 80.0), 30.0)),
                 _entry(((170.0, 90.0), (40.0, 80.0), 30.0))]))
    # degenerate start (compositional add): the placeholder 1e-5 axes
    out.append(("degenerate_start", [[128, 128], [60, 200]],
                [_entry(((128.0, 128.0), (1e-5, 1e-5), 0.0)),
                 _entry(((60.0, 200.0), (70.0, 50.0), 45.0))]))
    # across the border, points off the canvas
    out.append(("border", [[5, 5], [-20, size + 10], [size - 2, 3]],
                [_entry(((5.0, 5.0), (90.0, 150.0), 120.0)),
                 _entry(((float(size - 2), 3.0), (90.0, 150.0), 120.0))]))
    return out


SIZE = 256
STATES = tracking_states(SIZE, 0)


@pytest.mark.parametrize("name", [s[0] for s in STATES])
def test_renderer_bit_equal_to_jax(name):
    _, pts, ents = next(s for s in STATES if s[0] == name)
    rs = np.random.RandomState(len(name))
    orig = rs.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)
    cur = jui._ellipse(ents[-1][0])
    np.testing.assert_array_equal(tui.blob_vis_exact(cur, SIZE, SIZE),
                                  jui.blob_vis_exact(cur, SIZE, SIZE))
    t = tui.render_tracking_ui(orig, pts, ents, SIZE, SIZE)
    j = jui.render_tracking_ui(orig, pts, ents, SIZE, SIZE)
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for e in (ents[0][0], ents[-1][0]):
        tg = tui.render_ori_gallery(orig, e, SIZE, SIZE)
        jg = jui.render_ori_gallery(orig, e, SIZE, SIZE)
        for k in jg:
            np.testing.assert_array_equal(tg[k], jg[k], err_msg=k)


def test_blob_vis_exact_non_square_and_palette():
    pal = np.random.RandomState(1).rand(4, 3).astype(np.float32)
    e = ((70.0, 30.0), (40.0, 90.0), 75.0)
    np.testing.assert_array_equal(tui.blob_vis_exact(e, 96, 160, pal),
                                  jui.blob_vis_exact(e, 96, 160, pal))


# ---------------------------------------------------------------------------
# the scorer on demo directories written from the JAX renderer
# ---------------------------------------------------------------------------

def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.asarray(arr)).save(path)


def write_demo_dir(d, orig, pts, ents):
    """A demo state directory whose artifacts are the JAX renderer's."""
    os.makedirs(os.path.join(d, "state"), exist_ok=True)
    with open(os.path.join(d, "state", "state.json"), "w") as f:
        json.dump({"tracking_points": pts, "ellipse_lists": ents,
                   "scene_prompt": "", "remove_blob_box": False}, f)
    h, w = orig.shape[:2]
    _save(os.path.join(d, "input_image", "input_image.png"), orig)
    ui = jui.render_tracking_ui(orig, pts, ents, h, w)
    _save(os.path.join(d, "editable_blob", "editable_blob.png"),
          ui["editable_blob"])
    _save(os.path.join(d, "edited_result_gallery",
                       "edited_result_gallery_0.png"), ui["edited_background"])
    _save(os.path.join(d, "edited_result_gallery",
                       "edited_result_gallery_1.png"), ui["edited_mask"])
    start = jui._ellipse(ents[0][0])
    src = ents[1][0] if jui._is_degenerate(start) else ents[0][0]
    g = jui.render_ori_gallery(orig, src, h, w)
    for idx, key in ((0, "ellipse_overlay"), (1, "ellipse_masked"),
                     (2, "ellipse_mask"), (3, "ellipse_mask"),
                     (4, "ellipse_masked")):
        _save(os.path.join(d, "ori_result_gallery",
                           f"ori_result_gallery_{idx}.png"), g[key])


@pytest.fixture(scope="module")
def demo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo"))
    rs = np.random.RandomState(4)
    for name, pts, ents in STATES:
        orig = rs.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)
        write_demo_dir(os.path.join(root, name), orig, pts, ents)
    return root


def test_scorer_rows_match_jax(demo_root, monkeypatch):
    got = tui.score_ui_all(demo_root)
    monkeypatch.setattr(jui, "webp_cache_roundtrip", lambda img: np.asarray(
        img))
    want = jui.score_ui_all(demo_root)
    assert list(got) == list(want) and len(got) == len(STATES)
    for name in want:
        assert list(got[name]) == list(want[name]), name
        for art, row in want[name].items():
            assert row["exact"] and row["hops"] == 1, (name, art)
            assert got[name][art] == dict(row, hops=0), (name, art)
    # the compose state scores its ellipse-derived indices 1 and 2 too
    assert "ori_1_ellipse_masked" in got["degenerate_start"]
    assert "ori_1_ellipse_masked" not in got["2_points"]
    summary = tui.print_ui_score_table(got)
    n = sum(len(r) for r in got.values())
    assert summary == {"metric": "ui_golden_pixels_vs_reference",
                       "artifacts_scored": n, "artifacts_bit_exact": n}


def test_scorer_reports_a_wrong_artifact(demo_root, tmp_path):
    """A recorded artifact one level off is scored, not exact."""
    import shutil
    d = str(tmp_path / "state")
    shutil.copytree(os.path.join(demo_root, "5_points"), d)
    p = os.path.join(d, "editable_blob", "editable_blob.png")
    arr = np.asarray(Image.open(p).convert("RGB")).copy()
    arr[10, 10, 0] ^= 1
    Image.fromarray(arr).save(p)
    rows = tui.score_demo_ui(d)
    assert not rows["editable_blob"]["exact"]
    assert rows["editable_blob"]["max_abs"] == 1
    assert rows["edited_background"]["exact"]


def test_scorer_reads_jpeg_recorded_input(demo_root, tmp_path):
    """The scorer reads artifacts through the port's decoders: a state
    whose input image is stored as JPEG bytes (in the .png name, as a
    sniffing reader allows) scores against the JPEG's decoded pixels."""
    import shutil
    d = str(tmp_path / "state")
    shutil.copytree(os.path.join(demo_root, "0_points"), d)
    buf = io.BytesIO()
    p = os.path.join(d, "input_image", "input_image.png")
    Image.open(p).save(buf, "JPEG", quality=90)
    with open(p, "wb") as f:
        f.write(buf.getvalue())
    rows = tui.score_demo_ui(d)
    assert rows["editable_blob"]["exact"]          # independent of the input
    assert not rows["edited_background"]["exact"]  # the JPEG's pixels differ
