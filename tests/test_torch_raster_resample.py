"""The port's host-side rasters and resizers against the libraries the JAX
package calls (cv2 and PIL, oracles here; the port imports neither):
filled ellipse masks and thickness-3 outlines bit for bit, the editor's
mask -> ellipse fit, the object crop, and PIL's and cv2's uint8
resizes bit for bit."""

import numpy as np
import pytest

from blobctrl_tpu.blob import editor as jeditor
from blobctrl_tpu.blob import viz as jviz
from blobctrl_torch.blob import editor as teditor
from blobctrl_torch.blob import raster
from blobctrl_torch.blob import viz as tviz
from blobctrl_torch.utils import resample

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")


def seeded_ellipses(seed, n, size):
    """n ellipses on a size^2 canvas: inside, at and over the edge, tiny
    (under 5 px), and the degenerate 1e-5 start of a compositional add."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        c = tuple(rng.uniform(-0.2, 1.2, 2) * size)
        ax = (rng.uniform(0, 0.8) * size, rng.uniform(0, 1.3) * size)
        if i % 8 == 1:
            ax = (rng.uniform(0, 4), rng.uniform(0, 6))
        if i % 8 == 2:
            ax = (1e-5, 1e-5)
        if i % 8 == 3:
            c = (rng.choice([0.0, size - 1.0, size * 1.0]), c[1])
        out.append((c, ax, float(rng.uniform(-20, 200))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_ellipse_mask_bit_equal(seed):
    """64 ellipses per seed, canvas 96 and 512x384 (masks are
    ``viz.ellipse_mask``: cv2 draws LINE_AA on the float mask as LINE_8)."""
    for i, e in enumerate(seeded_ellipses(seed, 64, 96)):
        h, w = (96, 96) if i % 2 else (384, 512)
        want = jviz.ellipse_mask(e, h, w)
        got = tviz.ellipse_mask(e, h, w)
        np.testing.assert_array_equal(got, want, err_msg=str(e))
        np.testing.assert_array_equal(
            got, jviz.ellipse_mask(e, h, w, antialias=False))


@pytest.mark.parametrize("seed", [2, 3])
def test_ellipse_outline_bit_equal(seed):
    """``draw_ellipse``: thickness 3, LINE_8, on an RGB uint8 image."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (96, 96, 3)).astype(np.uint8)
    for e in seeded_ellipses(seed, 48, 96):
        want = jviz.draw_ellipse(base.copy(), e)
        got = tviz.draw_ellipse(base.copy(), e)
        np.testing.assert_array_equal(got, want, err_msg=str(e))


def test_polygon_and_circle_primitives_bit_equal():
    """The fixed-point primitives under the ellipse: convex polygons
    (``cv2.fillConvexPoly``, shift 16) and thick segments (``cv2.line``
    thickness 3), including ones that leave the canvas."""
    rng = np.random.RandomState(5)
    for _ in range(60):
        n = rng.randint(3, 8)
        c, r = rng.uniform(-10, 74, 2), rng.uniform(0.3, 30)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        pts = (np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
               * 65536).astype(np.int64)
        a, b = np.zeros((64, 64), np.uint8), np.zeros((64, 64), np.uint8)
        cv2.fillConvexPoly(a, pts.astype(np.int32), 255, cv2.LINE_8, 16)
        raster.fill_convex_poly(b, [tuple(map(int, p)) for p in pts], 255)
        np.testing.assert_array_equal(b, a)
        p0 = tuple(int(v * 65536) for v in rng.uniform(-5, 69, 2))
        p1 = tuple(p0[k] + int(rng.uniform(-10, 10) * 65536) for k in (0, 1))
        a, b = np.zeros((64, 64), np.uint8), np.zeros((64, 64), np.uint8)
        cv2.line(a, p0, p1, 255, 3, cv2.LINE_8, 16)
        raster.thick_line(b, p0, p1, 255, 3, 3)
        np.testing.assert_array_equal(b, a)


def test_sine_table_matches_ellipse2poly():
    """OpenCV's sine table, read through ``cv2.ellipse2Poly`` at a huge
    radius (its integer points round the table's values times 1e8)."""
    r = 10 ** 8
    pts = cv2.ellipse2Poly((0, 0), (r, r), 0, 0, 360, 1)
    for k, (x, y) in enumerate(pts):
        assert (x, y) == (round(r * float(raster.SIN_TABLE[450 - k])),
                          round(r * float(raster.SIN_TABLE[k]))), k


def _fit_close(got, want):
    """Center and axes within 1e-4 px, the angle within 1e-3 degrees
    modulo 180 (and ignored for a circle, where it has no meaning)."""
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    if abs(want[1][0] - want[1][1]) > 1e-3 * want[1][1]:
        assert abs((got[2] - want[2] + 90.0) % 180.0 - 90.0) <= 1e-3, (
            got, want)


def test_ellipse_from_mask_matches_cv2():
    """48 ellipse masks, inside and over the canvas edge and small; the
    fit is the hull of the outer contours, as the JAX package takes it."""
    n = 0
    for e in seeded_ellipses(7, 64, 96):
        m = jviz.ellipse_mask(e, 96, 96)
        try:
            want = jeditor.ellipse_from_mask(m)
        except ValueError:
            with pytest.raises(ValueError):
                teditor.ellipse_from_mask(m)
            continue
        _fit_close(teditor.ellipse_from_mask(m), want)
        n += 1
    assert n >= 40


def test_convex_hull_drops_collinear_points():
    pts = np.array([[0, 0], [1, 1], [2, 2], [2, 0], [1, 0], [4, 4], [0, 4],
                    [0, 2]])
    want = cv2.convexHull(pts.astype(np.int32)).reshape(-1, 2)
    got = teditor.convex_hull(pts)
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple,
                                                          want.tolist()))


def test_object_region_on_canvas_matches_jax():
    """The crop re-centered on white, with and without the bicubic
    shrink of a crop larger than the canvas: bit-equal."""
    rng = np.random.RandomState(8)
    img = rng.randint(0, 256, (120, 90, 3)).astype(np.uint8)
    mask = jviz.ellipse_mask(((45, 60), (70, 110), 10.0), 120, 90)
    for canvas in (128, 64):
        np.testing.assert_array_equal(
            teditor.object_region_on_canvas(img, mask, canvas),
            jeditor.object_region_on_canvas(img, mask, canvas))


@pytest.mark.parametrize("src,dst,filt", [
    ((512, 512), (256, 256), "bicubic"),    # DINOv2's preprocess
    ((512, 683), (256, 341), "bicubic"),
    ((97, 131), (53, 71), "lanczos"),       # an odd size, down
    ((37, 53), (64, 64), "lanczos"),        # and up
    ((64, 64), (30, 64), "bicubic"),
    ((512, 512), (1024, 1024), "bilinear"),  # SAM's ResizeLongestSide
    ((480, 640), (768, 1024), "bilinear"),
    ((1000, 700), (1024, 717), "bilinear"),
    ((97, 131), (53, 71), "bilinear"),      # down: the support widens
])
def test_pil_resize_bit_equal(src, dst, filt):
    img = np.random.RandomState(sum(src)).randint(
        0, 256, src + (3,)).astype(np.uint8)
    f = {"bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS,
         "bilinear": Image.BILINEAR}[filt]
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], f))
    np.testing.assert_array_equal(resample.pil_resize(img, dst[::-1], filt),
                                  want)


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (512, 683)),   # the session's 640x480 -> 512 short side
    ((640, 480), (683, 512)),
    ((80, 120), (64, 96)),
    ((128, 128), (64, 64)),     # an exact 2x: cv2 switches to INTER_AREA
    ((100, 37), (213, 80)),
    ((33, 71), (20, 50)),
])
def test_cv2_resize_linear_bit_equal(src, dst):
    img = np.random.RandomState(sum(src)).randint(
        0, 256, src + (3,)).astype(np.uint8)
    want = cv2.resize(img, dst[::-1])
    np.testing.assert_array_equal(
        resample.cv2_resize_linear(img, dst[::-1]), want)
