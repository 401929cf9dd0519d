"""Blob edit-op state machine, decoupled from any UI (counterpart of
``blobctrl_tpu/blob/editor.py``).

The edit state is a list of
(ellipse, (resize_ar, resize_long, resize_short, rotation), edit_type)
tuples with edit_type in
{0: init, 1: move, 2: resize-AR, 3: resize-long-axis, 4: resize-short-axis,
 5: rotate}. Every op appends a new entry; undo pops; reset truncates to the
initial entry.

Ellipses are cv2-style: ((xc, yc), (d1, d2), angle_deg).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from blobctrl_torch.utils import resample

Ellipse = Tuple[Tuple[float, float], Tuple[float, float], float]

EDIT_INIT = 0
EDIT_MOVE = 1
EDIT_RESIZE_AR = 2
EDIT_RESIZE_LONG = 3
EDIT_RESIZE_SHORT = 4
EDIT_ROTATE = 5

MIN_BLOB_AREA = 1600.0
EXCEED_THRESHOLD = 0.4


def is_point_in_ellipse(point: Tuple[float, float], ellipse: Ellipse) -> bool:
    """Whether ``point`` lies inside the ellipse (its axes rotated by the
    ellipse's angle)."""
    (xc, yc), (d1, d2), angle = ellipse
    theta = math.radians(angle)
    x, y = point[0] - xc, point[1] - yc
    xr = x * math.cos(theta) - y * math.sin(theta)
    yr = x * math.sin(theta) + y * math.cos(theta)
    return (xr * xr) / ((d1 / 2) ** 2) + (yr * yr) / ((d2 / 2) ** 2) <= 1.0


def ellipse_vertices(ellipse: Ellipse) -> np.ndarray:
    """The four axis endpoints of the ellipse."""
    (xc, yc), (d1, d2), angle = ellipse
    rad = math.radians(angle)
    rot = np.array([[math.cos(rad), -math.sin(rad)],
                    [math.sin(rad), math.cos(rad)]])
    v = np.array([[d1 / 2, 0], [-d1 / 2, 0], [0, d2 / 2], [0, -d2 / 2]])
    return v @ rot.T + np.array([xc, yc])


def move_ellipse(ellipse: Ellipse, delta: Tuple[float, float]) -> Ellipse:
    (xc, yc), axes, angle = ellipse
    return ((xc + delta[0], yc + delta[1]), axes, angle)


def resize_ellipse(ellipse: Ellipse, factor: float, height: int, width: int,
                   resize_type: int = 0) -> Tuple[Ellipse, float, List[str]]:
    """Area/bounds-constrained resize. resize_type: 0 = both axes (AR-preserving), 1 = long axis (d2),
    2 = short axis (d1). Returns (ellipse, adjusted_factor, warnings)."""
    (xc, yc), (d1, d2), angle = ellipse
    warnings: List[str] = []
    too_big = too_small = False
    # the bounds and min-area constraints can conflict (tiny blob at a
    # canvas corner): the +/-0.1 loop would then ping-pong forever, so it
    # is bounded
    for _ in range(100):
        if resize_type == 0:
            rd1, rd2 = d1 * factor, d2 * factor
        elif resize_type == 1:
            rd1, rd2 = d1, d2 * factor
        else:
            rd1, rd2 = d1 * factor, d2
        resized = ((xc, yc), (rd1, rd2), angle)
        if factor == 1:
            break
        verts = ellipse_vertices(resized) / np.array([width, height])
        if np.all(verts >= -EXCEED_THRESHOLD) and np.all(verts <= 1 + EXCEED_THRESHOLD):
            area = math.pi * (rd1 / 2) * (rd2 / 2)
            if area >= MIN_BLOB_AREA:
                break
            too_small = True
            factor += 0.1
            if area < 1e-6:
                break
        else:
            too_big = True
            factor -= 0.1
    else:
        warnings.append("resize constraints conflict (blob pinned near the "
                        "canvas edge); keeping the last attempted size")
    if too_big:
        warnings.append(f"blob too big; factor reduced to {factor:.2f} "
                        f"(allowed overshoot {EXCEED_THRESHOLD})")
    if too_small:
        warnings.append(f"blob too small; factor raised to {factor:.2f} "
                        f"(min area {MIN_BLOB_AREA:.0f} px)")
    return resized, factor, warnings


def rotate_ellipse(ellipse: Ellipse, degrees: float) -> Ellipse:
    (xc, yc), axes, angle = ellipse
    return ((xc, yc), axes, (angle + degrees) % 180.0)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Convex hull of integer (x, y) points, collinear points dropped (as
    ``cv2.convexHull`` returns it), counter-clockwise from the lowest x."""
    pts = sorted(set(map(tuple, np.asarray(points).tolist())))
    if len(pts) <= 2:
        return np.asarray(pts, np.int64).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def fit_ellipse(points: np.ndarray) -> Ellipse:
    """OpenCV's ``fitEllipse`` (the algebraic least-squares fit it runs by
    default) in float64 over float32 points: a conic fit for the center,
    a re-fit of the quadratic terms about it, then the axes and angle."""
    p = np.asarray(points, np.float32).reshape(-1, 2)
    n = len(p)
    if n < 5:
        raise ValueError("fitting an ellipse needs at least 5 points")
    c = np.zeros(2, np.float32)
    for q in p:                       # float32 running sum, as cv2 sums
        c += q
    c /= np.float32(n)
    d = p - c
    s = float(np.sum(np.abs(d[:, 0]).astype(np.float64)
                     + np.abs(d[:, 1]).astype(np.float64)))
    eps32 = float(np.finfo(np.float32).eps)
    scale = 100.0 / (s if s > eps32 else eps32)

    def conic(d):
        px, py = d[:, 0].astype(np.float64) * scale, d[:, 1].astype(
            np.float64) * scale
        return np.stack([-px * px, -py * py, -px * py, px, py], 1)

    a = conic(d)
    w = np.linalg.svd(a, compute_uv=False)
    if w[0] * eps32 > w[4]:
        # near-degenerate: cv2 nudges each point by +-eps and refits
        e = np.float32(s / (n * 2) * 1e-3)
        i = np.arange(n)
        ofs = np.stack([((i & 1) * 2 - 1), ((i & 2) - 1)], 1).astype(
            np.float32) * e
        p = (p + ofs).astype(np.float32)
        d = p - c
        a = conic(d)
    gfp = np.linalg.lstsq(a, np.full(n, 10000.0), rcond=None)[0]
    rp = np.linalg.lstsq(np.array([[2 * gfp[0], gfp[2]],
                                   [gfp[2], 2 * gfp[1]]]),
                         gfp[3:5], rcond=None)[0]
    px = d[:, 0].astype(np.float64) * scale - rp[0]
    py = d[:, 1].astype(np.float64) * scale - rp[1]
    gfp = np.linalg.lstsq(np.stack([px * px, py * py, px * py], 1),
                          np.ones(n), rcond=None)[0]
    ang = -0.5 * math.atan2(gfp[2], gfp[1] - gfp[0])
    if abs(gfp[2]) <= 1e-8:
        # axis-aligned (or circular): cv2 reports angle 0 before its
        # width/height swap, not +-90 from the sign of a rounding-level
        # cross term
        ang = 0.0
    t = (gfp[2] / math.sin(-2.0 * ang) if abs(gfp[2]) > 1e-8
         else gfp[1] - gfp[0])
    r2 = abs(gfp[0] + gfp[1] - t)
    r2 = math.sqrt(2.0 / r2) if r2 > 1e-8 else r2
    r3 = abs(gfp[0] + gfp[1] + t)
    r3 = math.sqrt(2.0 / r3) if r3 > 1e-8 else r3
    f = np.float32
    cx = float(f(f(rp[0] / scale) + c[0]))
    cy = float(f(f(rp[1] / scale) + c[1]))
    w_, h_ = float(f(r2 * 2 / scale)), float(f(r3 * 2 / scale))
    angle = float(f(ang * 180 / math.pi))
    if w_ > h_:
        w_, h_ = h_, w_
        angle = float(f(90 + ang * 180 / math.pi))
    if 4 * gfp[0] * gfp[1] < gfp[2] * gfp[2]:
        # the fitted conic is no ellipse (a hyperbola): cv2 reports 0
        angle = 0.0
    if angle < -180:
        angle += 360
    if angle > 360:
        angle -= 360
    return ((cx, cy), (w_, h_), angle)


def ellipse_from_mask(mask: np.ndarray) -> Ellipse:
    """Binary mask -> the ellipse fitted to the convex hull of its
    foreground (the hull of the outer contours, as the JAX package takes
    it through cv2): each row's outermost foreground pixels span the
    hull."""
    m = np.asarray(mask) > 0
    rows = np.nonzero(m.any(1))[0]
    if len(rows) == 0:
        raise ValueError("mask has no foreground")
    first = m[rows].argmax(1)
    last = m.shape[1] - 1 - m[rows][:, ::-1].argmax(1)
    pts = np.concatenate([np.stack([first, rows], 1),
                          np.stack([last, rows], 1)])
    hull = convex_hull(pts)
    if len(hull) < 5:
        raise ValueError("mask region too small to fit an ellipse")
    return fit_ellipse(hull)


def object_region_on_canvas(image: np.ndarray, mask: np.ndarray,
                            canvas: int = 512) -> np.ndarray:
    """Crop the masked object, re-center it on a white canvas^2 background
    (the pipeline's fg_image); a crop larger than the canvas is shrunk
    with PIL's default (bicubic) resize."""
    img = np.asarray(image)
    m = np.asarray(mask) > 0
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        raise ValueError("empty mask")
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    crop = np.where(m[y0:y1, x0:x1, None], img[y0:y1, x0:x1], 255)
    h, w = crop.shape[:2]
    scale = min(1.0, canvas / max(h, w))
    if scale < 1.0:
        crop = resample.pil_resize(crop.astype(np.uint8),
                                   (max(1, int(w * scale)),
                                    max(1, int(h * scale))), "bicubic")
        h, w = crop.shape[:2]
    out = np.full((canvas, canvas, 3), 255, np.uint8)
    top, left = (canvas - h) // 2, (canvas - w) // 2
    out[top:top + h, left:left + w] = crop
    return out


@dataclasses.dataclass
class BlobEditor:
    """Multi-round edit session over one blob."""
    height: int
    width: int
    entries: List[Tuple[Ellipse, Tuple[float, float, float, float], int]] = \
        dataclasses.field(default_factory=list)

    @property
    def current(self) -> Ellipse:
        return self.entries[-1][0]

    @property
    def initial(self) -> Ellipse:
        return self.entries[0][0]

    def init_from_mask(self, mask: np.ndarray, inflate: float = 1.05):
        ellipse = ellipse_from_mask(mask)
        ellipse, _, _ = resize_ellipse(ellipse, inflate, self.height, self.width, 0)
        self.entries = [(ellipse, (1.0, 1.0, 1.0, 0.0), EDIT_INIT)]
        return ellipse

    def init_from_ellipse(self, ellipse: Ellipse):
        self.entries = [(ellipse, (1.0, 1.0, 1.0, 0.0), EDIT_INIT)]
        return ellipse

    def init_compositional(self, target: Ellipse):
        """Compositional add: a degenerate start ellipse plus the
        user-specified target."""
        (xc, yc), _, angle = target
        degenerate = ((xc, yc), (1e-5, 1e-5), angle)
        self.entries = [(degenerate, (1.0, 1.0, 1.0, 0.0), EDIT_INIT),
                        (target, (1.0, 1.0, 1.0, 0.0), EDIT_MOVE)]
        return target

    def _params(self) -> Tuple[float, float, float, float]:
        return self.entries[-1][1]

    def move(self, delta: Tuple[float, float]) -> Ellipse:
        e = move_ellipse(self.current, delta)
        self.entries.append((e, self._params(), EDIT_MOVE))
        return e

    def resize(self, factor: float, resize_type: int = 0) -> Tuple[Ellipse, List[str]]:
        e, f, warn = resize_ellipse(self.current, factor, self.height,
                                    self.width, resize_type)
        ar, lg, sh, rot = self._params()
        if resize_type == 0:
            ar = f
        elif resize_type == 1:
            lg = f
        else:
            sh = f
        etype = {0: EDIT_RESIZE_AR, 1: EDIT_RESIZE_LONG, 2: EDIT_RESIZE_SHORT}[resize_type]
        self.entries.append((e, (ar, lg, sh, rot), etype))
        return e, warn

    def resize_start(self, factor: float, resize_type: int = 0
                     ) -> Tuple[Ellipse, float, List[str]]:
        """Resize the START ellipse (entries[0]) in place: this changes the
        white-out source region of the edited background, not the target.
        Returns (ellipse, applied_factor, warnings) — the applied factor can
        be smaller than requested when the bounds/area constraints clamp it
        (callers that need an exact inverse restore must use it)."""
        e0, params0, _ = self.entries[0]
        e, applied, warn = resize_ellipse(e0, factor, self.height, self.width,
                                          resize_type)
        self.entries[0] = (e, params0, EDIT_INIT)
        return e, applied, warn

    def rotate(self, degrees: float) -> Ellipse:
        e = rotate_ellipse(self.current, degrees)
        ar, lg, sh, _ = self._params()
        self.entries.append((e, (ar, lg, sh, degrees), EDIT_ROTATE))
        return e

    def undo(self) -> Ellipse:
        if len(self.entries) > 1:
            self.entries.pop()
        return self.current

    def reset(self) -> Ellipse:
        self.entries = self.entries[:1]
        return self.current
