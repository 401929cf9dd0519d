"""Ellipse rasters for the UI: the port's own copy of the OpenCV drawing
routines the JAX package calls through ``cv2.ellipse`` with a rotated rect
(filled masks, ``blob/viz.ellipse_mask``; thickness-3 outlines,
``blob/viz.draw_ellipse``).

Each follows OpenCV 4.x's drawing code step by step, in 16-bit fixed
point, so the pixels agree bit for bit with the cv2 the JAX package calls:

  * the rotated rect is read as float32, its angle rounded to whole
    degrees, its center and half-axes taken to 16-bit fixed point;
  * ``ellipse2poly`` walks the ellipse with OpenCV's 7-digit sine table in
    steps of 90/30/18/5 degrees chosen by the axis length;
  * a filled ellipse is that polygon through ``fill_convex_poly`` (its
    edges drawn by ``line2``, then the scanlines between them);
  * an outline of thickness > 1 is ``poly_line``: each segment a filled
    quadrilateral, each joint a filled circle of radius (thickness + 1) // 2
    (a ``lineType`` of -1 draws the same, as cv2 draws it);
  * ``line``, ``arrowed_line`` and ``draw_marker`` are ``cv2.line``,
    ``cv2.arrowedLine`` and ``cv2.drawMarker`` (cross and triangle-up) on
    integer points: thickness 1 the integer 8-connected ``LineIterator``
    walk, thicker lines the quadrilateral and the end circles above;
  * ``alpha_composite`` is PIL's ``Image.alpha_composite`` for uint8 RGBA,
    in the integer arithmetic of its ``AlphaComposite.c``.

Only the 8-connected line type is drawn. OpenCV draws LINE_AA only into
8-bit images; the JAX package asks for it on a float32 mask, where cv2
draws LINE_8 instead, so LINE_8 is what its masks hold.

Each call draws in place into float64 4-channel images (an RGBA colour, as
the tracking-point renderer draws) and into uint8 3-channel ones.
Host-side numpy, as in the JAX package: these are UI rasters, not device
work. Plain Python loops over edge pixels and scanlines (a 512^2 ellipse
takes milliseconds).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# sin(k degrees), k = 0..450, as OpenCV's table holds it: printed to seven
# decimals, read as float32
SIN_TABLE = np.array([float(f"{math.sin(math.radians(k)):.7f}")
                      for k in range(451)], np.float32)

Point = Tuple[int, int]


def _round(x) -> int:
    """cvRound: to nearest, ties to even."""
    return int(round(float(x)))


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# ---------------------------------------------------------------------------
# polygon of an ellipse
# ---------------------------------------------------------------------------

def ellipse2poly(center, axes, angle: int,
                 delta: int) -> List[Tuple[float, float]]:
    """OpenCV's double-precision ``ellipse2Poly`` over the full ellipse
    (0 to 360 degrees) in steps of ``delta``."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha, beta = float(SIN_TABLE[450 - angle]), float(SIN_TABLE[angle])
    pts = []
    for i in range(0, 360 + delta, delta):
        ang = min(i, 360)
        x = axes[0] * float(SIN_TABLE[450 - ang])
        y = axes[1] * float(SIN_TABLE[ang])
        pts.append((center[0] + x * alpha - y * beta,
                    center[1] + x * beta + y * alpha))
    return pts


def _fixed_box(box):
    """The rotated-rect overload's conversions: (center, half-axes) in
    16-bit fixed point and the angle in whole degrees."""
    (cx, cy), (w, h), ang = box
    f = np.float32
    cx, cy, w, h, ang = f(cx), f(cy), f(w), f(h), f(ang)

    def fixed(v, shift):
        i = _round(v)
        return (i << shift) + _round(f(f(v - f(i)) * f(1 << shift)))

    center = (fixed(cx, XY_SHIFT), fixed(cy, XY_SHIFT))
    axes = (fixed(w, XY_SHIFT - 1), fixed(h, XY_SHIFT - 1))
    return center, axes, _round(ang)


def _ellipse_ex(img, center: Point, axes: Point, angle: int, color,
                thickness: int):
    """OpenCV's ``EllipseEx`` for a full ellipse in fixed point: its polygon,
    then a filled convex polygon (thickness < 0) or a polyline."""
    axes = (abs(axes[0]), abs(axes[1]))
    delta = (max(axes) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v: List[Point] = []
    for x, y in ellipse2poly(center, axes, angle, delta):
        px = _round(x / XY_ONE) << XY_SHIFT
        py = _round(y / XY_ONE) << XY_SHIFT
        pt = (px + _round(x - px), py + _round(y - py))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [center, center]
    if thickness >= 0:
        poly_line(img, v, color, thickness)
    else:
        fill_convex_poly(img, v, color)


# ---------------------------------------------------------------------------
# lines and polygons (16-bit fixed point, 8-connected)
# ---------------------------------------------------------------------------

def clip_line(width: int, height: int, p1: List[int], p2: List[int]) -> bool:
    """OpenCV's ``clipLine`` on [0, width-1] x [0, height-1], in place;
    False when the segment misses the rectangle."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(*p1), code(*p2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            p1[0] += int((a - p1[1]) * (p2[0] - p1[0]) / (p2[1] - p1[1]))
            p1[1] = a
            c1 = (p1[0] < 0) + (p1[0] > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            p2[0] += int((a - p2[1]) * (p2[0] - p1[0]) / (p2[1] - p1[1]))
            p2[1] = a
            c2 = (p2[0] < 0) + (p2[0] > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                p1[1] += int((a - p1[0]) * (p2[1] - p1[1]) / (p2[0] - p1[0]))
                p1[0] = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                p2[1] += int((a - p2[0]) * (p2[1] - p1[1]) / (p2[0] - p1[0]))
                p2[0] = a
                c2 = 0
    return (c1 | c2) == 0


def _put(img, x: int, y: int, color):
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def line2(img, p0: Point, p1: Point, color):
    """OpenCV's ``Line2``: an 8-connected line between two fixed-point
    points, both ends drawn."""
    h, w = img.shape[:2]
    a, b = list(p0), list(p1)
    if not clip_line(w << XY_SHIFT, h << XY_SHIFT, a, b):
        return
    dx, dy = b[0] - a[0], b[1] - a[1]
    major_x = abs(dx) > abs(dy)
    if major_x:
        if dx < 0:
            a, b, dy = b, a, -dy
        step = _tdiv(dy << XY_SHIFT, abs(dx) | 1)
        ecount = (b[0] - a[0]) >> XY_SHIFT
    else:
        if dy < 0:
            a, b, dx = b, a, -dx
        step = _tdiv(dx << XY_SHIFT, abs(dy) | 1)
        ecount = (b[1] - a[1]) >> XY_SHIFT
    half = XY_ONE >> 1
    _put(img, (b[0] + half) >> XY_SHIFT, (b[1] + half) >> XY_SHIFT, color)
    if major_x:
        x, y = (a[0] + half) >> XY_SHIFT, a[1] + half
        for i in range(ecount + 1):
            _put(img, x + i, (y + i * step) >> XY_SHIFT, color)
    else:
        x, y = a[0] + half, (a[1] + half) >> XY_SHIFT
        for i in range(ecount + 1):
            _put(img, (x + i * step) >> XY_SHIFT, y + i, color)


def fill_convex_poly(img, v: List[Point], color):
    """OpenCV's ``FillConvexPoly`` for LINE_8 with 16-bit fixed-point
    vertices: the edges by ``line2``, then each scanline between the left
    and the right edge."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        line2(img, p0, p, color)
        p0 = p
    xs_ = [p[0] for p in v]
    ys_ = [p[1] for p in v]
    imin = min(range(npts), key=lambda i: (ys_[i], i))
    xmin = (min(xs_) + delta) >> XY_SHIFT
    xmax = (max(xs_) + delta) >> XY_SHIFT
    ymin = (min(ys_) + delta) >> XY_SHIFT
    ymax = (max(ys_) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    e_idx, e_di = [imin, imin], [1, npts - 1]
    e_x, e_dx, e_ye = [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0 = e_idx[i]
                idx = idx0 + e_di[i]
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e_ye[i] = ty
                        e_dx[i] = _tdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += e_di[i]
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + delta) >> XY_SHIFT
            xx2 = (e_x[right] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def thick_line(img, p0: Point, p1: Point, color, thickness: int,
               flags: int):
    """OpenCV's ``ThickLine`` (thickness > 1, LINE_8): the segment as a
    filled quadrilateral, and filled circles at the ends that ``flags``
    names (1: p0, 2: p1), on the rounded end points."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > 2.220446049250313e-16:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy),
                               (p0[0] - dpx, p0[1] - dpy),
                               (p1[0] - dpx, p1[1] - dpy),
                               (p1[0] + dpx, p1[1] + dpy)], color)
    for i in range(2):
        if flags & (i + 1):
            half = XY_ONE >> 1
            circle(img, ((p0[0] + half) >> XY_SHIFT,
                         (p0[1] + half) >> XY_SHIFT),
                   (thickness + half) >> XY_SHIFT, color)
        p0 = p1


def circle(img, center: Point, radius: int, color):
    """OpenCV's ``Circle`` filled (integer center and radius): the
    midpoint walk, one horizontal span for each of its rows."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def span(y, x1, x2):
        if 0 <= y < h and x2 >= 0 and x1 < w:
            img[y, max(x1, 0):min(x2, w - 1) + 1] = color

    while dx >= dy:
        if cx - dx < w and cx + dx >= 0 and cy - dx < h and cy + dx >= 0:
            span(cy - dy, cx - dx, cx + dx)
            span(cy + dy, cx - dx, cx + dx)
            span(cy - dx, cx - dy, cx + dy)
            span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def poly_line(img, v: List[Point], color, thickness: int):
    """OpenCV's open ``PolyLine`` for thickness > 1 (the outlines drawn
    here): caps at both ends of the first segment, then at each next end."""
    if thickness <= 1:
        raise NotImplementedError("only outlines thicker than 1 px are "
                                  "drawn by the callers of this module")
    flags = 3
    for p0, p in zip(v, v[1:]):
        thick_line(img, p0, p, color, thickness, flags)
        flags = 2


# ---------------------------------------------------------------------------
# the cv2.ellipse(img, rotated_rect, color, thickness) call
# ---------------------------------------------------------------------------

def ellipse(img: np.ndarray, box, color, thickness: int = 1) -> np.ndarray:
    """``cv2.ellipse(img, ((cx, cy), (w, h), angle), color, thickness)``
    with LINE_8, drawn in place: filled for thickness < 0, else an outline
    (thickness > 1; cv2 draws a ``lineType`` of -1 there as LINE_8)."""
    if box[1][0] < 0 or box[1][1] < 0:
        raise ValueError(f"negative ellipse size {box[1]}")
    center, axes, angle = _fixed_box(box)
    _ellipse_ex(img, center, axes, angle, color, thickness)
    return img


# ---------------------------------------------------------------------------
# cv2.line / cv2.arrowedLine / cv2.drawMarker on integer points
# ---------------------------------------------------------------------------

def _line_iter(img, p0: Point, p1: Point, color):
    """OpenCV's ``Line``: the 8-connected ``LineIterator`` walk from the
    left end point, after ``clipLine`` to the image."""
    h, w = img.shape[:2]
    a, b = [int(p0[0]), int(p0[1])], [int(p1[0]), int(p1[1])]
    if not (0 <= a[0] < w and 0 <= b[0] < w and 0 <= a[1] < h
            and 0 <= b[1] < h):
        if not clip_line(w, h, a, b):
            return
    dx, dy = b[0] - a[0], b[1] - a[1]
    if dx < 0:                      # left to right
        a, b, dx, dy = b, a, -dx, -dy
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = a
    for _ in range(dx + 1):
        img[y, x] = color
        step_minor = err < 0
        err += -2 * dy + (2 * dx if step_minor else 0)
        if vert:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0


def line(img: np.ndarray, p0: Point, p1: Point, color,
         thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p0, p1, color, thickness)`` (LINE_8, integer points),
    in place."""
    if not 0 < thickness <= 32767:
        raise ValueError(f"line thickness {thickness} out of range")
    if thickness == 1:
        _line_iter(img, p0, p1, color)
        return img
    # cv2 5.0 first clips the segment to the image grown by the thickness
    # on every side (integer clipLine), then draws it from the clipped ends
    h, w = img.shape[:2]
    t = thickness
    a = [int(p0[0]) + t, int(p0[1]) + t]
    b = [int(p1[0]) + t, int(p1[1]) + t]
    if not clip_line(w + 2 * t, h + 2 * t, a, b):
        return img
    thick_line(img, ((a[0] - t) << XY_SHIFT, (a[1] - t) << XY_SHIFT),
               ((b[0] - t) << XY_SHIFT, (b[1] - t) << XY_SHIFT), color,
               thickness, 3)
    return img


def arrowed_line(img: np.ndarray, p0: Point, p1: Point, color,
                 thickness: int = 1, tip_length: float = 0.1) -> np.ndarray:
    """``cv2.arrowedLine``: the line, then the two tip strokes from points
    ``tip_length`` times the line's length away from ``p1`` at +-45
    degrees, rounded half to even as cvRound rounds."""
    tip = math.sqrt(float(p0[0] - p1[0]) ** 2
                    + float(p0[1] - p1[1]) ** 2) * tip_length
    line(img, p0, p1, color, thickness)
    ang = math.atan2(float(p0[1] - p1[1]), float(p0[0] - p1[0]))
    for a in (ang + math.pi / 4, ang - math.pi / 4):
        p = (_round(p1[0] + tip * math.cos(a)),
             _round(p1[1] + tip * math.sin(a)))
        line(img, p, p1, color, thickness)
    return img


MARKER_CROSS, MARKER_TRIANGLE_UP = 0, 5


def draw_marker(img: np.ndarray, position: Point, color,
                marker_type: int = MARKER_CROSS, marker_size: int = 20,
                thickness: int = 1) -> np.ndarray:
    """``cv2.drawMarker`` for the cross and the upward triangle (the two
    markers the demo draws)."""
    x, y = int(position[0]), int(position[1])
    s = marker_size // 2
    if marker_type == MARKER_CROSS:
        segs = [((x - s, y), (x + s, y)), ((x, y - s), (x, y + s))]
    elif marker_type == MARKER_TRIANGLE_UP:
        segs = [((x - s, y + s), (x + s, y + s)), ((x + s, y + s), (x, y - s)),
                ((x, y - s), (x - s, y + s))]
    else:
        raise ValueError(f"marker type {marker_type} is not drawn here "
                         f"(cross {MARKER_CROSS}, triangle-up "
                         f"{MARKER_TRIANGLE_UP})")
    for a, b in segs:
        line(img, a, b, color, thickness)
    return img


# ---------------------------------------------------------------------------
# PIL's Image.alpha_composite
# ---------------------------------------------------------------------------

def alpha_composite(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``Image.alpha_composite(dst, src)`` on (H, W, 4) uint8 RGBA arrays:
    ``AlphaComposite.c``'s integer blend (7 extra bits, divisions by 255
    rounded by its shift form); pixels where ``src`` is transparent are
    ``dst`` unchanged."""
    if dst.shape != src.shape or dst.shape[-1] != 4:
        raise ValueError(f"alpha_composite takes two (H, W, 4) images of "
                         f"one size, got {dst.shape} and {src.shape}")
    d = dst.astype(np.uint64)
    s = src.astype(np.uint64)
    sa, da = s[..., 3:], d[..., 3:]
    blend = da * (255 - sa)
    outa255 = sa * 255 + blend
    safe = np.maximum(outa255, 1)
    coef1 = sa * 255 * 255 * (1 << 7) // safe
    coef2 = 255 * (1 << 7) - coef1

    def div255(a):
        return ((a >> 8) + a) >> 8

    rgb = div255(s[..., :3] * coef1 + d[..., :3] * coef2 + (0x80 << 7)) >> 7
    alpha = div255(outa255 + 0x80)
    out = np.concatenate([rgb, alpha], -1).astype(np.uint8)
    return np.where(sa == 0, dst, out)
