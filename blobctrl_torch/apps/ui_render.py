"""Pixel-exact re-rendering of the demo's recorded UI artifacts
(counterpart of ``blobctrl_tpu/apps/ui_render.py``).

Every recorded demo state (``<demo>/state/state.json``) carries
weight-independent pixel goldens made from blob math and 2-D drawing alone:

  * ``editable_blob/editable_blob.png``: the blob view with the
    tracking-point marker/arrow overlay and the current-ellipse outline;
  * ``edited_result_gallery/edited_result_gallery_{0,1}.png``: the edited
    background (start ellipse -> white, edited ellipse -> black) and the
    edited-ellipse mask;
  * ``ori_result_gallery_{0,3,4}.png``: the input with the start-ellipse
    outline, the start-ellipse mask, the start-ellipse-blacked input (and
    1-2 for compose states, whose gallery is ellipse-derived too).

This module renders them from a state's (tracking_points, ellipse_lists)
and scores them against the recorded PNGs. The drawing goes through the
port's bit-exact copies of the cv2 and PIL calls the JAX package makes
(``blob/raster``), and the blob view is the float64 host splat of
``blob_vis_exact``, so every output is bit-equal to the JAX renderer's.
It is host numpy, not device work (the card's blob view is ``blob/viz``).

``webp_cache_roundtrip`` is not ported: it needs a WebP codec. A PNG that
went through the demo's WebP cache therefore scores with ``hops`` 0 and
its raw difference here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from blobctrl_torch.blob import math as blob_math
from blobctrl_torch.blob import raster
from blobctrl_torch.blob import viz as viz_lib
from blobctrl_torch.utils import image

# Overlay colour (the demo's blue, RGBA) and start-point marker type
# (cv2.MARKER_TRIANGLE_UP).
_RGBA = (0, 0, 255, 255)
_MARKER_TYPE = raster.MARKER_TRIANGLE_UP


def _ellipse(entry) -> tuple:
    (c, axes, ang) = entry
    return ((float(c[0]), float(c[1])),
            (float(axes[0]), float(axes[1])), float(ang))


# ---------------------------------------------------------------------------
# float64 blob visualization
# ---------------------------------------------------------------------------

def blob_vis_exact(ellipse, height: int, width: int,
                   palette: Optional[np.ndarray] = None) -> np.ndarray:
    """Splat one blob at full resolution and colour it with the demo
    palette, in float64 end to end. Returns (H, W, 3) uint8 by
    truncation."""
    mean, cov = blob_math.gaussian_from_ellipse(ellipse)
    nmean, ncov = blob_math.normalize_gaussian(mean, cov, width, height)

    # Mahalanobis grid: integer pixel coordinates minus (x*W, y*H),
    # normalized per axis, solved against the covariance
    fx, fy = nmean[0] * width, nmean[1] * height
    gx = np.arange(width, dtype=np.float64)
    gy = np.arange(height, dtype=np.float64)
    dxg, dyg = np.meshgrid(gx - fx, gy - fy)  # (H, W) each
    delta = np.stack([dxg.ravel() / width, dyg.ravel() / height])
    sol = np.linalg.solve(np.asarray(ncov, np.float64), delta)
    d2 = (delta * sol).sum(0).reshape(height, width)

    with np.errstate(over="ignore"):      # exp overflow -> inf -> s == 0
        s = 1.0 / (1.0 + np.exp(d2))      # sigmoid(-d2)
    s = np.minimum(s * 2.0, 1.0)
    # two-layer alpha composite: [bg * (1 - fg), fg]
    d_bg, d_fg = 1.0 - s, s

    pal = (palette if palette is not None else viz_lib.BLOB_VIS_COLORS)
    c0 = pal[0].astype(np.float64)
    c1 = pal[1].astype(np.float64)
    img = d_bg[..., None] * c0 + d_fg[..., None] * c1
    return (img * 255.0).astype(np.uint8)


# ---------------------------------------------------------------------------
# the 'Editable Blob' view and the edited background
# ---------------------------------------------------------------------------

def render_editable_blob(tracking_points: Sequence[Sequence[int]],
                         ellipse_lists: Sequence,
                         height: int, width: int) -> np.ndarray:
    """The 'Editable Blob' view: blob splat + start marker + move polyline/
    arrow + current-ellipse outline."""
    current_ellipse = _ellipse(ellipse_lists[-1][0])

    sel_pix = np.zeros((height, width, 4))
    sel_ell = np.zeros((height, width, 4))

    tp = [list(map(int, p)) for p in tracking_points]
    if tp:
        raster.draw_marker(sel_pix, tp[0], _RGBA, _MARKER_TYPE, 20, 5)
    if len(tp) > 1:
        real: List[List[int]] = []
        for p in tp:
            if not real or p != real[-1]:
                real.append(p)
        for i in range(len(real) - 1):
            sp, ep = real[i], real[i + 1]
            seg = np.sqrt((ep[0] - sp[0]) ** 2 + (ep[1] - sp[1]) ** 2)
            if i == len(real) - 2:
                raster.arrowed_line(sel_pix, tuple(sp), tuple(ep), _RGBA, 2,
                                    8 / seg)
            else:
                raster.line(sel_pix, tuple(sp), tuple(ep), _RGBA, 2)

    # current-ellipse outline: thickness 2 (the JAX call's lineType -1
    # draws as LINE_8)
    raster.ellipse(sel_ell, current_ellipse, _RGBA, 2)

    bg = blob_vis_exact(current_ellipse, height, width)
    img = np.concatenate([bg, np.full((height, width, 1), 255, np.uint8)],
                         -1)
    img = raster.alpha_composite(img, sel_pix.astype(np.uint8))
    img = raster.alpha_composite(img, sel_ell.astype(np.uint8))
    return np.ascontiguousarray(img[..., :3])


def render_tracking_ui(original_image: np.ndarray,
                       tracking_points: Sequence[Sequence[int]],
                       ellipse_lists: Sequence,
                       height: int, width: int) -> Dict[str, np.ndarray]:
    """The 'Editable Blob' image and the edited-background gallery of a
    (tracking_points, ellipse_lists) state: uint8 arrays keyed
    editable_blob / edited_background / edited_mask."""
    start_ellipse = _ellipse(ellipse_lists[0][0])
    current_ellipse = _ellipse(ellipse_lists[-1][0])
    editable_blob = render_editable_blob(tracking_points, ellipse_lists,
                                         height, width)

    om = viz_lib.ellipse_mask(start_ellipse, height, width)
    em = viz_lib.ellipse_mask(current_ellipse, height, width)
    step1 = viz_lib.composite_mask_and_image(om, original_image,
                                             (255, 255, 255))
    edited_background = viz_lib.composite_mask_and_image(em, step1, (0, 0, 0))
    return {"editable_blob": editable_blob,
            "edited_background": edited_background,
            "edited_mask": em}


def render_ori_gallery(original_image: np.ndarray, ellipse,
                       height: int, width: int) -> Dict[str, np.ndarray]:
    """The ellipse-derived subset of ori_result_gallery: index 0 (green
    outline over the input), 3 (filled hard mask), 4 (mask-blacked input)."""
    overlay = np.ascontiguousarray(original_image.copy())
    raster.ellipse(overlay, _ellipse(ellipse), (0, 255, 0), 3)
    mask = np.zeros((height, width))
    raster.ellipse(mask, _ellipse(ellipse), 255, -1)
    mask = mask.astype(np.uint8)
    masked = viz_lib.composite_mask_and_image(mask, original_image, (0, 0, 0))
    return {"ellipse_overlay": overlay, "ellipse_mask": mask,
            "ellipse_masked": masked}


# ---------------------------------------------------------------------------
# scoring against the recorded PNGs
# ---------------------------------------------------------------------------

def _diff_stats(ours: np.ndarray, recorded: np.ndarray) -> Dict:
    """Diff a render against a recorded PNG. The JAX scorer first models
    1-4 re-encodes through the demo's WebP image cache; with no WebP codec
    here the render is compared as it is (``hops`` 0). On PNGs that never
    went through that cache (the ones a session writes) the two scorers
    agree: an exact render is exact either way."""
    a = np.asarray(ours)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    b = np.asarray(recorded)
    if b.ndim == 2:
        b = np.stack([b] * 3, axis=-1)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    mse = float(np.mean((d.astype(np.float64) / 255.0) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)
    return {"max_abs": int(d.max()), "frac_diff": float((d > 0).any(-1).mean()),
            "psnr_db": psnr, "hops": 0, "exact": bool(d.max() == 0)}


def _is_degenerate(ellipse) -> bool:
    (_, (d1, d2), _) = ellipse
    return max(float(d1), float(d2)) < 1e-3


def score_demo_ui(demo_dir: str) -> Dict:
    """Re-render one demo state's UI artifacts and diff them against the
    recorded PNGs (read through the port's decoders). Returns
    {artifact_name: diff stats}."""
    with open(os.path.join(demo_dir, "state", "state.json")) as f:
        state = json.load(f)
    original = image.read_image(os.path.join(demo_dir, "input_image",
                                             "input_image.png"))
    height, width = original.shape[:2]
    out = render_tracking_ui(original, state["tracking_points"],
                             state["ellipse_lists"], height, width)

    rows: Dict[str, Dict] = {}
    eb = os.path.join(demo_dir, "editable_blob", "editable_blob.png")
    if os.path.isfile(eb):
        rows["editable_blob"] = _diff_stats(out["editable_blob"],
                                            image.read_image(eb))
    g0 = os.path.join(demo_dir, "edited_result_gallery",
                      "edited_result_gallery_0.png")
    if os.path.isfile(g0):
        rows["edited_background"] = _diff_stats(out["edited_background"],
                                                image.read_image(g0))
    g1 = os.path.join(demo_dir, "edited_result_gallery",
                      "edited_result_gallery_1.png")
    if os.path.isfile(g1):
        rows["edited_mask"] = _diff_stats(out["edited_mask"],
                                          image.read_image(g1))

    # ori_result_gallery was last rendered from the start ellipse or, for
    # compose states whose start is the degenerate placeholder, from the
    # target ellipse; the session history is not recorded, so score
    # against the candidate that matches best
    candidates = [_ellipse(state["ellipse_lists"][0][0])]
    if _is_degenerate(candidates[0]) and len(state["ellipse_lists"]) > 1:
        candidates.append(_ellipse(state["ellipse_lists"][1][0]))
    galleries = [render_ori_gallery(original, e, height, width)
                 for e in candidates]
    indices = [(0, "ellipse_overlay"), (3, "ellipse_mask"),
               (4, "ellipse_masked")]
    if _is_degenerate(_ellipse(state["ellipse_lists"][0][0])):
        # compose states: indices 1-2 are ellipse-derived too
        indices += [(1, "ellipse_masked"), (2, "ellipse_mask")]
    for idx, key in indices:
        p = os.path.join(demo_dir, "ori_result_gallery",
                         f"ori_result_gallery_{idx}.png")
        if os.path.isfile(p):
            rec = image.read_image(p)
            stats = [_diff_stats(g[key], rec) for g in galleries]
            rows[f"ori_{idx}_{key}"] = min(stats,
                                           key=lambda s: s["max_abs"])
    return rows


def score_ui_all(demo_root: str,
                 names: Optional[List[str]] = None) -> Dict[str, Dict]:
    if names is None:
        names = sorted(
            n for n in os.listdir(demo_root)
            if os.path.isfile(os.path.join(demo_root, n, "state",
                                           "state.json")))
    return {n: score_demo_ui(os.path.join(demo_root, n)) for n in names}


def print_ui_score_table(results: Dict[str, Dict]) -> Dict:
    header = (f"{'state':<18} {'artifact':<22} {'exact':>5} {'hops':>4} "
              f"{'max':>4} {'diff%':>7} {'psnr':>8}")
    print(header)
    print("-" * len(header))
    n = n_exact = 0
    for name, arts in results.items():
        for art, s in arts.items():
            print(f"{name:<18} {art:<22} "
                  f"{'yes' if s['exact'] else 'NO':>5} {s['hops']:>4} "
                  f"{s['max_abs']:>4} {100 * s['frac_diff']:>6.3f} "
                  f"{s['psnr_db']:>8.2f}")
            n += 1
            n_exact += int(s["exact"])
    summary = {"metric": "ui_golden_pixels_vs_reference",
               "artifacts_scored": n, "artifacts_bit_exact": n_exact}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=(
        "Score the weight-independent recorded UI goldens (blob view, "
        "edited backgrounds, ellipse masks) against the port's renderer"))
    p.add_argument("--demo_root", default="assets/results/demo")
    p.add_argument("--name", action="append", default=None)
    args = p.parse_args()
    print_ui_score_table(score_ui_all(args.demo_root, args.name))
