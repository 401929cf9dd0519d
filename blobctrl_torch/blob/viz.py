"""Blob visualization: composited score maps -> RGB images, ellipse
overlays and masks (counterpart of ``blobctrl_tpu/blob/viz.py``).

The blob view splats, colours and converts to uint8 at full resolution in
one launch of ``ops.blob_splat``'s kernel on the card; the ellipse rasters
are the port's own copy of OpenCV's (``blob/raster``), bit for bit.
"""

from __future__ import annotations

import colorsys
from typing import Optional, Tuple

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.blob import math as blob_math
from blobctrl_torch.blob import raster
from blobctrl_torch.ops import blob_splat

# The 29-entry visualization palette of the original demo (entry 0 the
# near-white background, entry 1 the first blob color).
BLOB_VIS_COLORS = np.array([
    [0.9804, 0.9451, 0.9176],
    [1.0, 0.494, 0.357],
    [0.961, 0.882, 0.827],
    [0.8980, 0.5255, 0.0235],
    [0.3647, 0.4118, 0.6941],
    [0.3216, 0.7373, 0.6392],
    [0.6000, 0.7882, 0.2706],
    [0.1843, 0.5412, 0.7686],
    [0.6471, 0.6667, 0.6000],
    [0.8549, 0.6471, 0.1059],
    [0.4627, 0.3059, 0.6235],
    [0.8000, 0.3804, 0.6902],
    [0.9294, 0.3922, 0.3529],
    [0.1412, 0.4745, 0.4235],
    [0.4000, 0.7725, 0.8000],
    [0.9647, 0.8118, 0.4431],
    [0.9725, 0.6118, 0.4549],
    [0.8627, 0.6902, 0.9490],
    [0.5294, 0.7725, 0.3725],
    [0.6196, 0.7255, 0.9529],
    [0.9961, 0.5333, 0.6941],
    [0.7882, 0.8588, 0.4549],
    [0.5451, 0.8784, 0.6431],
    [0.7059, 0.5922, 0.9059],
    [0.7020, 0.7020, 0.7020],
    [0.5216, 0.3608, 0.4588],
    [0.8510, 0.6863, 0.4196],
    [0.6863, 0.3922, 0.3451],
    [0.4510, 0.4353, 0.298],
], dtype=np.float32)


def default_palette(n: int = 29) -> np.ndarray:
    """(n, 3) float palette in [0,1]. The first 29 entries are the
    reference's BLOB_VIS_COLORS table; beyond that (more blobs than the
    reference ever renders) the palette extends with evenly spaced hues."""
    if n <= len(BLOB_VIS_COLORS):
        return BLOB_VIS_COLORS[:n]
    colors = list(BLOB_VIS_COLORS)
    for i in range(n - len(BLOB_VIS_COLORS)):
        h = (i * 0.61803398875) % 1.0
        s = 0.55 + 0.25 * ((i * 7) % 3) / 2.0
        v = 0.75 + 0.2 * ((i * 5) % 2)
        colors.append(colorsys.hsv_to_rgb(h, min(s, 1.0), min(v, 1.0)))
    return np.asarray(colors, np.float32)


def blob_vis_image(xs, ys, covs, sizes, viz_hw: Tuple[int, int],
                   palette: Optional[np.ndarray] = None,
                   device="cuda") -> np.ndarray:
    """Splat blobs at full resolution on ``device`` and color them:
    (H, W, 3) uint8 of image 0. Routed by shape as the JAX package routes
    its splat: large grids whose width is a multiple of 128 take
    ``ops.blob_splat.blob_view`` (one kernel launch on the card, after one
    upload of the inputs and colours; the plain version on the CPU), the
    rest the pure splat of ``blob.math``."""
    dev = resolve_device(device)
    h, w = viz_hw
    xs = np.asarray(xs, np.float32)
    m = xs.shape[1]
    pal = palette if palette is not None else default_palette()
    if h * w >= 128 * 128 and w % 128 == 0:
        parts = (xs[0], ys[0], covs[0], sizes[0], pal[:m + 1])
        buf = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.float32).ravel() for a in parts])).to(dev)
        xs_t, ys_t, covs_t, sizes_t, colors = torch.split(
            buf, [m, m, 4 * m, m, buf.numel() - 7 * m])
        return blob_splat.blob_view(
            xs_t[None], ys_t[None], covs_t.view(1, m, 2, 2), sizes_t[None],
            viz_hw, colors.view(-1, 3)).cpu().numpy()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    d_scores = blob_math.splat_scores(t(xs), t(ys), t(covs), t(sizes),
                                      viz_hw)   # (N, H, W, M+1)
    colors = t(pal[:m + 1])[None]               # (1, M+1, 3)
    img = blob_math.splat_features_from_scores(d_scores, colors)
    arr = np.clip(img[0].cpu().numpy(), 0.0, 1.0)
    return (arr * 255).astype(np.uint8)


def blob_vis_from_ellipse(ellipse, width: int, height: int,
                          device="cuda") -> np.ndarray:
    mean, cov = blob_math.gaussian_from_ellipse(ellipse)
    nmean, ncov = blob_math.normalize_gaussian(mean, cov, width, height)
    return blob_vis_image(np.asarray([[nmean[0]]]), np.asarray([[nmean[1]]]),
                          np.asarray(ncov)[None, None], np.ones((1, 1)),
                          (height, width), device=device)


def draw_ellipse(image: np.ndarray, ellipse, color=(0, 255, 0),
                 thickness: int = 3) -> np.ndarray:
    """The ellipse's outline drawn over a copy-safe contiguous image."""
    out = np.ascontiguousarray(np.asarray(image))
    return raster.ellipse(out, ellipse, tuple(color), thickness)


def ellipse_mask(ellipse, height: int, width: int) -> np.ndarray:
    """Filled ellipse mask (H, W) uint8 in {0, 255}. The JAX package asks
    cv2 for LINE_AA on a float mask, where cv2 draws LINE_8; so does this."""
    m = np.zeros((height, width), np.float32)
    raster.ellipse(m, ellipse, 1.0, -1)
    return (m * 255).astype(np.uint8)


def composite_mask_and_image(mask: np.ndarray, image: np.ndarray,
                             masked_color=(0, 0, 0)) -> np.ndarray:
    """Replace masked pixels with a flat color (>0 for one-channel masks,
    a channel sum > 255 for RGB ones)."""
    mask = np.asarray(mask)
    image = np.asarray(image)
    if mask.ndim == 2:
        ind = (mask > 0).astype(np.uint8)
    else:
        ind = (mask.sum(-1) > 255).astype(np.uint8)
    out = image * (1 - ind[..., None]) + np.asarray(masked_color) * ind[..., None]
    return out.astype(np.uint8)
