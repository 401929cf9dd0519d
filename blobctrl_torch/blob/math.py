"""Blob math: ellipse <-> Gaussian, Gaussian splatting to score maps and
depth-ordered alpha compositing, feature splatting (counterpart of
``blobctrl_tpu/blob/math.py``).

Conventions: ellipses are cv2-style ((xc, yc), (d1, d2), angle_deg) with
d1 <= d2 the full axis lengths and angle_deg the clockwise angle of the
short axis; normalized Gaussians have their mean in [0, 1]^2 and their
covariance divided by the squared image diagonal; score maps are
channels-last (N, H, W, M+1) with slot 0 the background layer.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from blobctrl_torch.nn import layers


def rotation_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, s], [-s, c]])


def ellipse_to_gaussian(x: float, y: float, a: float, b: float,
                        theta: float) -> Tuple[np.ndarray, np.ndarray]:
    """(center, semi-minor a, semi-major b, ccw major-axis angle theta) ->
    (mean(2,), cov(2,2)); the off-diagonal sign flip is the image
    convention (y down)."""
    mean = np.array([x, y], dtype=np.float64)
    cov = np.array([[b * b, 0.0], [0.0, a * a]])
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    cov = rot @ cov @ rot.T
    cov[0, 1] *= -1.0
    cov[1, 0] *= -1.0
    return mean, cov


def gaussian_to_ellipse(mean: np.ndarray, cov: np.ndarray
                        ) -> Tuple[float, float, float, float, float]:
    """Inverse of ellipse_to_gaussian: (x, y, a, b, angle_deg) with
    angle_deg the clockwise angle of the SHORT axis in [0, 180). The
    eigenpairs come from ``eigh`` of the symmetrized matrix, so they stay
    real on near-degenerate covariances."""
    x, y = float(mean[0]), float(mean[1])
    cov = np.asarray(cov, dtype=np.float64)
    eigenvalues, eigenvectors = np.linalg.eigh((cov + cov.T) / 2.0)
    eigenvalues = np.maximum(eigenvalues, 0.0)
    b = float(np.sqrt(np.max(eigenvalues)))
    a = float(np.sqrt(np.min(eigenvalues)))
    min_vec = eigenvectors[:, int(np.argmin(eigenvalues))]
    angle = math.degrees(math.atan2(min_vec[1], min_vec[0]))
    if angle < 0:
        angle += 180.0
    return x, y, a, b, angle


def short_axis_angle_to_major_theta(angle_clockwise_short_axis: float) -> float:
    """cv2 fitEllipse angle (clockwise short axis, degrees) -> ccw
    major-axis angle in radians."""
    anti_short = (180.0 - angle_clockwise_short_axis) % 180.0
    return math.radians((anti_short + 90.0) % 180.0)


def gaussian_from_ellipse(ellipse) -> Tuple[np.ndarray, np.ndarray]:
    """cv2-style ellipse -> (mean, cov) in pixels."""
    (xc, yc), (d1, d2), angle = ellipse
    return ellipse_to_gaussian(xc, yc, d1 / 2.0, d2 / 2.0,
                               short_axis_angle_to_major_theta(angle))


def normalize_gaussian(mean: np.ndarray, cov: np.ndarray, width: int,
                       height: int) -> Tuple[np.ndarray, np.ndarray]:
    nmean = np.asarray(mean, dtype=np.float64) / np.array([width, height])
    diag2 = float(width) ** 2 + float(height) ** 2
    return nmean, np.asarray(cov, dtype=np.float64) / diag2


def ellipse_from_normalized_gaussian(mean, cov, width: int, height: int):
    """Normalized (mean, cov) -> cv2-style pixel ellipse."""
    x, y, a, b, angle = gaussian_to_ellipse(np.asarray(mean), np.asarray(cov))
    diag = math.sqrt(width ** 2 + height ** 2)
    return ((x * width, y * height), (2 * a * diag, 2 * b * diag), angle)


def composite_scores(scores: torch.Tensor) -> torch.Tensor:
    """Back-to-front alpha compositing over the last axis:
    d_k = s_k * prod_{j>k} (1 - s_j)."""
    tail = torch.flip(torch.cumprod(torch.flip(1.0 - scores, [-1]), -1), [-1])
    shifted = torch.cat([tail[..., 1:], torch.ones_like(tail[..., :1])], -1)
    return scores * shifted


def splat_scores(xs: torch.Tensor, ys: torch.Tensor, covs: torch.Tensor,
                 sizes: torch.Tensor, score_hw: Tuple[int, int]) -> torch.Tensor:
    """Splat M Gaussians into composited score maps (the plain version).

    xs, ys: (N, M) normalized centers; covs: (N, M, 2, 2) normalized
    covariances; sizes: (N, M), a blob with size < 0.5 is gated off.
    Returns (N, H, W, M+1) fp32, slot 0 the background layer."""
    h, w = score_hw
    f32 = torch.float32
    dev = xs.device
    gx = torch.arange(w, dtype=f32, device=dev)
    gy = torch.arange(h, dtype=f32, device=dev)
    dx = (gx[None, None, :] - (xs.float() * w)[..., None]) / w   # (N,M,W)
    dy = (gy[None, None, :] - (ys.float() * h)[..., None]) / h   # (N,M,H)
    cov = covs.float()
    a, b = cov[..., 0, 0], cov[..., 0, 1]
    c, d = cov[..., 1, 0], cov[..., 1, 1]
    det = a * d - b * c
    inv_a, inv_b, inv_c, inv_d = d / det, -b / det, -c / det, a / det
    d2 = (inv_a[..., None, None] * (dx * dx)[:, :, None, :]
          + (inv_b + inv_c)[..., None, None] * dy[..., :, None]
          * dx[:, :, None, :]
          + inv_d[..., None, None] * (dy * dy)[..., :, None])   # (N,M,H,W)
    scores = torch.clamp(torch.sigmoid(-d2) * 2.0, max=1.0)
    gate = (sizes.float() < 0.5)[:, :, None, None]
    scores = torch.where(gate, torch.full_like(scores, 1e-6), scores)
    scores = scores.movedim(1, -1)                              # (N,H,W,M)
    scores = torch.cat([torch.ones_like(scores[..., :1]), scores], -1)
    return composite_scores(scores)


def splat_features_from_scores(scores: torch.Tensor, features: torch.Tensor,
                               size: Optional[int] = None) -> torch.Tensor:
    """scores (N, H, W, M), features (N, M, C) -> (N, H, W, C), the scores
    first bilinearly resized to size x size when ``size`` is given."""
    if size and scores.shape[1] != size:
        scores = layers.bilinear_resize(scores, size, size)
    return torch.einsum("nhwm,nmc->nhwc", scores, features.to(scores.dtype))


def pyramid_resize(img: torch.Tensor, cutoff: int) -> Dict[int, torch.Tensor]:
    """Bilinear half-resolution pyramid of a square NHWC image keyed by
    its spatial size, down to ``cutoff``, on the image's device."""
    out = {img.shape[2]: img}
    while img.shape[2] > cutoff:
        s = img.shape[2] // 2
        img = layers.bilinear_resize(img, s, s)
        out[s] = img
    return out


def removal_score(score_hw: Tuple[int, int]) -> torch.Tensor:
    """Score map of the remove mode: background 1, the blob 0,
    (1, h, w, 2) fp32 on the CPU."""
    h, w = score_hw
    return torch.stack([torch.ones(1, h, w), torch.zeros(1, h, w)], -1)


def blob_scores_from_ellipses(ellipses, width: int, height: int,
                              score_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2-style pixel ellipses -> (1, h, w, M+1) [bg, fg_1..fg_M]
    composited score map: the pipeline's ``gs_score`` (CPU tensor)."""
    gauss = [normalize_gaussian(*gaussian_from_ellipse(e), width, height)
             for e in ellipses]
    m = len(gauss)
    xs = torch.tensor([[g[0][0] for g in gauss]], dtype=torch.float32)
    ys = torch.tensor([[g[0][1] for g in gauss]], dtype=torch.float32)
    covs = torch.tensor(np.stack([g[1] for g in gauss]),
                        dtype=torch.float32)[None]
    return splat_scores(xs, ys, covs, torch.ones(1, m), score_hw)


def blob_score_from_ellipse(ellipse, width: int, height: int,
                            score_hw: Tuple[int, int]) -> torch.Tensor:
    """One cv2-style pixel ellipse -> (1, h, w, 2) [bg, fg] score map."""
    return blob_scores_from_ellipses([ellipse], width, height, score_hw)
