"""Gaussian blob splatting fused with back-to-front alpha compositing
(counterpart of ``blobctrl_tpu/ops/blob_splat.py``), and the blob view
built on it.

``csrc/blob_splat.cu`` replaces the Pallas ``_splat_kernel``: one launch
computes the parameter rows from the raw blob inputs, scores every pixel's
M blobs back to front and writes the composited layers channels-last, so
nothing of size M x H x W reaches device memory. Its view mode also
colours image 0 and converts it to uint8, the rest of the JAX package's
``blob_vis_image``. Each mode has its plain version here, in the kernel's
order of operations; the CPU runs it.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch

from blobctrl_torch.ops import _build

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (n, h, w, m, mode) -> launches

# the C entry point's modes
_MODES = {"scores": 0, "view": 1, "rows": 2}


def splat_params(xs: torch.Tensor, ys: torch.Tensor, covs: torch.Tensor,
                 sizes: torch.Tensor, score_hw: Tuple[int, int]
                 ) -> torch.Tensor:
    """(N, M) centers, (N, M, 2, 2) covariances, (N, M) sizes -> (N, M, 8)
    fp32 rows [cx*W, cy*H, d/det, -(b+c)/det, a/det, size >= 0.5, 0, 0]."""
    h, w = score_hw
    cov = covs.float()
    a, b = cov[..., 0, 0], cov[..., 0, 1]
    c, d = cov[..., 1, 0], cov[..., 1, 1]
    det = a * d - b * c
    zero = torch.zeros_like(a)
    return torch.stack([xs.float() * w, ys.float() * h, d / det,
                        -(b + c) / det, a / det,
                        (sizes.float() >= 0.5).float(), zero, zero],
                       -1).contiguous()


def _inv(n: int) -> torch.Tensor:
    """1/n rounded to fp32, as the kernel receives it."""
    return torch.tensor(1.0 / n, dtype=torch.float32)


def splat_scores_plain(params: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The plain version: the kernel's arithmetic step by step over whole
    images. params (N, M, 8) -> (N, H, W, M+1) fp32, slot 0 the
    background."""
    n, m = params.shape[:2]
    dev = params.device
    col = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    row = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    inv_w, inv_h = _inv(w).to(dev), _inv(h).to(dev)
    out = [None] * (m + 1)
    tail = torch.ones(n, h, w, dtype=torch.float32, device=dev)
    for k in range(m - 1, -1, -1):
        r = [params[:, k, i][:, None, None] for i in range(6)]
        dx = (col - r[0]) * inv_w
        dy = (row - r[1]) * inv_h
        d2 = r[2] * dx * dx + r[3] * dx * dy + r[4] * dy * dy
        s = torch.clamp(1.0 / (1.0 + torch.exp(d2)) * 2.0, max=1.0)
        s = torch.where(r[5] < 0.5, torch.full_like(s, 1e-6), s)
        out[k + 1] = s * tail
        tail = tail * (1.0 - s)
    out[0] = tail
    return torch.stack(out, -1)


def blob_view_plain(xs: torch.Tensor, ys: torch.Tensor, covs: torch.Tensor,
                    sizes: torch.Tensor, hw: Tuple[int, int],
                    colors: torch.Tensor) -> torch.Tensor:
    """The view mode's plain version, in the kernel's order: image 0's rows,
    its scores back to front, the colour sum over channels M, ..., 0, the
    clamp to [0, 1], x255 and the truncation -> (H, W, 3) uint8."""
    h, w = hw
    scores = splat_scores_plain(
        splat_params(xs[:1], ys[:1], covs[:1], sizes[:1], hw), h, w)[0]
    colors = colors.float()
    acc = torch.zeros(h, w, 3, dtype=torch.float32, device=scores.device)
    for c in range(scores.shape[-1] - 1, -1, -1):
        acc = acc + scores[..., c:c + 1] * colors[c]
    return (torch.clamp(acc, 0.0, 1.0) * 255.0).to(torch.uint8)


def _raw_inputs(name, xs, ys, covs, sizes):
    """The raw inputs as contiguous fp32 on one card (each one itself when
    it already is), and (n, m)."""
    if not xs.is_cuda:
        raise ValueError(f"{name}: inputs on {xs.device}; the kernel runs on "
                         f"the card")
    n, m = xs.shape
    dev = xs.device
    return ([_build.as_f32(t, dev, *shape) for t, shape in
             ((xs, (n, m)), (ys, (n, m)), (covs, (n, m, 2, 2)),
              (sizes, (n, m)))], n, m)


def _launch(mode, out, raw, rows, colors, n, m, h, w):
    """One launch of the kernel in ``mode``; raises if it fails."""
    global launches
    if min(n, m, h, w) < 1 or n > 65535 or h * w > 2 ** 31 - 1 - 256:
        raise ValueError(f"blob_splat: shape n={n} m={m} h={h} w={w}")
    ptrs = [t.data_ptr() for t in raw] if raw else [None] * 4
    rc = _build.entry("blob_splat")(
        *ptrs, None if rows is None else rows.data_ptr(),
        None if colors is None else colors.data_ptr(), out.data_ptr(), n, m,
        h, w, 1.0 / w, 1.0 / h, _MODES[mode], _build.stream(out.device))
    _build.check("blob_splat", rc)
    launches += 1
    launch_shapes[(n, h, w, m, mode)] += 1
    return out


def splat_from_params(params: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The op from parameter rows: (N, M, 8) -> (N, H, W, M+1) fp32
    composited score maps. CPU tensors take the plain version; a CUDA
    tensor launches the kernel or raises."""
    _build.refuse_grad("splat_from_params", "detach the blob inputs",
                       params)
    if params.device.type == "cpu":
        return splat_scores_plain(params, h, w)
    n, m = params.shape[:2]
    if not (params.is_cuda and params.dtype == torch.float32
            and params.is_contiguous() and params.shape[2:] == (8,)):
        raise ValueError(f"splat_from_params: params {tuple(params.shape)} "
                         f"{params.dtype} on {params.device}; the kernel "
                         f"takes contiguous fp32 (N, M, 8) on the card")
    out = torch.empty(n, h, w, m + 1, device=params.device,
                      dtype=torch.float32)
    return _launch("scores", out, None, params, None, n, m, h, w)


def splat_scores(xs: torch.Tensor, ys: torch.Tensor, covs: torch.Tensor,
                 sizes: torch.Tensor, score_hw: Tuple[int, int]
                 ) -> torch.Tensor:
    """Composited score maps (N, H, W, M+1) fp32 of M blobs per image (the
    contract of ``blob.math.splat_scores``). On the card one launch, rows
    and all; on the CPU the rows, then the plain version."""
    _build.refuse_grad("splat_scores", "detach the blob inputs",
                       xs, ys, covs, sizes)
    h, w = score_hw
    if xs.device.type == "cpu":
        return splat_scores_plain(splat_params(xs, ys, covs, sizes, score_hw),
                                  h, w)
    raw, n, m = _raw_inputs("splat_scores", xs, ys, covs, sizes)
    out = torch.empty(n, h, w, m + 1, device=xs.device, dtype=torch.float32)
    return _launch("scores", out, raw, None, None, n, m, h, w)


def splat_rows(xs: torch.Tensor, ys: torch.Tensor, covs: torch.Tensor,
               sizes: torch.Tensor, score_hw: Tuple[int, int]
               ) -> torch.Tensor:
    """The (N, M, 8) rows as the kernel computes them in its prologue (its
    rows mode, to check them against ``splat_params``); the CPU runs
    ``splat_params``."""
    _build.refuse_grad("splat_rows", "detach the blob inputs",
                       xs, ys, covs, sizes)
    if xs.device.type == "cpu":
        return splat_params(xs, ys, covs, sizes, score_hw)
    h, w = score_hw
    raw, n, m = _raw_inputs("splat_rows", xs, ys, covs, sizes)
    out = torch.empty(n, m, 8, device=xs.device, dtype=torch.float32)
    return _launch("rows", out, raw, None, None, n, m, h, w)


def blob_view(xs: torch.Tensor, ys: torch.Tensor, covs: torch.Tensor,
              sizes: torch.Tensor, hw: Tuple[int, int],
              colors: torch.Tensor) -> torch.Tensor:
    """The blob view of image 0: M blobs splatted at (H, W), composited and
    coloured by ``colors`` (M+1, 3), slot 0 the background -> (H, W, 3)
    uint8. On the card one launch; on the CPU ``blob_view_plain``."""
    _build.refuse_grad("blob_view", "detach the blob inputs",
                       xs, ys, covs, sizes, colors)
    if xs.device.type == "cpu":
        return blob_view_plain(xs, ys, covs, sizes, hw, colors)
    h, w = hw
    raw, _, m = _raw_inputs("blob_view", xs[:1], ys[:1], covs[:1],
                            sizes[:1])
    if tuple(colors.shape) != (m + 1, 3):
        raise ValueError(f"blob_view: colors {tuple(colors.shape)}, want "
                         f"({m + 1}, 3)")
    colors = _build.as_f32(colors, xs.device, m + 1, 3)
    out = torch.empty(h, w, 3, device=xs.device, dtype=torch.uint8)
    return _launch("view", out, raw, None, colors, 1, m, h, w)
