"""Gaussian blob splatting fused with back-to-front alpha compositing
(counterpart of ``blobctrl_tpu/ops/blob_splat.py``).

``csrc/blob_splat.cu`` replaces the Pallas ``_splat_kernel``: one thread
per output pixel scores the image's M blobs back to front and writes the
composited layers channels-last, so nothing of size M x H x W reaches
device memory. The parameter rows are built here in plain torch, as the
JAX package builds them in XLA.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch

from blobctrl_torch.ops import _build

launches = 0                               # kernel launches (plain calls excluded)
launch_shapes = collections.Counter()      # (n, h, w, m) -> launches


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


def splat_from_params(params: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The op: (N, M, 8) parameter rows -> (N, H, W, M+1) fp32 composited
    score maps. CPU tensors take the plain version; a CUDA tensor launches
    the kernel or raises."""
    global launches
    if params.device.type == "cpu":
        return splat_scores_plain(params, h, w)
    n, m = params.shape[:2]
    if not (params.is_cuda and params.dtype == torch.float32
            and params.is_contiguous() and params.shape[2:] == (8,)):
        raise ValueError(f"splat_from_params: params {tuple(params.shape)} "
                         f"{params.dtype} on {params.device}; the kernel "
                         f"takes contiguous fp32 (N, M, 8) on the card")
    if min(n, m, h, w) < 1 or n > 65535:
        raise ValueError(f"splat_from_params: shape n={n} m={m} h={h} w={w}")
    out = torch.empty(n, h, w, m + 1, device=params.device,
                      dtype=torch.float32)
    rc = _build.entry("blob_splat")(
        params.data_ptr(), out.data_ptr(), n, m, h, w, _inv(w).item(),
        _inv(h).item(), torch.cuda.current_stream(params.device).cuda_stream)
    _build.check("blob_splat", rc)
    launches += 1
    launch_shapes[(n, h, w, m)] += 1
    return out


def splat_scores(xs: torch.Tensor, ys: torch.Tensor, covs: torch.Tensor,
                 sizes: torch.Tensor, score_hw: Tuple[int, int]
                 ) -> torch.Tensor:
    """Composited score maps (N, H, W, M+1) fp32 of M blobs per image (the
    contract of ``blob.math.splat_scores``): the parameter rows, then the
    op."""
    h, w = score_hw
    return splat_from_params(splat_params(xs, ys, covs, sizes, score_hw),
                             h, w)


def splat_scores_auto(xs, ys, covs, sizes, score_hw):
    """The JAX package's routing rule, by shape alone: large grids whose
    width is a multiple of 128 go to the op above (kernel on the card,
    plain version on the CPU), the rest to ``blob.math.splat_scores``."""
    from blobctrl_torch.blob import math as blob_math
    h, w = score_hw
    if h * w >= 128 * 128 and w % 128 == 0:
        return splat_scores(xs, ys, covs, sizes, score_hw)
    return blob_math.splat_scores(xs, ys, covs, sizes, score_hw)
