"""Cheap latent-space RGB previews of in-flight denoise steps (counterpart
of ``blobctrl_tpu/pipeline/preview.py``).

The pipeline's read-only ``callback_on_step_end`` hands the host the raw
latents (64 KB at 512^2); this module maps them to a recognizable RGB
thumbnail with a fixed 4 -> 3 linear projection, the standard latent
preview of SD serving stacks (diffusers' ``latents_to_rgb``). The card does
no extra work beyond the copy of the latents at each preview step, which
``callback_interval`` bounds. The constants approximate the SD-1.5 VAE
decoder restricted to a 1x1 conv; previews are approximations by design,
the final image always comes from the VAE decode.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# 4 latent channels -> RGB, for SD-1.5-family latents in scheduler space
# (already multiplied by the 0.18215 scaling factor)
LATENT_RGB_FACTORS = np.array(
    [[0.298, 0.207, 0.208],
     [0.187, 0.286, 0.173],
     [-0.158, 0.189, 0.264],
     [-0.184, -0.271, -0.473]], dtype=np.float32)
# rgb = 0.5 * (x @ F) + 0.5: the projection lands roughly in [-1, 1]
LATENT_RGB_SCALE = np.float32(0.5)
LATENT_RGB_BIAS = np.float32(0.5)


def latent_to_rgb(latents: np.ndarray, out_width: Optional[int] = None,
                  upscale: int = 1) -> np.ndarray:
    """Scheduler-space latents (N, h, w, 4) (or (h, w, 4)) -> uint8 RGB
    (N, h * u, w' * u, 3). out_width: keep only the right-most columns, for
    raw double-width activations; default no crop. upscale: an integer
    nearest-neighbour upscale (8 restores the image's nominal size)."""
    x = np.asarray(latents, np.float32)
    if x.ndim == 3:
        x = x[None]
    if x.ndim != 4 or x.shape[-1] != 4:
        raise ValueError(f"expected (N, h, w, 4) latents, got {x.shape}")
    w = x.shape[2] if out_width is None else int(out_width)
    if not 1 <= w <= x.shape[2]:
        raise ValueError(f"out_width {w} outside 1..{x.shape[2]}")
    x = x[:, :, x.shape[2] - w:, :]
    rgb = (x @ LATENT_RGB_FACTORS) * LATENT_RGB_SCALE + LATENT_RGB_BIAS
    rgb = np.clip(rgb * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    u = int(upscale)
    if u > 1:
        rgb = rgb.repeat(u, axis=1).repeat(u, axis=2)
    return rgb
