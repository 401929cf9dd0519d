"""Shared noise-schedule math, host-side numpy (counterpart of
``blobctrl_tpu/schedulers/common.py``; diffusers' beta schedules)."""

from __future__ import annotations

import numpy as np


def make_betas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012) -> np.ndarray:
    """SD-1.5's "scaled_linear" schedule."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                       num_train_timesteps, dtype=np.float64) ** 2


def alphas_cumprod_from_betas(betas: np.ndarray) -> np.ndarray:
    # float32 cumprod, as torch computes it in the reference scheduler
    return np.cumprod(1.0 - betas.astype(np.float32), dtype=np.float32)


def make_timesteps(num_inference_steps: int,
                   num_train_timesteps: int = 1000) -> np.ndarray:
    """Descending "linspace"-spaced sampling timesteps."""
    ts = np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
    return ts.round()[::-1][:-1].astype(np.int64)
