"""Shared noise-schedule math, host-side numpy (counterpart of
``blobctrl_tpu/schedulers/common.py``; diffusers' beta schedules and
timestep spacings, so SD-1.5's configs sample as the reference does)."""

from __future__ import annotations

import numpy as np


def make_betas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012, beta_schedule: str = "scaled_linear"
               ) -> np.ndarray:
    """"linear", SD-1.5's "scaled_linear", or "squaredcos_cap_v2"."""
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps, dtype=np.float64)

        def f(x):
            return np.cos((x + 0.008) / 1.008 * np.pi / 2) ** 2
        return np.minimum(1 - f((t + 1) / num_train_timesteps)
                          / f(t / num_train_timesteps), 0.999)
    raise ValueError(beta_schedule)


def alphas_cumprod_from_betas(betas: np.ndarray) -> np.ndarray:
    # float32 cumprod, as torch computes it in the reference scheduler
    return np.cumprod(1.0 - betas.astype(np.float32), dtype=np.float32)


def validate_custom_timesteps(timesteps, num_train_timesteps: int = 1000
                              ) -> np.ndarray:
    """A custom sampling schedule -> (S,) int64: non-empty, strictly
    descending, within [0, num_train_timesteps)."""
    ts = np.asarray(timesteps, dtype=np.int64)
    if ts.ndim != 1 or ts.size == 0:
        raise ValueError(f"timesteps must be a non-empty 1-D sequence, "
                         f"got shape {ts.shape}")
    if not np.all(np.diff(ts) < 0):
        raise ValueError("custom timesteps must be strictly descending")
    if ts[0] >= num_train_timesteps or ts[-1] < 0:
        raise ValueError(f"custom timesteps must lie in "
                         f"[0, {num_train_timesteps}), got "
                         f"[{ts[-1]}, {ts[0]}]")
    return ts


def make_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                   spacing: str = "linspace", steps_offset: int = 0
                   ) -> np.ndarray:
    """Descending discrete sampling timesteps: "linspace", "leading",
    "leading_ddim" (DDIM's ratio over the step count) or "trailing"
    (Table 2 of arXiv:2305.08891)."""
    if spacing == "linspace":
        ts = np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
        return ts.round()[::-1][:-1].astype(np.int64)
    if spacing == "leading":
        step_ratio = num_train_timesteps // (num_inference_steps + 1)
        ts = (np.arange(0, num_inference_steps + 1)
              * step_ratio).round()[::-1][:-1]
        return ts.astype(np.int64) + steps_offset
    if spacing == "leading_ddim":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        return ts.astype(np.int64) + steps_offset
    if spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        ts = np.arange(num_train_timesteps, 0, -step_ratio).round()
        return ts.astype(np.int64) - 1
    raise ValueError(spacing)
