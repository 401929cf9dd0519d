"""DDIM sampler (counterpart of ``blobctrl_tpu/schedulers/ddim.py``;
diffusers' DDIMScheduler with epsilon prediction and clip_sample off, the
SD-1.5 configuration, for any eta).

``make`` precomputes every per-step scalar on the host in float64; the step
reads each rounded to fp32 and is two multiply-adds in fp32:

  x0 = (x - s_t[i] * eps) / a_t[i]
  x <- c_x0[i] * x0 + c_eps[i] * eps + sigma[i] * noise
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from blobctrl_torch.schedulers import common


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    timesteps: np.ndarray   # (S,) int64, descending
    a_t: np.ndarray         # (S,) float64: sqrt(alphas_cumprod[t])
    s_t: np.ndarray         # (S,) sqrt(1 - alphas_cumprod[t])
    c_x0: np.ndarray        # (S,)
    c_eps: np.ndarray       # (S,)
    sigma: np.ndarray       # (S,) the eta-scaled DDIM variance
    eta: float = 0.0

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def coef(self, name: str, i: int) -> float:
        """Table entry rounded to fp32, the precision the step computes in."""
        return float(np.float32(getattr(self, name)[i]))


def make(num_inference_steps: int, num_train_timesteps: int = 1000,
         beta_start: float = 0.00085, beta_end: float = 0.012,
         beta_schedule: str = "scaled_linear", spacing: str = "leading_ddim",
         steps_offset: int = 1, set_alpha_to_one: bool = False,
         eta: float = 0.0, timesteps=None) -> DDIMSchedule:
    betas = common.make_betas(num_train_timesteps, beta_start, beta_end,
                              beta_schedule)
    acp = common.alphas_cumprod_from_betas(betas).astype(np.float64)
    final_acp = 1.0 if set_alpha_to_one else float(acp[0])
    if timesteps is not None:
        # a custom schedule: each step's previous timestep is the next
        # element, the last step's is the final alpha
        ts = common.validate_custom_timesteps(timesteps, num_train_timesteps)
        if len(ts) != num_inference_steps:
            raise ValueError(f"num_inference_steps={num_inference_steps} but "
                             f"{len(ts)} custom timesteps were given")
        prev_ts = np.concatenate([ts[1:], [-1]])
    else:
        ts = common.make_timesteps(num_inference_steps, num_train_timesteps,
                                   spacing, steps_offset)
        prev_ts = ts - num_train_timesteps // num_inference_steps
    acp_t = acp[ts]
    acp_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)],
                        final_acp)
    variance = (1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)
    sigma = eta * np.sqrt(np.maximum(variance, 0.0))
    return DDIMSchedule(
        timesteps=ts, a_t=np.sqrt(acp_t), s_t=np.sqrt(1.0 - acp_t),
        c_x0=np.sqrt(acp_prev),
        c_eps=np.sqrt(np.maximum(1.0 - acp_prev - sigma ** 2, 0.0)),
        sigma=sigma, eta=eta)


def step(sched: DDIMSchedule, i: int, model_output: torch.Tensor,
         sample: torch.Tensor, noise: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """One DDIM step; ``noise`` (standard normal, sample-shaped) is required
    when eta > 0."""
    c = sched.coef
    eps = model_output.float()
    x0 = (sample - c("s_t", i) * eps) / c("a_t", i)
    out = c("c_x0", i) * x0 + c("c_eps", i) * eps
    if sched.eta > 0.0:
        if noise is None:
            raise ValueError("DDIM with eta > 0 needs the step's noise")
        out = out + c("sigma", i) * noise.float()
    return out.to(sample.dtype)


def training_tables(num_train_timesteps: int = 1000,
                    beta_start: float = 0.00085, beta_end: float = 0.012,
                    beta_schedule: str = "scaled_linear"):
    """(sqrt_acp, sqrt_1m_acp), each (num_train_timesteps,) float32 numpy:
    the forward process's lookup tables for training, from the fp32
    cumulative product taken in float64 and rounded to fp32 last (the JAX
    package's ``training_tables``, bit-equal)."""
    betas = common.make_betas(num_train_timesteps, beta_start, beta_end,
                              beta_schedule)
    acp = common.alphas_cumprod_from_betas(betas).astype(np.float64)
    return (np.sqrt(acp).astype(np.float32),
            np.sqrt(1.0 - acp).astype(np.float32))


def add_noise(sqrt_acp: torch.Tensor, sqrt_1m_acp: torch.Tensor,
              t: torch.Tensor, sample: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """The forward process q(x_t | x_0) for training: sqrt_acp[t] * x0 +
    sqrt_1m_acp[t] * noise, per batch row, the tables indexed by train
    timestep t (B,)."""
    a = sqrt_acp[t][:, None, None, None]
    s = sqrt_1m_acp[t][:, None, None, None]
    return a * sample + s * noise
