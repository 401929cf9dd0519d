"""DPM-Solver++ multistep sampler family (counterpart of
``blobctrl_tpu/schedulers/dpm.py``; diffusers' DPMSolverMultistepScheduler):

  * algorithm_type "dpmsolver++" (deterministic, the SD config) and
    "sde-dpmsolver++" (stochastic);
  * solver_type "midpoint" (default) and "heun";
  * use_karras_sigmas (the rho-7 sigma ramp of Karras et al. 2022);
  * solver_order 1 or 2, lower_order_final, final_sigmas_type zero or
    sigma_min, custom timesteps.

Every scalar is precomputed on the host in float64 and read rounded to fp32.
The update of every variant is one fused form with a one-deep history:

  x <- c_x[i] * x - c_0[i] * m0 - c_1[i] * (m0 - m1) + c_n[i] * noise

m0 the x0-prediction at step i (epsilon -> x0 through conv_a/conv_s), and
c_n = 0 for the deterministic algorithm.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from blobctrl_torch.schedulers import common


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    timesteps: np.ndarray   # (S,) int64, descending
    conv_a: np.ndarray      # (S,) float64: alpha for eps -> x0
    conv_s: np.ndarray      # (S,) sigma for eps -> x0
    c_x: np.ndarray
    c_0: np.ndarray
    c_1: np.ndarray
    c_n: np.ndarray         # the noise coefficient; zero when deterministic
    stochastic: bool = False

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def coef(self, name: str, i: int) -> float:
        """Table entry rounded to fp32, the precision the step computes in."""
        return float(np.float32(getattr(self, name)[i]))


def _sigma_to_t(sigma: float, log_sigmas: np.ndarray) -> float:
    """Invert the training sigma table: a continuous t by log-sigma
    interpolation (diffusers' ``_sigma_to_t``)."""
    log_sigma = np.log(max(sigma, 1e-10))
    dists = log_sigma - log_sigmas
    low_idx = int(np.clip(np.cumsum(dists >= 0).argmax(), 0,
                          len(log_sigmas) - 2))
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = float(np.clip((low - log_sigma) / (low - high), 0.0, 1.0))
    return (1.0 - w) * low_idx + w * high_idx


def karras_sigmas(sigma_min: float, sigma_max: float, n: int,
                  rho: float = 7.0) -> np.ndarray:
    """The Karras et al. 2022 sigma ramp, descending from sigma_max."""
    ramp = np.linspace(0, 1, n)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def make(num_inference_steps: int, num_train_timesteps: int = 1000,
         beta_start: float = 0.00085, beta_end: float = 0.012,
         beta_schedule: str = "scaled_linear", solver_order: int = 2,
         lower_order_final: bool = True, spacing: str = "linspace",
         steps_offset: int = 0, final_sigmas_type: str = "zero",
         algorithm_type: str = "dpmsolver++", solver_type: str = "midpoint",
         use_karras_sigmas: bool = False, timesteps=None) -> DPMSchedule:
    if algorithm_type not in ("dpmsolver++", "sde-dpmsolver++"):
        raise ValueError(f"unknown algorithm_type {algorithm_type!r}")
    if solver_type not in ("midpoint", "heun"):
        raise ValueError(f"unknown solver_type {solver_type!r}")
    sde = algorithm_type == "sde-dpmsolver++"
    betas = common.make_betas(num_train_timesteps, beta_start, beta_end,
                              beta_schedule)
    acp = common.alphas_cumprod_from_betas(betas).astype(np.float64)
    all_sigmas = np.sqrt((1.0 - acp) / acp)

    if timesteps is not None:
        if use_karras_sigmas:
            raise ValueError("custom timesteps cannot be combined with "
                             "Karras sigmas")
        ts = common.validate_custom_timesteps(timesteps, num_train_timesteps)
        if len(ts) != num_inference_steps:
            raise ValueError(f"num_inference_steps={num_inference_steps} but "
                             f"{len(ts)} custom timesteps were given")
        sigmas = np.interp(ts, np.arange(len(all_sigmas)), all_sigmas)
    elif use_karras_sigmas:
        log_sigmas = np.log(all_sigmas)
        sigmas = karras_sigmas(float(all_sigmas[0]), float(all_sigmas[-1]),
                               num_inference_steps)
        ts = np.array([round(_sigma_to_t(s, log_sigmas)) for s in sigmas],
                      dtype=np.int64)
    else:
        ts = common.make_timesteps(num_inference_steps, num_train_timesteps,
                                   spacing, steps_offset)
        sigmas = np.interp(ts, np.arange(len(all_sigmas)), all_sigmas)
    S = len(ts)
    sigma_last = 0.0 if final_sigmas_type == "zero" else float(all_sigmas[0])
    sigmas = np.concatenate([sigmas, [sigma_last]])

    def a_s(sig):
        a = 1.0 / np.sqrt(sig * sig + 1.0)
        return a, sig * a

    def lam(sig):
        a, s = a_s(sig)
        with np.errstate(divide="ignore"):
            return np.log(a) - np.log(s)

    t = {name: np.zeros(S) for name in ("conv_a", "conv_s", "c_x", "c_0",
                                        "c_1", "c_n")}
    lower_order_nums = 0
    for i in range(S):
        t["conv_a"][i], t["conv_s"][i] = a_s(sigmas[i])
        alpha_t, sigma_t = a_s(sigmas[i + 1])
        sigma_s = a_s(sigmas[i])[1]
        h = lam(sigmas[i + 1]) - lam(sigmas[i])
        if sde:
            em2h = np.exp(-2.0 * h)
            t["c_x"][i] = sigma_t / sigma_s * np.exp(-h)
            t["c_0"][i] = -alpha_t * (1.0 - em2h)
            t["c_n"][i] = sigma_t * np.sqrt(max(1.0 - em2h, 0.0))
        else:
            t["c_x"][i] = sigma_t / sigma_s
            t["c_0"][i] = alpha_t * np.expm1(-h)
        order = min(solver_order, lower_order_nums + 1)
        if lower_order_final:
            order = min(order, S - i)
        if order >= 2:
            r0 = (lam(sigmas[i]) - lam(sigmas[i - 1])) / h
            if sde:
                if solver_type == "midpoint":
                    t["c_1"][i] = (-0.5 * alpha_t * (1.0 - np.exp(-2.0 * h))
                                   / r0)
                else:
                    t["c_1"][i] = -alpha_t * ((1.0 - np.exp(-2.0 * h))
                                              / (-2.0 * h) + 1.0) / r0
            elif solver_type == "midpoint":
                t["c_1"][i] = alpha_t * np.expm1(-h) * 0.5 / r0
            else:
                t["c_1"][i] = -alpha_t * (np.expm1(-h) / h + 1.0) / r0
        # the final step with sigma 0: h = inf; zero what is not finite
        for name in ("c_1", "c_x", "c_n"):
            if not np.isfinite(t[name][i]):
                t[name][i] = 0.0
        lower_order_nums = min(lower_order_nums + 1, solver_order)
    return DPMSchedule(timesteps=ts, stochastic=sde, **t)


def init_state(sched: DPMSchedule, sample: torch.Tensor):
    """(sample, the previous x0 prediction)."""
    return sample, torch.zeros_like(sample, dtype=torch.float32)


def step(sched: DPMSchedule, i: int, model_output: torch.Tensor, state,
         noise: Optional[torch.Tensor] = None):
    """One multistep update; ``noise`` (standard normal, sample-shaped) is
    required when the schedule is stochastic and ignored otherwise."""
    sample, m1 = state
    c = sched.coef
    x = sample.float()
    m0 = (x - c("conv_s", i) * model_output.float()) / c("conv_a", i)
    new_x = c("c_x", i) * x - c("c_0", i) * m0 - c("c_1", i) * (m0 - m1)
    if sched.stochastic:
        if noise is None:
            raise ValueError("sde-dpmsolver++ needs the step's noise")
        new_x = new_x + c("c_n", i) * noise.float()
    return new_x.to(sample.dtype), m0


def final_sample(state) -> torch.Tensor:
    return state[0]
