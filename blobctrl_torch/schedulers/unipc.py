"""UniPC multistep sampler (counterpart of ``blobctrl_tpu/schedulers/unipc.py``
in its default configuration: order 2, bh2, predict_x0, epsilon prediction,
lower_order_final).

Every scalar of UniPC's predictor and corrector depends only on the
timestep schedule, never on data, so ``make`` precomputes them on the host
in float64 into per-step tables. ``step`` is then a handful of
multiply-adds over a history of K model outputs, in fp32:

  corrector (i > 0): x <- cc_x[i]*x_last - cc_m0[i]*m_prev
                          - cc_B[i]*(sum_j cc_hist[i,j]*(hist_j - m_prev)
                                     + cc_mt[i]*(m_t - m_prev))
  predictor:         x <- cp_x[i]*x - cp_m0[i]*m_t
                          - cp_B[i]*(sum_j cp_hist[i,j]*(hist_j - m_t))

Three precisions stay apart: float64 tables, rounded once to fp32 as the
step reads them; fp32 scheduler state; the nets' own dtype for the model
output, which the step casts to fp32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from blobctrl_torch.schedulers import common


@dataclasses.dataclass(frozen=True)
class UniPCSchedule:
    timesteps: np.ndarray   # (S,) int64, descending
    solver_order: int
    conv_a: np.ndarray      # (S,) float64: alpha_t at sigmas[i]
    conv_s: np.ndarray      # (S,) sigma_t at sigmas[i]
    cc_x: np.ndarray        # corrector tables; row 0 unused (no corrector)
    cc_m0: np.ndarray
    cc_B: np.ndarray
    cc_mt: np.ndarray
    cc_hist: np.ndarray     # (S, max(K-1, 1))
    cp_x: np.ndarray        # predictor tables
    cp_m0: np.ndarray
    cp_B: np.ndarray
    cp_hist: np.ndarray

    def coef(self, name: str, i: int, j=None) -> float:
        """Table entry rounded to fp32, the precision the step computes in."""
        t = getattr(self, name)
        return float(np.float32(t[i] if j is None else t[i, j]))


def _alpha_sigma(sigma: float) -> Tuple[float, float]:
    alpha = 1.0 / np.sqrt(sigma * sigma + 1.0)
    return alpha, sigma * alpha


def _lam(sigma: float) -> float:
    a, s = _alpha_sigma(sigma)
    with np.errstate(divide="ignore"):  # sigma = 0 (final step): +inf
        return np.log(a) - np.log(s)


def _bh_coeffs(h: float, order: int):
    """(h_phi_1, B_h, b(order,)) for predict_x0 (hh = -h), bh2."""
    hh = -h
    h_phi_1 = np.expm1(hh)
    B_h = np.expm1(hh)
    b = []
    h_phi_k = h_phi_1 / hh - 1.0
    factorial_i = 1.0
    for i in range(1, order + 1):
        b.append(h_phi_k * factorial_i / B_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return h_phi_1, B_h, np.array(b)


SOLVER_ORDER = 2


def make(num_inference_steps: int) -> UniPCSchedule:
    """SD-1.5's scaled_linear betas over 1000 training steps, linspace
    spacing, final sigma 0."""
    betas = common.make_betas()
    acp = common.alphas_cumprod_from_betas(betas).astype(np.float64)
    all_sigmas = np.sqrt((1.0 - acp) / acp)
    ts = common.make_timesteps(num_inference_steps)
    S, K = len(ts), SOLVER_ORDER
    sigmas = np.concatenate([np.interp(ts, np.arange(len(all_sigmas)),
                                       all_sigmas), [0.0]])  # (S+1,)

    t = {name: np.zeros(S) for name in ("conv_a", "conv_s", "cc_x", "cc_m0",
                                        "cc_B", "cc_mt", "cp_x", "cp_m0",
                                        "cp_B")}
    cc_hist = np.zeros((S, max(K - 1, 1)))
    cp_hist = np.zeros((S, max(K - 1, 1)))

    def uni_coeffs(t_idx, s0_idx, hist_idxs, order, corrector):
        """-> (c_x, c_m0, c_B, hist_coefs(order-1,), mt_coef); hist_idxs are
        the sigma indices of the older model outputs, nearest first."""
        sigma_t, sigma_s0 = sigmas[t_idx], sigmas[s0_idx]
        alpha_t, _ = _alpha_sigma(sigma_t)
        h = _lam(sigma_t) - _lam(sigma_s0)
        rks = [(_lam(sigmas[si]) - _lam(sigma_s0)) / h
               for si in hist_idxs[:order - 1]]
        rks_full = np.array(rks + [1.0])
        h_phi_1, B_h, b = _bh_coeffs(h, order)
        R = np.stack([rks_full ** (p - 1) for p in range(1, order + 1)])
        if corrector:
            rhos = np.array([0.5]) if order == 1 else np.linalg.solve(R, b)
            hist_coefs = np.array([rhos[j] / rks[j] for j in range(order - 1)])
            mt_coef = rhos[-1]
        else:  # order <= SOLVER_ORDER = 2
            hist_coefs = np.array([0.5 / rks[0]] if order == 2 else [])
            mt_coef = 0.0
        c_x = _alpha_sigma(sigma_t)[1] / _alpha_sigma(sigma_s0)[1]
        c_m0 = alpha_t * h_phi_1
        c_B = alpha_t * B_h
        # final step with sigma 0: h = inf, and the residual sum is 0 there;
        # zero its coefficients instead of propagating inf or nan
        if not np.isfinite(c_B):
            c_B = 0.0
        hist_coefs = np.where(np.isfinite(hist_coefs), hist_coefs, 0.0)
        if not np.isfinite(mt_coef):
            mt_coef = 0.0
        return c_x, c_m0, c_B, hist_coefs, mt_coef

    # the reference's order bookkeeping (warm-up, lower order at the end)
    lower_order_nums = 0
    prev_this_order = 0
    for i in range(S):
        t["conv_a"][i], t["conv_s"][i] = _alpha_sigma(sigmas[i])
        this_order = min(K, S - i, lower_order_nums + 1)
        if i > 0:
            order_c = prev_this_order
            hist = [i - 1 - j for j in range(1, order_c)]
            (t["cc_x"][i], t["cc_m0"][i], t["cc_B"][i], hc,
             t["cc_mt"][i]) = uni_coeffs(i, i - 1, hist, order_c, True)
            cc_hist[i, :len(hc)] = hc
        hist = [i - j for j in range(1, this_order)]
        t["cp_x"][i], t["cp_m0"][i], t["cp_B"][i], hc, _ = uni_coeffs(
            i + 1, i, hist, this_order, False)
        cp_hist[i, :len(hc)] = hc
        prev_this_order = this_order
        lower_order_nums = min(lower_order_nums + 1, K)

    return UniPCSchedule(timesteps=ts, solver_order=K, cc_hist=cc_hist,
                         cp_hist=cp_hist, **t)


def init_state(sched: UniPCSchedule, sample: torch.Tensor):
    """(sample, last_sample, history of K x0 predictions, oldest first)."""
    zeros = torch.zeros_like(sample, dtype=torch.float32)
    return sample, zeros, [zeros] * sched.solver_order


def step(sched: UniPCSchedule, i: int, model_output: torch.Tensor, state):
    """One UniPC step (corrector for the previous step, then predictor)."""
    sample, last_sample, hist = state
    K = sched.solver_order
    c = sched.coef
    out = model_output.float()
    sample32 = sample.float()
    m_t = (sample32 - c("conv_s", i) * out) / c("conv_a", i)

    if i > 0:
        m_prev = hist[K - 1]
        acc = c("cc_mt", i) * (m_t - m_prev)
        for j in range(K - 1):
            acc = acc + c("cc_hist", i, j) * (hist[K - 2 - j] - m_prev)
        sample32 = (c("cc_x", i) * last_sample.float()
                    - c("cc_m0", i) * m_prev - c("cc_B", i) * acc)

    hist: List[torch.Tensor] = hist[1:] + [m_t]
    acc = torch.zeros_like(m_t)
    for j in range(K - 1):
        acc = acc + c("cp_hist", i, j) * (hist[K - 2 - j] - m_t)
    new_sample = (c("cp_x", i) * sample32 - c("cp_m0", i) * m_t
                  - c("cp_B", i) * acc)
    return new_sample.to(sample.dtype), sample32.to(sample.dtype), hist
