"""The port's samplers against the JAX package's: DDIM, the DPM-Solver++
family and UniPC in its other configurations (UniPC's default is in
``test_torch_vae_unipc``), and the pipeline's scheduler names.

Tables: the port keeps float64 tables and rounds each entry to fp32 as its
step reads it; the JAX package builds the same float64 tables and stores
them as fp32. After that rounding every table must be bit-equal.
Trajectories: 20 steps on an analytic model (eps = 0.1 x + c) in fp32, the
stochastic variants fed the same numpy noise on both sides, within 1e-6
relative of the largest value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_tpu.pipeline import blobnet_pipeline as jpipe_mod
from blobctrl_tpu.schedulers import common as jcommon
from blobctrl_tpu.schedulers import ddim as jddim
from blobctrl_tpu.schedulers import dpm as jdpm
from blobctrl_tpu.schedulers import unipc as junipc
from blobctrl_torch.pipeline import blobnet_pipeline as tpipe_mod
from blobctrl_torch.schedulers import common as tcommon
from blobctrl_torch.schedulers import ddim as tddim
from blobctrl_torch.schedulers import dpm as tdpm
from blobctrl_torch.schedulers import unipc as tunipc

torch.set_num_threads(2)

DPM_VARIANTS = [dict(algorithm_type=a, solver_type=s, use_karras_sigmas=k)
                for a in ("dpmsolver++", "sde-dpmsolver++")
                for s in ("midpoint", "heun") for k in (False, True)]
UNIPC_VARIANTS = [
    {}, dict(timesteps=[999, 871, 750, 601, 480, 333, 250, 120, 60, 11]),
    dict(spacing="leading", steps_offset=1), dict(spacing="trailing"),
    dict(spacing="leading_ddim", steps_offset=1), dict(thresholding=True),
    dict(solver_order=3, solver_type="bh1"),
    dict(prediction_type="v_prediction", disable_corrector=(2, 5)),
    dict(final_sigmas_type="sigma_min", beta_schedule="linear",
         beta_start=1e-4, beta_end=0.02)]
DDIM_VARIANTS = [{}, dict(eta=0.5), dict(eta=1.0, set_alpha_to_one=True),
                 dict(timesteps=[961, 800, 641, 400, 201, 81, 1]),
                 dict(spacing="trailing", beta_schedule="squaredcos_cap_v2")]


def _steps(kw, default=10):
    return len(kw["timesteps"]) if "timesteps" in kw else default


def _assert_tables(port, jax_sched, names):
    np.testing.assert_array_equal(port.timesteps, jax_sched.timesteps)
    for name in names:
        tab = getattr(port, name)
        assert tab.dtype == np.float64, name
        np.testing.assert_array_equal(tab.astype(np.float32),
                                      np.asarray(getattr(jax_sched, name)),
                                      err_msg=name)


@pytest.mark.parametrize("spacing", ["linspace", "leading", "leading_ddim",
                                     "trailing"])
@pytest.mark.parametrize("schedule", ["linear", "scaled_linear",
                                      "squaredcos_cap_v2"])
def test_common_tables_match_jax(spacing, schedule):
    for n in (1, 7, 25, 50):
        np.testing.assert_array_equal(
            tcommon.make_timesteps(n, 1000, spacing, 1),
            jcommon.make_timesteps(n, 1000, spacing, 1))
    np.testing.assert_array_equal(tcommon.make_betas(beta_schedule=schedule),
                                  jcommon.make_betas(beta_schedule=schedule))


@pytest.mark.parametrize("bad", [[], [5, 5, 1], [1, 5], [1000, 5], [5, -1],
                                 [[3, 2]]])
def test_custom_timesteps_validated_like_jax(bad):
    with pytest.raises(ValueError):
        jcommon.validate_custom_timesteps(bad)
    with pytest.raises(ValueError):
        tcommon.validate_custom_timesteps(bad)


@pytest.mark.parametrize("kw", DDIM_VARIANTS, ids=str)
def test_ddim_tables_match_jax(kw):
    n = _steps(kw, 25)
    _assert_tables(tddim.make(n, **kw), jddim.make(n, **kw),
                   ("a_t", "s_t", "c_x0", "c_eps", "sigma"))


@pytest.mark.parametrize("kw", DPM_VARIANTS + [
    dict(timesteps=[999, 700, 420, 200, 90, 10]),
    dict(spacing="trailing", solver_order=1),
    dict(final_sigmas_type="sigma_min", lower_order_final=False)], ids=str)
def test_dpm_tables_match_jax(kw):
    n = _steps(kw, 25)
    port, ref = tdpm.make(n, **kw), jdpm.make(n, **kw)
    _assert_tables(port, ref, ("conv_a", "conv_s", "c_x", "c_0", "c_1", "c_n"))
    assert port.stochastic == ref.stochastic


def test_dpm_karras_helpers_match_jax():
    sig = np.sqrt((1 - jcommon.alphas_cumprod_from_betas(
        jcommon.make_betas()).astype(np.float64)) / jcommon.
        alphas_cumprod_from_betas(jcommon.make_betas()).astype(np.float64))
    ramp_t = tdpm.karras_sigmas(float(sig[0]), float(sig[-1]), 30)
    np.testing.assert_array_equal(
        ramp_t, jdpm.karras_sigmas(float(sig[0]), float(sig[-1]), 30))
    logs = np.log(sig)
    for s in list(ramp_t) + [1e-12, float(sig[-1]) * 2]:
        assert tdpm._sigma_to_t(s, logs) == jdpm._sigma_to_t(s, logs)


@pytest.mark.parametrize("kw", UNIPC_VARIANTS, ids=str)
def test_unipc_tables_match_jax(kw):
    n = _steps(kw)
    port, ref = tunipc.make(n, **kw), junipc.make(n, **kw)
    _assert_tables(port, ref, ("conv_a", "conv_s", "cc_x", "cc_m0", "cc_B",
                               "cc_mt", "cc_hist", "cp_x", "cp_m0", "cp_B",
                               "cp_hist", "cc_on"))


def _analytic(x, c):
    return 0.1 * x + c


def _run(make_t, make_j, init_t, init_j, step_t, step_j, steps=20,
         noisy=False):
    rng = np.random.RandomState(3)
    x0 = rng.randn(2, 6, 8, 4).astype(np.float32)
    c = (0.3 * rng.randn(1, 6, 8, 4)).astype(np.float32)
    noise = rng.randn(steps, 2, 6, 8, 4).astype(np.float32)
    ts, js = make_t(), make_j()
    tstate, jstate = init_t(ts, torch.from_numpy(x0)), init_j(
        js, jnp.asarray(x0))
    for i in range(steps):
        tn = torch.from_numpy(noise[i]) if noisy else None
        jn = jnp.asarray(noise[i]) if noisy else None
        tstate = step_t(ts, i, _analytic(tstate[0], torch.from_numpy(c)),
                        tstate, tn)
        jstate = step_j(js, i, _analytic(jstate[0], jnp.asarray(c)), jstate,
                        jn)
    got, want = tstate[0].numpy(), np.asarray(jstate[0])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_trajectory_matches_jax(eta):
    _run(lambda: tddim.make(20, eta=eta), lambda: jddim.make(20, eta=eta),
         lambda s, x: (x,), lambda s, x: (x,),
         lambda s, i, e, st, n: (tddim.step(s, i, e, st[0], noise=n),),
         lambda s, i, e, st, n: (jddim.step(s, i, e, st[0], noise=n),),
         noisy=eta > 0)


@pytest.mark.parametrize("kw", DPM_VARIANTS, ids=str)
def test_dpm_trajectory_matches_jax(kw):
    _run(lambda: tdpm.make(20, **kw), lambda: jdpm.make(20, **kw),
         tdpm.init_state, jdpm.init_state,
         lambda s, i, e, st, n: tdpm.step(s, i, e, st, noise=n),
         lambda s, i, e, st, n: jdpm.step(s, i, e, st, noise=n),
         noisy=kw["algorithm_type"].startswith("sde"))


@pytest.mark.parametrize("kw", UNIPC_VARIANTS[1:], ids=str)
def test_unipc_trajectory_matches_jax(kw):
    n = _steps(kw, 20)
    _run(lambda: tunipc.make(n, **kw), lambda: junipc.make(n, **kw),
         tunipc.init_state, junipc.init_state,
         lambda s, i, e, st, _: tunipc.step(s, i, e, st),
         lambda s, i, e, st, _: junipc.step(s, i, e, st), steps=n)


def test_final_samples_are_the_state():
    x = torch.ones(1, 2, 2, 4)
    assert tunipc.final_corrected_sample((x, None, None)) is x
    assert tdpm.final_sample((x, None)) is x


@pytest.mark.parametrize("name", ["unipc", "ddim", "dpm", "dpm_karras",
                                  "dpm_sde", "dpm_sde_karras", "dpm_heun",
                                  "dpm_karras_heun_sde", "dpm_", "dpm_sd",
                                  "dpm__karras", "dpmsolver", "euler"])
def test_scheduler_names_dispatch_like_jax(name):
    """Each name makes the JAX package's sampler with the same tables, or
    raises the same ValueError (JAX builds its schedule when it builds the
    edit graph, ``_get_edit_fn``)."""
    jp = jpipe_mod.BlobNetPipeline(unet_cfg=None, unet_params=None,
                                   blobnet_cfg=None, blobnet_params=None,
                                   vae_cfg=None, vae_params=None)
    try:
        _, want = jp._get_edit_fn(name, 12, True, eta=0.3)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpipe_mod.make_scheduler(name, 12, eta=0.3)
        assert str(got.value) == str(e)
        return
    got = tpipe_mod.make_scheduler(name, 12, eta=0.3)
    assert type(got).__name__ == type(want).__name__
    names = [f.name for f in __import__("dataclasses").fields(got)
             if isinstance(getattr(got, f.name), np.ndarray)]
    _assert_tables(got, want, [n for n in names if n != "timesteps"])
    assert getattr(got, "eta", 0.0) == getattr(want, "eta", 0.0)
