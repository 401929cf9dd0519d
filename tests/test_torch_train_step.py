"""The port's training step against the JAX package's on the CPU, fp32:
one tiny-config BlobNet + LoRA step fed JAX's t and noise (loss and
grad_norm within 1e-5 relative, every updated leaf within 1e-3 * lr of
JAX's), the full-UNet mode with EMA over three steps, the learning-rate
schedules and the optimizer against optax, and the helpers training calls
(``training_tables``, ``add_noise``, ``sample_latents``, ``init_lora``,
``merge_lora``'s gradients, ``from_unet``, ``dinov2.preprocess``). JAX
compiles each step configuration once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blobctrl_tpu.apps import flagship as jflag
from blobctrl_tpu.models import blobnet as jblob
from blobctrl_tpu.models import dinov2 as jdino
from blobctrl_tpu.models import lora as jlora
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.models import vae as jvae
from blobctrl_tpu.schedulers import ddim as jddim
from blobctrl_tpu.train import train_step as jts
from blobctrl_torch.apps import flagship as tflag
from blobctrl_torch.models import blobnet as tblob
from blobctrl_torch.models import dinov2 as tdino
from blobctrl_torch.models import lora as tlora
from blobctrl_torch.models import vae as tvae
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.schedulers import ddim as tddim
from blobctrl_torch.train import train_step as tts
from blobctrl_torch.utils import threefry
from tests.test_torch_threefry import ulps

torch.set_num_threads(2)
LR = 1e-3


def make_batch(seed, b=2, lh=8, dc=16, ct=16):
    rng = np.random.RandomState(seed)
    return {
        "x0_latents": rng.randn(b, lh, lh, 4).astype(np.float32),
        "fg_latents": rng.randn(b, lh, lh, 4).astype(np.float32),
        "bg_latents": rng.randn(b, lh, lh, 4).astype(np.float32),
        "fg_score": rng.rand(b, lh, lh, 1).astype(np.float32),
        "bg_score": rng.rand(b, lh, lh, 1).astype(np.float32),
        "fg_feats": rng.randn(b, lh, lh, dc).astype(np.float32),
        "text_embeds": rng.randn(b, 7, ct).astype(np.float32),
    }


def jax_draws(key, batch, num_train_timesteps=1000):
    """t and noise exactly as the JAX step draws them."""
    rng_t, rng_n = jax.random.split(key)
    b = batch["x0_latents"].shape[0]
    t = jax.random.randint(rng_t, (b,), 0, num_train_timesteps)
    noise = jax.random.normal(rng_n, batch["x0_latents"].shape, jnp.float32)
    return (torch.from_numpy(np.array(t)).long(),
            torch.from_numpy(np.array(noise)))


def _randomize(tree, rng, s=0.2):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * s),
        tree)


def jax_trees(seed=0):
    """Tiny UNet and BlobNet with drawn taps (so BlobNet's weights get
    gradients) and a rank-4 LoRA with a drawn B (so A does)."""
    ucfg, bcfg = jflag.tiny_configs()
    up = junet.init_unet(jax.random.PRNGKey(seed + 1), ucfg)
    bp = jblob.init_blobnet(jax.random.PRNGKey(seed + 2), bcfg)
    rng = np.random.RandomState(seed + 3)
    for k in ("zero_down", "zero_mid", "zero_up"):
        bp[k] = _randomize(bp[k], rng)
    lora = jlora.init_lora(jax.random.PRNGKey(seed + 4), up, rank=4)
    lora = {k: {"A": ab["A"], "B": _randomize(ab["B"], rng, 0.05)}
            for k, ab in lora.items()}
    return ucfg, bcfg, up, bp, lora


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def paired(got, want, what=""):
    """(path, port leaf as numpy, JAX leaf) of two trees, matched by key
    (JAX orders a dict's keys, the port keeps their insertion order)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            yield from paired(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            yield from paired(g, w, f"{what}/{i}")
    else:
        g = got.detach().numpy()
        assert g.shape == np.shape(want), what
        yield what, g, np.asarray(want)


def assert_tree_close(got, want, atol, what):
    """Every leaf of the port's tree within atol of JAX's (same keys)."""
    for path, g, w in paired(got, want, what):
        err = np.abs(g - w).max()
        assert err <= atol, (path, err, atol)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture(scope="module")
def lora_run():
    """One JAX LoRA step and its inputs: (trees, batch, key, JAX state
    after the step, JAX metrics)."""
    ucfg, bcfg, up, bp, lora = jax_trees()
    cfg = jts.TrainConfig(learning_rate=LR, remat=False,
                          compute_dtype=jnp.float32)
    state0 = jts.init_train_state(cfg, bp, lora)
    init = np_tree(state0["params"])
    batch = make_batch(5)
    key = jax.random.PRNGKey(11)
    step = jts.make_train_step(cfg, ucfg, bcfg)
    state, metrics = step(state0, up, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
    return (ucfg, bcfg, np_tree(up), init, batch, key, np_tree(state),
            jax.device_get(metrics))


def test_lora_step_matches_jax(lora_run):
    ucfg, bcfg, up, init, batch, key, want, metrics = lora_run
    cfg = tts.TrainConfig(learning_rate=LR, remat=False,
                          compute_dtype=torch.float32)
    state = tts.init_train_state(cfg, from_jax(init["blobnet"], "cpu"),
                                 from_jax(init["lora"], "cpu"))
    t, noise = jax_draws(key, batch)
    step = tts.make_train_step(cfg, tflag.tiny_configs()[0],
                               tflag.tiny_configs()[1])
    state, got = step(state, from_jax(up, "cpu"), batch, t, noise)
    assert rel(got["loss"], metrics["loss"]) < 1e-5
    assert rel(got["grad_norm"], metrics["grad_norm"]) < 1e-5
    assert float(metrics["grad_norm"]) > cfg.max_grad_norm  # clip active
    assert got["lr"] == float(metrics["lr"]) == float(np.float32(LR))
    assert state["step"] == int(want["step"]) == 1
    # the clipped gradients, as Adam's first moment holds them: (1 - b1) g
    jmu = want["opt_state"][1][0].mu
    for path, g, w in paired(state["opt_state"]["mu"], jmu):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), path
    # every updated leaf within 1e-3 * lr of JAX's wherever Adam's first
    # step is conditioned: u = g / (|g| + eps) moves by eps dg / (|g| +
    # eps)^2, so a gradient within the bar above (dg = 1e-5 max |g|) may
    # move u by more than 1e-3 where (|g| + eps)^2 < 1e-2 eps max |g|;
    # there the step is held to its own bound, |u| <= 1 + wd |p|
    ill = total = 0
    for (path, p, w), (_, _, m) in zip(paired(state["params"],
                                              want["params"]),
                                       paired(state["opt_state"]["mu"], jmu)):
        g = np.abs(m) / (1 - tts.ADAM_B1)
        small = (g + tts.ADAM_EPS) ** 2 < 1e-2 * tts.ADAM_EPS * g.max()
        err = np.abs(p - w)
        assert err[~small].max(initial=0.0) <= 1e-3 * LR, path
        assert err.max() <= 2.0 * LR, path
        ill += small.sum()
        total += m.size
    assert ill < 1e-3 * total
    # every trainable moved, LoRA A through the drawn B
    for p, p0 in zip(tts.tree_leaves(state["params"]["lora"]),
                     jax.tree_util.tree_leaves(init["lora"])):
        assert not np.array_equal(p.numpy(), p0)
    # the step differentiated aliases: no master was left requiring grad
    assert not any(p.requires_grad for p in tts.tree_leaves(state["params"]))


def test_full_unet_with_ema_three_steps_match_jax():
    """train_unet_full with an EMA, three steps on JAX's draws: each step's
    loss and grad_norm within 1e-5 relative of JAX's, the EMA the rule
    over the port's own params, params and EMA within 1e-3 * lr of JAX's
    at all but the few elements where Adam steps a rounding-level gradient
    (those within the step bound, 3 (1 + wd |p|) lr)."""
    ucfg, bcfg, up, bp, _ = jax_trees(seed=20)
    kw = dict(learning_rate=LR, remat=False, train_unet_full=True,
              ema_decay=0.9, weight_decay=1e-3)
    jcfg = jts.TrainConfig(compute_dtype=jnp.float32, **kw)
    tcfg = tts.TrainConfig(compute_dtype=torch.float32, **kw)
    jstate = jts.init_train_state(jcfg, bp, up)
    tstate = tts.init_train_state(tcfg, from_jax(bp, "cpu"),
                                  from_jax(up, "cpu"))
    ema = [p.detach().clone() for p in tts.tree_leaves(tstate["params"])]
    jstep = jts.make_train_step(jcfg, ucfg, bcfg)
    tstep = tts.make_train_step(tcfg, *tflag.tiny_configs())
    for i in range(3):
        batch = make_batch(30 + i)
        key = jax.random.PRNGKey(40 + i)
        jstate, jm = jstep(jstate, None, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, key)
        tstate, tm = tstep(tstate, None, batch, *jax_draws(key, batch))
        assert rel(tm["loss"], jm["loss"]) < 1e-5, i
        assert rel(tm["grad_norm"], jm["grad_norm"]) < 1e-5, i
        ema = [0.9 * e + (1.0 - 0.9) * p.detach() for e, p in zip(
            ema, tts.tree_leaves(tstate["params"]))]
    for e, g in zip(ema, tts.tree_leaves(tstate["ema"])):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=0, atol=1e-7)
    want = np_tree(jstate)
    assert tstate["step"] == 3 and set(tstate) == set(want)
    for name in ("params", "ema"):
        far = total = 0
        for path, g, w in paired(tstate[name], want[name], name):
            err = np.abs(g - w)
            assert err.max() <= 3 * (1 + 1e-3 * np.abs(w).max()) * LR, path
            far += (err > 1e-3 * LR).sum()
            total += err.size
        assert far <= 1e-3 * total, (name, far, total)


@pytest.mark.parametrize("name,kw", [
    ("constant", {}),
    ("warmup", {"lr_warmup_steps": 5}),
    ("cosine", {"lr_schedule": "cosine", "lr_warmup_steps": 3,
                "lr_total_steps": 11, "lr_end_factor": 0.1}),
    ("cosine-no-warmup", {"lr_schedule": "cosine", "lr_total_steps": 7}),
])
def test_make_lr_matches_optax(name, kw):
    jlr = jts.make_lr(jts.TrainConfig(learning_rate=3e-4, **kw))
    tlr = tts.make_lr(tts.TrainConfig(learning_rate=3e-4, **kw))
    assert callable(jlr) == callable(tlr)
    n = kw.get("lr_total_steps", kw.get("lr_warmup_steps", 4))
    for step in range(n + 3):
        want = float(jlr(jnp.asarray(step, jnp.int32))) if callable(jlr) \
            else jlr
        got = tlr(step) if callable(tlr) else tlr
        assert rel(got, want) <= 1e-6 or abs(got - want) < 1e-12, (step, got,
                                                                   want)


def test_make_lr_refuses_what_optax_refuses():
    with pytest.raises(ValueError, match="lr_total_steps"):
        tts.make_lr(tts.TrainConfig(lr_schedule="cosine"))
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        tts.make_lr(tts.TrainConfig(lr_schedule="linear"))


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_optimizer_matches_optax(clip):
    """clip_by_global_norm + adamw over three updates of a random tree."""
    rng = np.random.RandomState(50)
    tree = {"a": rng.randn(5, 3).astype(np.float32),
            "b": [rng.randn(7).astype(np.float32),
                  {"c": rng.randn(2, 2, 3).astype(np.float32)}]}
    scale = 1.0 if clip == "active" else 0.01
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * scale).astype(np.float32), tree)
        for _ in range(3)]
    cfg = tts.TrainConfig(learning_rate=1e-2, weight_decay=0.05,
                          lr_warmup_steps=2)
    jcfg = jts.TrainConfig(learning_rate=1e-2, weight_decay=0.05,
                           lr_warmup_steps=2)
    opt = jts.make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = opt.init(jparams)
    tparams = tts.tree_map(torch.from_numpy, jax.tree_util.tree_map(
        np.copy, tree))
    tstate = tts.init_opt_state(tparams)
    for g in grads:
        norm = float(optax.global_norm(g))
        assert (norm > cfg.max_grad_norm) == (clip == "active")
        updates, jstate = opt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tnorm = tts.apply_optimizer(cfg, tparams, tstate, [
            torch.from_numpy(g["a"]), torch.from_numpy(g["b"][0]),
            torch.from_numpy(g["b"][1]["c"])])
        assert rel(tnorm, norm) < 1e-6
    assert tstate["count"] == 3
    assert_tree_close(tparams, np_tree(jparams), 1e-7, "params")


def test_training_tables_and_add_noise_match_jax():
    for sched in ("scaled_linear", "linear"):
        want = jddim.training_tables(1000, beta_schedule=sched)
        got = tddim.training_tables(1000, beta_schedule=sched)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))
    a, s = jddim.training_tables()
    rng = np.random.RandomState(60)
    x0 = rng.randn(3, 4, 4, 4).astype(np.float32)
    noise = rng.randn(3, 4, 4, 4).astype(np.float32)
    t = np.array([0, 517, 999])
    want = jddim.add_noise(a, s, jnp.asarray(t), jnp.asarray(x0),
                           jnp.asarray(noise))
    ta, tsq = (torch.from_numpy(x) for x in tddim.training_tables())
    got = tddim.add_noise(ta, tsq, torch.from_numpy(t), torch.from_numpy(x0),
                          torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_latents_matches_jax():
    rng = np.random.RandomState(61)
    moments = rng.randn(2, 4, 4, 8).astype(np.float32) * 3
    moments[..., 4:] *= 20  # log variances beyond the clip on both sides
    want = np.asarray(jvae.sample_latents(jnp.asarray(moments)))
    m = torch.from_numpy(moments)
    np.testing.assert_array_equal(tvae.sample_latents(m).numpy(), want)
    # with a key: JAX's eps for it (bit-equal), the rest fp32 arithmetic
    got = tvae.sample_latents(m, threefry.key(3))
    want = np.asarray(jvae.sample_latents(jnp.asarray(moments),
                                          jax.random.PRNGKey(3)))
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 4, 4, 4)))
    logvar = np.clip(moments[..., 4:], -30.0, 20.0)
    expect = moments[..., :4] + np.exp(0.5 * logvar) * eps
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 7, 1248464818])
def test_draw_t_noise_is_the_jax_steps_draw(seed):
    """``draw_t_noise(key(s))``: the t and noise JAX's step draws from
    ``PRNGKey(s)`` (``jax_draws``), bit-equal, whole and by ranks' rows."""
    batch = make_batch(0, b=4)
    want_t, want_n = jax_draws(jax.random.PRNGKey(seed), batch)
    t, noise = tts.draw_t_noise(threefry.key(seed), 4, (8, 8, 4))
    assert t.dtype == torch.int64 and tuple(noise.shape) == (4, 8, 8, 4)
    assert torch.equal(t, want_t) and torch.equal(noise, want_n)
    for rows in (range(0, 2), range(2, 4), range(1, 2)):
        rt, rn = tts.draw_t_noise(threefry.key(seed), 4, (8, 8, 4),
                                  rows=rows)
        assert torch.equal(rt, want_t[rows.start:rows.stop])
        assert torch.equal(rn, want_n[rows.start:rows.stop])


def test_init_lora_from_key_0_is_the_train_clis():
    """The train CLI's adapter: ``init_lora(key(0))`` against JAX's
    ``init_lora(PRNGKey(0))``, every A within 4 ulp, B zero."""
    ucfg, _ = jflag.tiny_configs()
    up = junet.init_unet(jax.random.PRNGKey(3), ucfg)
    want = jlora.init_lora(jax.random.PRNGKey(0), up, rank=4)
    got = tlora.init_lora(threefry.key(0), from_jax(up, "cpu"), rank=4)
    assert list(got) == list(want)
    worst = max(int(ulps(got[k]["A"].numpy(), np.asarray(ab["A"])).max())
                for k, ab in want.items())
    assert worst <= 4, worst
    assert all(not got[k]["B"].any() for k in got)


def test_init_lora_matches_jax_layout_and_merge_grads():
    ucfg, _ = jflag.tiny_configs()
    up = junet.init_unet(jax.random.PRNGKey(70), ucfg)
    want = jlora.init_lora(jax.random.PRNGKey(71), up, rank=4)
    tup = from_jax(up, "cpu")
    got = tlora.init_lora(threefry.key(71), tup, rank=4)
    assert list(got) == list(want)  # the same targets, in the same order
    a_all = []
    for k, ab in want.items():
        d_in = ab["A"].shape[0]
        assert tuple(got[k]["A"].shape) == ab["A"].shape
        assert got[k]["A"].dtype == torch.float32
        assert not got[k]["B"].any() and tuple(got[k]["B"].shape) == \
            ab["B"].shape
        a_all.append(got[k]["A"].numpy().ravel() * np.sqrt(d_in))
        assert ulps(got[k]["A"].numpy(), np.asarray(ab["A"])).max() <= 4, k
    a_all = np.concatenate(a_all)
    assert abs(a_all.mean()) < 0.1 and abs(a_all.std() - 1) < 0.1
    again = tlora.init_lora(threefry.key(71), tup, rank=4)
    assert all(torch.equal(again[k]["A"], got[k]["A"]) for k in got)
    # merge_lora is differentiable in A and B, as JAX's
    rng = np.random.RandomState(72)
    lora = {k: {"A": ab["A"], "B": jnp.asarray(rng.randn(
        *ab["B"].shape).astype(np.float32))} for k, ab in want.items()}
    cots = {k: rng.randn(*up_leaf.shape).astype(np.float32)
            for k, up_leaf in ((k, _leaf(up, k)) for k in want)}

    def jloss(lora):
        merged = jlora.merge_lora(up, lora, scale=0.7)
        return sum(jnp.sum(_leaf(merged, k) * c) for k, c in cots.items())
    jgrad = jax.grad(jloss)(lora)
    tl = {k: {n: torch.from_numpy(np.array(x)).requires_grad_()
              for n, x in ab.items()} for k, ab in lora.items()}
    merged = tlora.merge_lora(tup, tl, scale=0.7)
    loss = sum((_leaf(merged, k) * torch.from_numpy(c)).sum()
               for k, c in cots.items())
    names = [(k, n) for k in tl for n in ("A", "B")]
    grads = torch.autograd.grad(loss, [tl[k][n] for k, n in names])
    for g, (k, n) in zip(grads, names):
        w = np.asarray(jgrad[k][n])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert _leaf(tup, next(iter(want))).grad_fn is None  # frozen untouched


def _leaf(tree, key):
    node = tree
    for p in key.split("/"):
        node = node[int(p)] if p.isdigit() else node[p]
    return node["kernel"]


def test_from_unet_matches_jax():
    ucfg, bcfg = jflag.tiny_configs()
    up = junet.init_unet(jax.random.PRNGKey(80), ucfg)
    want = np_tree(jblob.from_unet(up, bcfg))
    got = tblob.from_unet(from_jax(up, "cpu"), tflag.tiny_configs()[1],
                          device="cpu")
    assert_tree_close(got, want, 0.0, "blobnet")
    assert not got["zero_mid"]["kernel"].any()
    assert got["conv_in"]["kernel"].data_ptr() != 0
    # no storage shared with the UNet
    tu = from_jax(up, "cpu")
    b2 = tblob.from_unet(tu, tflag.tiny_configs()[1], device="cpu")
    b2["time_embedding"]["linear_1"]["kernel"].add_(1.0)
    assert not torch.equal(tu["time_embedding"]["linear_1"]["kernel"],
                           b2["time_embedding"]["linear_1"]["kernel"])
    bad = from_jax(up, "cpu")
    del bad["mid_block"]["resnets"][0]["conv1"]
    with pytest.raises(ValueError, match="missing"):
        tblob.from_unet(bad, tflag.tiny_configs()[1], device="cpu")
    wide = dataclasses.replace(tflag.tiny_configs()[1],
                               block_out_channels=(8, 24))
    with pytest.raises(ValueError):
        tblob.from_unet(from_jax(up, "cpu"), wide, device="cpu")


def test_dinov2_preprocess_matches_jax():
    rng = np.random.RandomState(90)
    images = rng.randint(0, 256, (2, 300, 260, 3)).astype(np.uint8)
    for size in (224, 56):
        want = jdino.preprocess(images, size=size)
        got = tdino.preprocess(images, size=size)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
