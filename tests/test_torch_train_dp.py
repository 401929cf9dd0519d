"""Data-parallel training in the port (``train_step.TrainStep`` with a
group) on two gloo ranks on the CPU, tiny configs, fp32, no remat, a
global batch of 4 (2 rows a rank) and 2 steps, fed JAX's draws of the
global batch sliced per rank:

  * against JAX's single-device ``make_train_step`` on the same global
    batch (the oracle ``tests/test_train_and_sharding.py`` and
    ``tests/test_multihost.py`` hold JAX's own data parallelism to): the
    loss within 1e-6 relative, the gradient norm within 1e-5, every
    updated leaf within ``test_torch_train_step.py``'s multi-step bar;
  * against the port's single-process step on the global batch: the
    averaged gradients within 1e-5 of their max;
  * loss, gradient norm, parameters, Adam moments and the EMA (a second
    run with ``ema_decay`` and the cosine schedule) bit-equal across the
    ranks after every step, from a state rank 1 perturbed before
    ``replicate_state``;
  * the collective log equal to ``train_step.training_counts``: the
    all-reduces a step (small buckets, so leaves span two, and one
    bucket), the replicate's layout gather and broadcasts, one barrier a
    checkpoint;
  * each rank's rows of a drawn global batch, concatenated, bit-equal to
    the global draw; one rank without a group bit-equal to the step as
    it was (loss and gradients, then clip + AdamW + EMA)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_tpu.train import train_step as jts
from blobctrl_torch.apps import flagship as tflag
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.train import train_step as tts
from blobctrl_torch.utils import threefry
from tests import torch_ranks
from tests.test_torch_train_step import (LR, jax_draws, jax_trees,
                                         make_batch, np_tree, paired, rel)

torch.set_num_threads(2)
GLOBAL_B, STEPS = 4, 2
SMALL_BUCKET = 1 << 16   # 16384 floats: the tiny trees need 5 buckets
RUNS = [({"learning_rate": LR}, SMALL_BUCKET),
        ({"learning_rate": LR, "ema_decay": 0.9, "lr_schedule": "cosine",
          "lr_warmup_steps": 1, "lr_total_steps": 3},
         tts.GRAD_BUCKET_BYTES)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's single-device run of the first config and both ranks' runs."""
    ucfg, bcfg, up, bp, lora = jax_trees(seed=30)
    trees = {"unet": np_tree(up), "blobnet": np_tree(bp),
             "lora": np_tree(lora)}
    batches = [make_batch(60 + i, b=GLOBAL_B) for i in range(STEPS)]
    keys = [jax.random.PRNGKey(70 + i) for i in range(STEPS)]
    draws = [tuple(x.numpy() for x in jax_draws(k, b))
             for k, b in zip(keys, batches)]
    cfg = jts.TrainConfig(learning_rate=LR, remat=False,
                          compute_dtype=jnp.float32)
    jstate = jts.init_train_state(cfg, bp, lora)
    jstep = jts.make_train_step(cfg, ucfg, bcfg)
    jax_run = []
    for batch, key in zip(batches, keys):
        jstate, jm = jstep(jstate, up, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, key)
        jax_run.append((jax.device_get(jm), np_tree(jstate)))
    ranks = torch_ranks.run_ranks(
        torch_ranks.train_dp_rank, 2, trees, batches, draws, RUNS,
        str(tmp_path_factory.mktemp("dp_ckpt")))
    return trees, batches, draws, jax_run, ranks


def _one_process(trees, kw, batches, draws):
    """The port's single-process step on the global batch: -> (the first
    batch's gradients, the step, a fresh state, the frozen UNet)."""
    cfg = tts.TrainConfig(compute_dtype=torch.float32, remat=False, **kw)
    state = tts.init_train_state(cfg, from_jax(trees["blobnet"], "cpu"),
                                 from_jax(trees["lora"], "cpu"))
    step = tts.make_train_step(cfg, *tflag.tiny_configs())
    frozen = from_jax(trees["unet"], "cpu")
    t, noise = (torch.from_numpy(a) for a in draws[0])
    _, grads = step.loss_and_grads(state, frozen, batches[0], t.long(), noise)
    return grads, step, state, frozen


def test_data_parallel_steps_match_jax_single_device(setup):
    _, _, _, jax_run, ranks = setup
    mine = ranks[0][0]
    wd = tts.TrainConfig().weight_decay
    for i, ((jm, jstate), (loss, norm)) in enumerate(zip(jax_run,
                                                         mine["metrics"])):
        assert rel(loss, jm["loss"]) < 1e-6, (i, loss, jm["loss"])
        assert rel(norm, jm["grad_norm"]) < 1e-5, (i, norm, jm["grad_norm"])
        # test_torch_train_step's bar over several steps: within the step
        # bound (steps (1 + wd |p|) lr) everywhere, and within 1e-3 lr but
        # at a few elements where Adam stepped a rounding-level gradient
        got = tts.tree_map(torch.from_numpy, mine["states"][i]["params"])
        far = total = 0
        for path, g, w in paired(got, jstate["params"], "params"):
            err = np.abs(g - w)
            bound = (i + 1) * (1 + wd * np.abs(w).max()) * LR
            assert err.max() <= bound, (i, path, err.max())
            far += (err > 1e-3 * LR).sum()
            total += err.size
        assert far <= 1e-3 * total, (i, far, total)
        assert mine["states"][i]["step"] == i + 1


def test_averaged_gradients_match_the_one_process_step(setup):
    trees, batches, draws, _, ranks = setup
    for r, (kw, _) in enumerate(RUNS):
        want, _, _, _ = _one_process(trees, kw, batches, draws)
        for g, w in zip(ranks[0][r]["grads"], want):
            w = w.numpy()
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_state_bit_equal_across_ranks_after_every_step(setup):
    _, _, _, _, ranks = setup
    for r in range(len(RUNS)):
        a, b = ranks[0][r], ranks[1][r]
        assert a["metrics"] == b["metrics"]
        for i in range(STEPS):
            x, y = (tts.tree_leaves(s["states"][i]) for s in (a, b))
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        for x, y in zip(a["grads"], b["grads"]):
            np.testing.assert_array_equal(x, y)
    # the second run carries an EMA shadow, the moments moved
    last = ranks[1][1]["states"][-1]
    assert set(last) == {"params", "opt_state", "step", "ema"}
    assert last["opt_state"]["count"] == STEPS
    assert any(np.any(m) for m in tts.tree_leaves(last["opt_state"]["nu"]))


def test_collective_log_equals_the_derived_count(setup, monkeypatch):
    trees, _, _, _, ranks = setup
    for r, (kw, bucket) in enumerate(RUNS):
        monkeypatch.setattr(tts, "GRAD_BUCKET_BYTES", bucket)
        cfg = tts.TrainConfig(compute_dtype=torch.float32, **kw)
        state = tts.init_train_state(cfg, from_jax(trees["blobnet"], "cpu"),
                                     from_jax(trees["lora"], "cpu"))
        per_step = tts.training_counts(state["params"], 2)
        rep = tts.training_counts(state["params"], 2, steps=0,
                                  replicated=state)
        ckpt = tts.training_counts(state["params"], 2, steps=0,
                                   checkpoints=1)
        elems = tts.num_params(state["params"])
        assert per_step["pipeline"]["all_reduce"]["bytes"] == 4 * (elems + 1)
        assert per_step["pipeline"]["all_reduce"]["count"] == (
            5 if bucket == SMALL_BUCKET else 1)
        for rank in ranks:
            assert rank[r]["replicate"] == rep
            assert rank[r]["steps"] == [per_step] * STEPS
            assert rank[r]["ckpt"] == ckpt == {
                "pipeline": {"barrier": {"count": 1, "bytes": 0}}}
    assert tts.training_counts(state["params"], 1, steps=2) == {}


def test_each_rank_draws_its_rows_of_the_global_batch(setup):
    _, _, _, _, ranks = setup
    t, noise = tts.draw_t_noise(threefry.key(5), GLOBAL_B, (4, 4, 4))
    # the whole draw is the JAX step's for PRNGKey(5)
    rng_t, rng_n = jax.random.split(jax.random.PRNGKey(5))
    np.testing.assert_array_equal(t.numpy(), np.asarray(
        jax.random.randint(rng_t, (GLOBAL_B,), 0, 1000)))
    np.testing.assert_array_equal(noise.numpy(), np.asarray(
        jax.random.normal(rng_n, (GLOBAL_B, 4, 4, 4))))
    for r in range(len(RUNS)):
        np.testing.assert_array_equal(
            np.concatenate([rk[r]["draw"][0] for rk in ranks]), t.numpy())
        np.testing.assert_array_equal(
            np.concatenate([rk[r]["draw"][1] for rk in ranks]), noise.numpy())


def test_one_rank_without_a_group_is_the_step_as_it_was():
    """``TrainStep`` without a group: the loss and gradients, then clip +
    AdamW + EMA, exactly as the one-device step composed them."""
    _, _, up, bp, lora = jax_trees(seed=31)
    trees = {"unet": np_tree(up), "blobnet": np_tree(bp),
             "lora": np_tree(lora)}
    batch = make_batch(80, b=2)
    t, noise = jax_draws(jax.random.PRNGKey(81), batch)
    kw = {"learning_rate": LR, "ema_decay": 0.9}
    _, step, state, frozen = _one_process(trees, kw, [batch],
                                          [(t.numpy(), noise.numpy())])
    assert step.group is None
    ref = tts.init_train_state(step.cfg, from_jax(trees["blobnet"], "cpu"),
                               from_jax(trees["lora"], "cpu"))
    for _ in range(2):
        loss, grads = step.loss_and_grads(ref, frozen, batch, t, noise)
        same = tts.mean_over_ranks(grads, loss, None)
        assert same[0] is grads and same[1] is loss
        norm = tts.apply_optimizer(step.cfg, ref["params"],
                                   ref["opt_state"], grads)
        ref["step"] += 1
        for e, p in zip(tts.tree_leaves(ref["ema"]),
                        tts.tree_leaves(ref["params"])):
            e.mul_(0.9).add_((1.0 - 0.9) * p)
        state, m = step(state, frozen, batch, t, noise)
        assert torch.equal(m["loss"], loss) and torch.equal(
            m["grad_norm"], norm)
    for a, b in zip(tts.tree_leaves(state), tts.tree_leaves(ref)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


def test_a_state_of_another_layout_is_refused_on_every_rank():
    """Rank 0's state has an EMA shadow, rank 1's none: both ranks raise
    the same error after the one gather of the layouts, before any
    broadcast (which would otherwise pair different leaves, or wait for
    the group's timeout)."""
    res = torch_ranks.run_ranks(torch_ranks.mismatched_state_rank, 2,
                                timeout=60)
    (e0, c0), (e1, c1) = res
    assert e0 is not None and e0 == e1 and "layout differs" in e0
    assert c0 == c1 == {"pipeline": {"all_gather": 1}}


def test_a_state_rank_0_refused_is_refused_on_every_rank():
    """Both ranks' states have one layout, but rank 0 refused its (a
    resumed checkpoint whose learning-rate schedule misfits the flags):
    both ranks raise after the one gather, before any broadcast."""
    res = torch_ranks.run_ranks(torch_ranks.mismatched_state_rank, 2,
                                True, timeout=60)
    (e0, c0), (e1, c1) = res
    assert e0 is not None and e0 == e1 and "rank 0 refused" in e0
    assert c0 == c1 == {"pipeline": {"all_gather": 1}}
