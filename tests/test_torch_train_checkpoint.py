"""The port's training checkpoints and exports, on the CPU: save and
restore bit-equal, a run resumed at step 2 of 3 equal to the uninterrupted
run, ``latest_step`` ignoring what is not an exact ``step_N``, and the
exported BlobNet and LoRA equal, key for key and bit for bit, to the JAX
package's ``export_*_safetensors`` (read back with ``safetensors.numpy``
here only), and reloaded through the port's loaders. The format is the
JAX package's (orbax): JAX's train state maps onto the port's and back,
LoRA and full UNet, constant, warmup and cosine rates, with and without
an EMA; counts that disagree with the step, or a clip or decay state that
is not empty, are refused; the port's earlier format still restores."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from safetensors.numpy import load_file

from blobctrl_tpu.apps import flagship as jflag
from blobctrl_tpu.models import blobnet as jblob
from blobctrl_tpu.models import lora as jlora
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.train import checkpoint as jckpt
from blobctrl_tpu.train import train_step as jts
from blobctrl_torch.apps import flagship as tflag
from blobctrl_torch.params import io as tio
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.train import checkpoint as tckpt
from blobctrl_torch.train import train_step as tts
from blobctrl_torch.utils import threefry

torch.set_num_threads(2)


def _batch(seed, b=2, lh=8):
    rng = np.random.RandomState(seed)
    return {"x0_latents": rng.randn(b, lh, lh, 4), "fg_latents":
            rng.randn(b, lh, lh, 4), "bg_latents": rng.randn(b, lh, lh, 4),
            "fg_score": rng.rand(b, lh, lh, 1), "bg_score":
            rng.rand(b, lh, lh, 1), "fg_feats": rng.randn(b, lh, lh, 16),
            "text_embeds": rng.randn(b, 7, 16)}


@pytest.fixture(scope="module")
def trees():
    """numpy trees: a tiny UNet, BlobNet with drawn taps, a rank-4 LoRA
    with a drawn B."""
    ucfg, bcfg = jflag.tiny_configs()
    up = junet.init_unet(jax.random.PRNGKey(1), ucfg)
    bp = jblob.init_blobnet(jax.random.PRNGKey(2), bcfg)
    rng = np.random.RandomState(3)
    bp = {k: (jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32) * 0.2, v)
        if k.startswith("zero_") else v) for k, v in bp.items()}
    lora = {k: {"A": np.asarray(ab["A"]), "B": (rng.randn(
        *ab["B"].shape) * 0.05).astype(np.float32)}
        for k, ab in jlora.init_lora(jax.random.PRNGKey(4), up,
                                     rank=4).items()}
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return np_tree(up), np_tree(bp), lora


def _state(trees, ema=0.0):
    up, bp, lora = trees
    cfg = tts.TrainConfig(learning_rate=1e-3, remat=False, ema_decay=ema,
                          compute_dtype=torch.float32)
    return cfg, tts.init_train_state(cfg, from_jax(bp, "cpu"),
                                     from_jax(lora, "cpu"))


def _run(cfg, state, up, steps):
    step = tts.make_train_step(cfg, *tflag.tiny_configs())
    for i in steps:
        batch = _batch(10 + i)
        t, noise = tts.draw_t_noise(threefry.key(i), 2,
                                    (8, 8, 4))
        state, _ = step(state, up, batch, t, noise)
    return state


def _assert_equal_trees(a, b):
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _assert_equal_trees(a[k], b[k])
    elif isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_trees(x, y)
    elif torch.is_tensor(b):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())
    else:
        assert type(a) is type(b) and a == b


def test_save_restore_bit_equal(trees, tmp_path):
    cfg, state = _state(trees, ema=0.99)
    state = _run(cfg, state, from_jax(trees[0], "cpu"), [0])
    path = tckpt.save(str(tmp_path), state, cfg)
    assert os.path.basename(path) == "step_00000001"
    assert sorted(os.listdir(path)) == sorted([
        tckpt.METADATA, tckpt.CHECKPOINT_METADATA, tckpt.SHARDING,
        "manifest.ocdbt", "d"])
    back = tckpt.restore(str(tmp_path), device="cpu")
    _assert_equal_trees(back, state)
    assert set(back) == {"params", "opt_state", "step", "ema"}
    assert back["opt_state"]["count"] == back["step"] == 1
    # a second save at the same step replaces the first
    tckpt.save(str(tmp_path), state, cfg)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]


def test_resumed_run_equals_uninterrupted(trees, tmp_path):
    up = from_jax(trees[0], "cpu")
    cfg, straight = _state(trees)
    straight = _run(cfg, straight, up, [0, 1, 2])
    cfg, state = _state(trees)
    state = _run(cfg, state, up, [0, 1])
    tckpt.save(str(tmp_path), state, cfg)
    del state
    resumed = tckpt.restore(str(tmp_path), step=2, device="cpu")
    assert resumed["step"] == 2
    resumed = _run(cfg, resumed, up, [2])
    _assert_equal_trees(resumed, straight)


def test_latest_step_ignores_partial_directories(tmp_path):
    assert tckpt.latest_step(str(tmp_path / "absent")) is None
    assert tckpt.latest_step(str(tmp_path)) is None
    for name in ("step_00000002", "step_00000007.tmp",
                 "step_00000009.orbax-checkpoint-tmp-1712", "step_x",
                 "steps_00000011", "step_00000003"):
        (tmp_path / name).mkdir()
    assert tckpt.latest_step(str(tmp_path)) == 3
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "absent"), device="cpu")


def test_exports_equal_jax_and_reload(trees, tmp_path):
    _, bp, lora = trees
    tb, tl = from_jax(bp, "cpu"), from_jax(lora, "cpu")
    for name, jfn, tfn, tree, ttree in (
            ("blobnet", jckpt.export_blobnet_safetensors,
             tckpt.export_blobnet_safetensors, bp, tb),
            ("unet_lora", jckpt.export_lora_safetensors,
             tckpt.export_lora_safetensors, lora, tl)):
        jpath = str(tmp_path / "jax" / name / "w.safetensors")
        tpath = str(tmp_path / "torch" / name / "w.safetensors")
        jfn(tree, jpath)
        tfn(ttree, tpath)
        want, got = load_file(jpath), load_file(tpath)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = tio.load_blobnet(str(tmp_path / "torch" / "blobnet"),
                            device="cpu")
    _assert_equal_trees(back, tb)
    back_lora, alpha = tio.load_lora_dir(str(tmp_path / "torch" /
                                             "unet_lora"), device="cpu")
    assert alpha is None and set(back_lora) == set(tl)
    for k in tl:
        for n in ("A", "B"):
            assert torch.equal(back_lora[k][n], tl[k][n])


# ---------------------------------------------------------------------------
# the JAX package's format (orbax), both ways
# ---------------------------------------------------------------------------

def _seeded(state, step=3):
    """A JAX train state with every float leaf drawn and every int leaf
    ``step`` (as after ``step`` updates)."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    rng = np.random.RandomState(step)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.randn(*x.shape).astype(np.float32))
        if jnp.issubdtype(x.dtype, jnp.floating)
        else jnp.full(x.shape, step, x.dtype) for x in leaves])


def _port_view(state):
    """The JAX state as the port holds it: {count, mu, nu}, ints."""
    adam = state["opt_state"][1][0]
    out = {"params": np_tree(state["params"]),
           "opt_state": {"count": int(adam.count), "mu": np_tree(adam.mu),
                         "nu": np_tree(adam.nu)},
           "step": int(state["step"])}
    if "ema" in state:
        out["ema"] = np_tree(state["ema"])
    return out


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(got, want, path="state"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}.{i}")
    elif isinstance(want, np.ndarray):
        assert torch.is_tensor(got) and got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def small_trees():
    """JAX trees at ``benchkit.write_tiny_training_roots``' geometry (one
    level of one layer): orbax saves and restores them in a few seconds."""
    import dataclasses
    ucfg, bcfg = jflag.tiny_configs()
    one = dict(block_out_channels=(8,), layers_per_block=1)
    ucfg = dataclasses.replace(ucfg, down_block_has_attn=(True,),
                               up_block_has_attn=(True,), **one)
    bcfg = dataclasses.replace(bcfg, down_block_has_attn=(False,),
                               up_block_has_attn=(False,), **one)
    up = junet.init_unet(jax.random.PRNGKey(1), ucfg)
    return (up, jblob.init_blobnet(jax.random.PRNGKey(2), bcfg),
            jlora.init_lora(jax.random.PRNGKey(4), up, rank=4))


LR_KW = {"constant": {}, "warmup": {"lr_warmup_steps": 2},
         "cosine": {"lr_schedule": "cosine", "lr_warmup_steps": 1,
                    "lr_total_steps": 9}}


@pytest.mark.parametrize("ema", [0.0, 0.99])
@pytest.mark.parametrize("lr", sorted(LR_KW))
@pytest.mark.parametrize("adapter", ["lora", "full"])
def test_jax_state_maps_onto_the_port_and_back(small_trees, tmp_path,
                                               adapter, lr, ema):
    """JAX's ``init_train_state`` (moments and counts as after 3 steps),
    saved by the JAX package (orbax), restores as the port's state bit for
    bit (opt_state {count, mu, nu}, ints, every dict sorted as a fresh
    state's); the port saves it back under the same TrainConfig and the
    JAX package's ``restore`` gives the JAX state bit for bit, the
    schedule's count present exactly where ``make_lr`` has a schedule."""
    up, bp, lora = small_trees
    kw = dict(LR_KW[lr], ema_decay=ema, train_unet_full=adapter == "full")
    jcfg = jts.TrainConfig(**kw)
    state = _seeded(jts.init_train_state(
        jcfg, bp, up if adapter == "full" else lora))
    jckpt.save(str(tmp_path / "jax"), state)
    got = tckpt.restore(str(tmp_path / "jax"), device="cpu")
    _assert_same(got, _port_view(state))
    assert list(got) == ["params", "opt_state", "step"] + (
        ["ema"] if ema else [])
    fresh = tts.init_train_state(tts.TrainConfig(**kw), from_jax(bp, "cpu"),
                                 from_jax(up if adapter == "full" else lora,
                                          "cpu"))
    assert tts._layout(got) == tts._layout(fresh)
    tckpt.save(str(tmp_path / "port"), got, tts.TrainConfig(**kw))
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    back = jckpt.restore(str(tmp_path / "port"), abstract)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("leaf,match", [
    ("step", r"opt_state.1.0.count \(Adam's\) is 3 where step is 5"),
    ("schedule", r"opt_state.1.2.count \(the schedule's\) is 4"),
    ("clip", r"opt_state.0 \(the clip's state\) must be empty"),
    ("decay", r"opt_state.1.1 \(the weight decay's state\) must be empty"),
])
def test_a_state_whose_counts_or_chain_disagree_is_refused(
        small_trees, tmp_path, leaf, match):
    up, bp, lora = small_trees
    state = _seeded(jts.init_train_state(jts.TrainConfig(
        lr_warmup_steps=2), bp, lora))
    tree = dict(state)
    clip, (adam, decay, sched) = state["opt_state"]
    if leaf == "step":
        tree["step"] = jnp.int32(5)
    elif leaf == "schedule":
        sched = type(sched)(count=jnp.int32(4))
    elif leaf == "clip":
        clip = {"norm": jnp.zeros(())}
    else:
        decay = {"w": jnp.ones((2,))}
    tree["opt_state"] = [clip, [adam, decay, sched]]
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "step_00000003"), tree)
    with pytest.raises(ValueError, match=match):
        tckpt.restore(str(tmp_path), device="cpu")


def _save_port_format(ckpt_dir, state, step):
    """The port's earlier format, written as its earlier ``save`` wrote
    it: ``state.safetensors`` + ``state.json`` (the layout)."""
    import json
    from blobctrl_torch.params import export
    tensors = {}

    def layout(tree, path):
        if isinstance(tree, dict):
            return {k: layout(v, f"{path}.{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v, f"{path}.{i}") for i, v in enumerate(tree)]
        if torch.is_tensor(tree):
            tensors[path[1:]] = tree
            return {"__tensor__": path[1:]}
        return tree
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d)
    lay = layout(state, "")
    export.save_safetensors(os.path.join(d, tckpt.STATE_FILE), tensors)
    with open(os.path.join(d, tckpt.LAYOUT_FILE), "w") as f:
        json.dump({"step": step, "layout": lay}, f)


def test_the_ports_earlier_format_still_restores_and_steps_mix(trees,
                                                               tmp_path):
    """A directory of the earlier format restores bit-equal (its dicts
    sorted as a fresh state's); with steps of both formats in one
    directory, ``latest_step`` picks the largest whatever its format; a
    directory of neither format is refused naming both."""
    cfg, state = _state(trees, ema=0.99)
    state = _run(cfg, state, from_jax(trees[0], "cpu"), [0, 1, 2])
    _save_port_format(str(tmp_path), state, 3)
    back = tckpt.restore(str(tmp_path), device="cpu")
    _assert_equal_trees(back, state)
    tckpt.save(str(tmp_path), state, cfg, step=5)
    assert tckpt.latest_step(str(tmp_path)) == 5
    _assert_equal_trees(tckpt.restore(str(tmp_path), device="cpu"), state)
    _save_port_format(str(tmp_path), state, 7)
    assert tckpt.latest_step(str(tmp_path)) == 7
    _assert_equal_trees(tckpt.restore(str(tmp_path), device="cpu"), state)
    os.makedirs(tmp_path / "step_00000009")
    with pytest.raises(ValueError, match="orbax.*state.json"):
        tckpt.restore(str(tmp_path), device="cpu")
