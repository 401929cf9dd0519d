"""The port's training checkpoints and exports, on the CPU: save and
restore bit-equal, a run resumed at step 2 of 3 equal to the uninterrupted
run, ``latest_step`` ignoring what is not an exact ``step_N``, and the
exported BlobNet and LoRA equal, key for key and bit for bit, to the JAX
package's ``export_*_safetensors`` (read back with ``safetensors.numpy``
here only), and reloaded through the port's loaders."""

import os

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from blobctrl_tpu.apps import flagship as jflag
from blobctrl_tpu.models import blobnet as jblob
from blobctrl_tpu.models import lora as jlora
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.train import checkpoint as jckpt
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
    path = tckpt.save(str(tmp_path), state)
    assert os.path.basename(path) == "step_00000001"
    assert sorted(os.listdir(path)) == sorted([tckpt.STATE_FILE,
                                              tckpt.LAYOUT_FILE])
    back = tckpt.restore(str(tmp_path), device="cpu")
    _assert_equal_trees(back, state)
    assert set(back) == {"params", "opt_state", "step", "ema"}
    assert back["opt_state"]["count"] == back["step"] == 1
    # a second save at the same step replaces the first
    tckpt.save(str(tmp_path), state)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]


def test_resumed_run_equals_uninterrupted(trees, tmp_path):
    up = from_jax(trees[0], "cpu")
    cfg, straight = _state(trees)
    straight = _run(cfg, straight, up, [0, 1, 2])
    cfg, state = _state(trees)
    state = _run(cfg, state, up, [0, 1])
    tckpt.save(str(tmp_path), state)
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
