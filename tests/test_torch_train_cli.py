"""The port's training CLI (``blobctrl_torch.apps.train_cli``) on the CPU,
on a models root that ``params/export.write_models_root`` writes from
tiny random trees: ``load_dataset`` against the JAX CLI's (PIL) on PNG and
JPEG images and RGB masks of another size; 2 steps with a checkpoint, a
resume to 4 (starting at step 2) and the export, which reloads through
the port's loaders bit-equal to the final state; the adapter and each
step's t and noise, JAX's draws for PRNGKey(0) and PRNGKey(step);
checkpoints in JAX's format both ways: a JAX run continued by the port and
a port run continued by JAX, each against JAX's run resumed to 4, and a
resumed state refused before any step where it misfits the flags;
data-parallel training
on 2 gloo ranks: ``--data_parallel 2``, where --batch_size is the global
batch (its checkpoints, resume, export and collective count, its rows
those JAX's loader gives each device, its run that of one rank at the
same batch), and two ``--coordinator`` processes, where it is per
process (against one process fed their global batches); the refused
flags and batches."""

import io
import itertools
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from blobctrl_tpu.apps import train_cli as jcli
from blobctrl_tpu.train import data as jdata
from blobctrl_torch.apps import train_cli as tcli
from blobctrl_torch.params import export as texport
from blobctrl_torch.params import io as tio
from blobctrl_torch.parallel import collectives, multihost
from blobctrl_torch.train import checkpoint as tckpt
from blobctrl_torch.train import data as tdata
from blobctrl_torch.train import train_step as tts
from blobctrl_torch.utils import benchkit, png
from tests import torch_ranks
from tests.jax_train_cli import cli_argv, run_jax_cli
from tests.test_torch_loaders import lora_tree, tiny_trees

torch.set_num_threads(2)
SIZE = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    trees, cfgs = tiny_trees(seed=6)
    texport.write_models_root(
        root, unet=trees["unet"], unet_cfg=cfgs["unet"],
        blobnet=trees["blobnet"], blobnet_cfg=cfgs["blobnet"],
        vae=trees["vae"], vae_cfg=cfgs["vae"], clip=trees["clip"],
        clip_cfg=cfgs["clip"], dino=trees["dino"], dino_cfg=cfgs["dino"],
        lora=lora_tree(trees["unet"], seed=7), lora_alpha=8.0,
        tokenizer=benchkit.byte_level_tokenizer(), dino_image_size=28,
        float_dtype=None)
    return root


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Four scenes at 80 x 96 (resized and cropped to SIZE): PNG and
    JPEG images, masks as gray or RGB PNGs, prompts for three of them, and
    an image without a mask (skipped)."""
    root = tmp_path_factory.mktemp("data")
    os.makedirs(root / "images")
    os.makedirs(root / "masks")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:80, :96]
    for i in range(4):
        img = rng.randint(0, 256, (80, 96, 3)).astype(np.uint8)
        inside = ((xx - 44 - 2 * i) / 20.0) ** 2 + ((yy - 38) / 14.0) ** 2
        mask = np.where(inside <= 1.0, 230, 12).astype(np.uint8)
        name = f"scene{i}.png"
        if i % 2:  # a JPEG body under the .png name, as PIL reads it
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=90)
            (root / "images" / name).write_bytes(buf.getvalue())
            mask = np.stack([mask, mask // 2, 255 - mask], -1)  # RGB mask
        else:
            (root / "images" / name).write_bytes(png.encode_png(img))
        (root / "masks" / name).write_bytes(png.encode_png(mask))
    (root / "images" / "unmasked.png").write_bytes(png.encode_png(img))
    (root / "prompts.json").write_text(json.dumps(
        {"scene0": "a red ball", "scene1": "a cup", "scene3": "a hat"}))
    return str(root)


def test_load_dataset_matches_jax(data_root):
    want = jcli.load_dataset(data_root, SIZE)
    got = tcli.load_dataset(data_root, SIZE)
    assert got[2] == want[2] == ["a red ball", "a cup", "", "a hat"]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert all(m.any() and (m == 255).any() for m in got[1])


def _argv(models_root, data_root, tmp, *extra):
    return ["--models_root", models_root, "--data_root", data_root,
            "--size", str(SIZE), "--batch_size", "2", "--ckpt_every", "2",
            "--log_every", "1", "--lora_rank", "4", "--learning_rate",
            "1e-3", "--ckpt_dir", str(tmp / "ckpts"), "--device", "cpu",
            *extra]


def _events(caplog, name):
    out = []
    for rec in caplog.records:
        try:
            ev = json.loads(rec.getMessage())
        except ValueError:
            continue
        if ev.get("event") == name:
            out.append(ev)
    return out


def test_train_checkpoint_resume_export(models_root, data_root, tmp_path,
                                        caplog):
    caplog.set_level(logging.INFO, logger="blobctrl_torch")
    state = tcli.main(_argv(models_root, data_root, tmp_path,
                            "--steps", "2"))
    assert state["step"] == 2
    assert [e["step"] for e in _events(caplog, "train")] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in _events(caplog, "train"))
    assert tckpt.latest_step(str(tmp_path / "ckpts")) == 2
    caplog.clear()
    state = tcli.main(_argv(models_root, data_root, tmp_path, "--steps", "4",
                            "--resume", "--export_dir",
                            str(tmp_path / "export")))
    assert _events(caplog, "resumed") == [{"event": "resumed", "step": 2}]
    assert [e["step"] for e in _events(caplog, "train")] == [3, 4]
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["step_00000002",
                                                      "step_00000004"]
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    # the export reloads through the port's loaders as the final state
    blob = tio.load_blobnet(str(tmp_path / "export" / "blobnet"),
                            device="cpu")
    for a, b in zip(texport.flatten(blob).items(),
                    texport.flatten(state["params"]["blobnet"]).items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1].detach())
    lora, alpha = tio.load_lora_dir(str(tmp_path / "export" / "unet_lora"),
                                    device="cpu")
    assert alpha is None and set(lora) == set(state["params"]["lora"])
    moved = 0
    for k, ab in state["params"]["lora"].items():
        for n in ("A", "B"):
            assert torch.equal(lora[k][n], ab[n].detach())
        moved += bool(ab["B"].any())
    assert moved == len(lora)  # every B left zero


def test_the_cli_draws_the_jax_clis_adapter_and_step_noise(
        models_root, data_root, tmp_path, monkeypatch):
    """The adapter is JAX's ``init_lora(PRNGKey(0))`` over the JAX
    loader's UNet (every A within 4 ulp, the targets in its order), and
    step s draws t and noise from ``PRNGKey(s)`` as the JAX step does,
    bit-equal. About 9 s."""
    import jax
    import jax.numpy as jnp
    from blobctrl_tpu.models import lora as jlora
    from blobctrl_tpu.params import io as jio
    from blobctrl_torch.models import lora as tlora
    from tests.test_torch_threefry import ulps
    adapters, draws = [], []
    real_init, real_draw = tlora.init_lora, tts.draw_t_noise

    def init_spy(*a, **k):
        adapters.append(real_init(*a, **k))
        return adapters[-1]

    def draw_spy(key, batch, shape, *a, **k):
        draws.append((batch, tuple(shape), real_draw(key, batch, shape,
                                                     *a, **k)))
        return draws[-1][2]
    monkeypatch.setattr(tlora, "init_lora", init_spy)
    monkeypatch.setattr(tts, "draw_t_noise", draw_spy)
    tcli.main(_argv(models_root, data_root, tmp_path, "--steps", "2"))
    jpipe = jio.load_pipeline(models_root, dtype=jnp.bfloat16)
    want = jlora.init_lora(jax.random.PRNGKey(0), jpipe.unet_params, rank=4)
    (got,) = adapters
    assert list(got) == list(want)
    for k, ab in want.items():
        assert ulps(got[k]["A"].numpy(), np.asarray(ab["A"])).max() <= 4, k
    assert len(draws) == 2
    for step, (batch, shape, (t, noise)) in enumerate(draws):
        assert batch == 2 and shape == (SIZE // 8, SIZE // 8, 4)
        rng_t, rng_n = jax.random.split(jax.random.PRNGKey(step))
        np.testing.assert_array_equal(t.numpy(), np.asarray(
            jax.random.randint(rng_t, (2,), 0, 1000)))
        np.testing.assert_array_equal(noise.numpy(), np.asarray(
            jax.random.normal(rng_n, (2,) + shape, jnp.float32)))


def test_data_parallel_checkpoint_resume_export(models_root, data_root,
                                                tmp_path, caplog,
                                                monkeypatch):
    """``--data_parallel 2 --device cpu``: this process is rank 0 and
    spawns rank 1 (gloo; one thread, as the test workers share the
    cores); 4 steps of the global batch of 2 (--batch_size 2, 1 row a
    rank, every rank's loader over the whole data set) with a checkpoint
    every 2 and the export, then ``--resume`` on 2 ranks to 6, which
    starts at step 4. Rank 0 narrates and writes (no ``.tmp`` left); its
    collective log is the derived count: the replicate, the steps'
    gradient means, one barrier a checkpoint."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    caplog.set_level(logging.INFO, logger="blobctrl_torch")
    collectives.reset()
    state = tcli.main(_argv(models_root, data_root, tmp_path, "--steps", "4",
                            "--data_parallel", "2", "--export_dir",
                            str(tmp_path / "export")))
    assert collectives.sizes() == tts.training_counts(
        state["params"], 2, steps=4, replicated=state, checkpoints=2)
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    train = _events(caplog, "train")
    assert [e["step"] for e in train] == [1, 2, 3, 4]
    assert all(np.isfinite(e["loss"]) for e in train)
    assert [e["step"] for e in _events(caplog, "checkpoint")] == [2, 4]
    assert _events(caplog, "multihost") == [
        {"event": "multihost", "process": 0, "processes": 2,
         "local_examples": 4}]
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["step_00000002",
                                                      "step_00000004"]
    saved = tckpt.restore(str(tmp_path / "ckpts"), device="cpu")
    for a, b in zip(tts.tree_leaves(saved), tts.tree_leaves(state)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    blob = tio.load_blobnet(str(tmp_path / "export" / "blobnet"),
                            device="cpu")
    for a, b in zip(texport.flatten(blob).values(),
                    texport.flatten(state["params"]["blobnet"]).values()):
        assert torch.equal(a, b)
    caplog.clear()
    collectives.reset()
    fresh = []   # rank 0 reads the checkpoint and makes no fresh state
    monkeypatch.setattr(tts, "init_train_state",
                        lambda *a, f=tts.init_train_state: fresh.append(1)
                        or f(*a))
    state = tcli.main(_argv(models_root, data_root, tmp_path, "--steps", "6",
                            "--data_parallel", "2", "--resume"))
    assert fresh == []
    assert _events(caplog, "resumed") == [{"event": "resumed", "step": 4}]
    assert [e["step"] for e in _events(caplog, "train")] == [5, 6]
    assert state["step"] == 6 and state["opt_state"]["count"] == 6
    assert collectives.sizes() == tts.training_counts(
        state["params"], 2, steps=2, replicated=state, checkpoints=1)


def _cli(argv, env_threads="1"):
    """``python -m blobctrl_torch.apps.train_cli argv`` started in the
    repository root, one thread a process."""
    env = dict(os.environ, OMP_NUM_THREADS=env_threads, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "blobctrl_torch.apps.train_cli", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _wait(procs, timeout=240):
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _train_events(events):
    return [e for e in events if e.get("event") == "train"]


def _steps_agree(got, want):
    """Two fp32 runs' step records (``torch_ranks.fp32_train_steps``),
    held to fixed bars: each step's loss within 1e-6
    relative, and the averaged gradients of the first step (from the same
    state) within 1e-5 of each leaf's max |gradient|. Later steps start
    from states that Adam's rounding-level steps have parted, which
    ``_states_agree`` bounds."""
    assert len(got["loss"]) == len(want["loss"]) == len(want["grads"])
    for i, (g, w) in enumerate(zip(got["loss"], want["loss"])):
        assert abs(g - w) <= 1e-6 * abs(w), (i, got["loss"], want["loss"])
    for j, (g, w) in enumerate(zip(got["grads"][0], want["grads"][0],
                                   strict=True)):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), j


def _states_agree(got, want, steps):
    """Two final states within ``test_torch_train_step.py``'s bar over
    several steps: every parameter within the step bound (steps (1 + wd
    |p|) lr) everywhere, and within 1e-3 lr but at a few elements (at
    most 1e-3 of them) where Adam stepped a rounding-level gradient."""
    lr, wd = 1e-3, tts.TrainConfig().weight_decay   # _argv's rate
    assert got["step"] == want["step"] == steps
    far = total = 0
    for g, w in zip(tts.tree_leaves(got["params"]),
                    tts.tree_leaves(want["params"]), strict=True):
        err = (g - w).abs()
        assert err.max() <= steps * (1 + wd * w.abs().max()) * lr
        far += int((err > 1e-3 * lr).sum())
        total += err.numel()
    assert far <= 1e-3 * total, (far, total)


@pytest.fixture(scope="module")
def tiny_roots(tmp_path_factory):
    """``benchkit.write_tiny_training_roots``: the models root and data of
    the committed fixture, whose nets JAX compiles faster than the toy
    geometry's. -> (models root, data root)."""
    work = tmp_path_factory.mktemp("tiny_roots")
    roots = str(work / "models"), str(work / "data")
    benchkit.write_tiny_training_roots(*roots)
    return roots


@pytest.fixture(scope="module")
def jax_run(tiny_roots, tmp_path_factory):
    """JAX's training CLI, fp32 (``tests/jax_train_cli.py``): 2 steps with
    a checkpoint, then that directory resumed to 4 in a copy. -> (the
    step-2 directory's parent, JAX's losses at steps 3 and 4, its state at
    step 4 as the port reads it). About 50 s of JAX compiles."""
    models_root, data_root = tiny_roots
    work = tmp_path_factory.mktemp("jax_run")
    first = str(work / "two")
    run_jax_cli(cli_argv(models_root, data_root, first, 2))
    ref = str(work / "ref")
    shutil.copytree(first, ref)
    losses = run_jax_cli(cli_argv(models_root, data_root, ref, 4,
                                  "--resume"))
    assert tckpt.latest_step(ref) == 4 and len(losses) == 2
    return first, losses, tckpt.restore(ref, device="cpu")


def _losses_agree(got, want):
    """test_torch_train_step.py's bar on a step's loss: 1e-5 relative."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)


def test_the_port_continues_a_jax_run(tiny_roots, jax_run, tmp_path,
                                      caplog):
    """JAX's CLI trains 2 steps and saves (orbax); the port's
    ``train_cli --resume --steps 4`` continues it from step 2: its losses
    at steps 3 and 4 and its final state JAX's run resumed to 4, at
    test_torch_train_step.py's multi-step bars; its step-4 checkpoint is
    JAX's format."""
    (models_root, data_root), (first, want_losses, want_state) = \
        tiny_roots, jax_run
    ckpts = str(tmp_path / "ckpts")
    shutil.copytree(first, ckpts)
    caplog.set_level(logging.INFO, logger="blobctrl_torch")
    with torch_ranks.fp32_train_steps() as rec:
        state = tcli.main(cli_argv(models_root, data_root, ckpts, 4,
                                   "--resume", "--device", "cpu"))
    assert _events(caplog, "resumed") == [{"event": "resumed", "step": 2}]
    assert [e["step"] for e in _events(caplog, "train")] == [3, 4]
    _losses_agree(rec["loss"], want_losses)
    _states_agree(state, want_state, 4)
    assert os.path.exists(os.path.join(ckpts, "step_00000004",
                                       tckpt.METADATA))


def test_jax_continues_a_port_run(tiny_roots, jax_run, tmp_path):
    """The port's CLI trains 2 steps and saves; JAX's CLI resumes it to 4:
    its losses at steps 3 and 4 and its final state those of JAX's own run
    resumed to 4, at the same bars. (Before the port's loader gave its
    trees key-sorted, as JAX's does, a models root whose files are not in
    key order, as this one, gave another adapter than JAX's: the step-4
    state missed the bar by 0.83 in a LoRA A.)"""
    (models_root, data_root), (_, want_losses, want_state) = \
        tiny_roots, jax_run
    ckpts = str(tmp_path / "ckpts")
    with torch_ranks.fp32_train_steps():
        tcli.main(cli_argv(models_root, data_root, ckpts, 2, "--device",
                           "cpu"))
    losses = run_jax_cli(cli_argv(models_root, data_root, ckpts, 4,
                                  "--resume"))
    _losses_agree(losses, want_losses)
    _states_agree(tckpt.restore(ckpts, device="cpu"), want_state, 4)


@pytest.mark.parametrize("flags,match", [
    (["--full_finetune"], "--full_finetune"),
    (["--ema_decay", "0.9"], "--ema_decay"),
    (["--lora_rank", "8"], "--lora_rank"),
    (["--lr_warmup_steps", "2"], "--lr_warmup_steps"),
    (["--lr_schedule", "cosine"], "--lr_schedule"),
    ([], "params.blobnet.conv_in.kernel"),
])
def test_a_resumed_state_that_misfits_the_flags_is_refused(
        tiny_roots, jax_run, tmp_path, caplog, flags, match):
    """JAX's step-2 checkpoint (a constant rate) resumed under another
    --full_finetune, --ema_decay, --lora_rank or a learning-rate schedule
    (which JAX's restore refuses, and whose next save JAX could not
    read), or with a BlobNet leaf of another shape than the models
    root's: refused by name before any step."""
    ckpts = str(tmp_path / "ckpts")
    shutil.copytree(jax_run[0], ckpts)
    if not flags:   # a BlobNet whose conv_in is not the models root's
        state = tckpt.restore(ckpts, device="cpu")
        for tree in (state["params"], state["opt_state"]["mu"],
                     state["opt_state"]["nu"]):
            conv = tree["blobnet"]["conv_in"]
            conv["kernel"] = conv["kernel"][:, :, :-1].contiguous()
        tckpt.save(ckpts, state, tts.TrainConfig())
    caplog.set_level(logging.INFO, logger="blobctrl_torch")
    with pytest.raises(SystemExit, match=match):
        tcli.main(cli_argv(*tiny_roots, ckpts, 4, "--resume",
                           "--device", "cpu", *flags))
    assert not _events(caplog, "train")


def test_a_misfit_rank_0_refuses_is_refused_on_every_rank(
        tiny_roots, jax_run, tmp_path, monkeypatch):
    """The spawned form's rank 0 resumes JAX's step-2 checkpoint (a
    constant rate) under --lr_warmup_steps: a misfit that leaves the
    state's layout as the other rank's fresh one, so rank 0's verdict
    travels with the layouts and both ranks stop before any step."""
    ckpts = str(tmp_path / "ckpts")
    shutil.copytree(jax_run[0], ckpts)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the spawned rank's
    with pytest.raises(SystemExit) as e:
        tcli.main(cli_argv(*tiny_roots, ckpts, 4, "--resume", "--device",
                           "cpu", "--lr_warmup_steps", "2",
                           "--data_parallel", "2"))
    msg = str(e.value)
    assert msg.startswith("data-parallel training failed: rank 0: --resume")
    assert "--lr_warmup_steps 2 make a schedule" in msg, msg
    assert msg.endswith("ranks 1-1: exit codes [1]"), msg
    assert tckpt.latest_step(ckpts) == 2


DP_STEPS = 3   # two epochs of the 4 scenes at a global batch of 2


@pytest.fixture(scope="module")
def spawned(models_root, data_root, tmp_path_factory):
    """The one-rank run at --batch_size 2 (in this process) and the
    spawned form's rank body on 2 gloo ranks at the same flags, DP_STEPS
    steps each, both in fp32 (``torch_ranks.fp32_train_steps``): -> (the
    one rank's step losses, each rank's (loader indices, step losses, log
    events), the two runs' checkpoint directories)."""
    tmp = tmp_path_factory.mktemp("spawned")
    with torch_ranks.fp32_train_steps() as losses:
        tcli.main(_argv(models_root, data_root, tmp / "one", "--steps",
                        str(DP_STEPS)))
    ranks = torch_ranks.run_ranks(
        torch_ranks.train_cli_rank, 2,
        _argv(models_root, data_root, tmp / "two", "--steps", str(DP_STEPS),
              "--data_parallel", "2"), multihost.free_port())
    return losses, ranks, tmp / "one" / "ckpts", tmp / "two" / "ckpts"


def test_spawned_ranks_train_the_one_rank_batch(spawned):
    """--batch_size 2 over 2 spawned ranks trains what one rank trains at
    --batch_size 2, up to the order of the fp32 gradient sum: each step's
    loss and averaged gradients within ``_steps_agree``'s bars, the final
    checkpoint within the multi-step bar. Each rank trains 1 row a step,
    and img_per_sec is 2 images over the step's seconds (each logged
    rounded, to 2 and 3 decimals)."""
    want, ranks, ckpt_one, ckpt_two = spawned
    (seen0, got, ev0), (seen1, got1, ev1) = ranks
    assert got["loss"] == got1["loss"]
    _steps_agree(got, want)
    assert _train_events(ev1) == []          # rank 0 alone narrates
    logged = _train_events(ev0)
    assert [e["step"] for e in logged] == [1, 2, 3]
    for e in logged:
        dt = e["sec_per_step"]
        assert abs(e["img_per_sec"] - 2 / dt) <= 0.005 + 2 * 5e-4 / (
            dt * (dt - 5e-4)), e
    assert all(len(idx) == 1 for idx in seen0 + seen1)
    _states_agree(tckpt.restore(str(ckpt_two), device="cpu"),
                  tckpt.restore(str(ckpt_one), device="cpu"), DP_STEPS)


def test_each_rank_trains_its_rows_of_the_jax_loader_batch(
        spawned, data_root, monkeypatch):
    """At every step rank r's examples are rows [r, r+1) of the batch the
    JAX ``BlobDataLoader`` draws from the same seed over the same data set
    (the rows JAX's ``P("data")`` puts on device r). Its examples are
    their indices here: its order does not read them."""
    _, ranks, _, _ = spawned
    n = len(tcli.load_dataset(data_root, SIZE)[0])
    count = itertools.count()
    monkeypatch.setattr(jdata, "build_example",
                        lambda *a, **k: {"i": np.int64(next(count))})
    loader = jdata.BlobDataLoader(None, [None] * n, [None] * n, [None] * n,
                                  batch_size=2)
    jax_batches = [b["i"].tolist() for _ in range(2) for b in loader]
    for r, (seen, _, _) in enumerate(ranks):
        assert seen[:DP_STEPS] == [b[r:r + 1]
                                   for b in jax_batches[:DP_STEPS]], (
            r, seen, jax_batches)


def test_coordinator_form_equals_the_spawned_form(models_root, data_root,
                                                  tmp_path, monkeypatch):
    """Two ``--coordinator`` processes at --batch_size 1 (per process, as
    in JAX's multi-process form; each with its own checkpoint and export
    directories) against one process fed their global batches of 2: each
    process's strided loader row, in rank order, with the same draws. The
    spawned form reads other rows, so the reference is this one; both in
    fp32, each step within ``_steps_agree``'s bars and the final
    checkpoint within the multi-step bar. Rank 1's directories are never
    made."""
    argv = _argv(models_root, data_root, tmp_path / "rank{rank}", "--steps",
                 "2", "--export_dir", str(tmp_path / "rank{rank}" / "exp"))
    argv[argv.index("--batch_size") + 1] = "1"
    ranks = torch_ranks.run_ranks(torch_ranks.train_cli_rank, 2, argv,
                                  multihost.free_port(), True)
    real = tdata.BlobDataLoader

    class Strided:
        """The two processes' loaders, their batches in rank order."""

        def __init__(self, pipe, images, masks, pes, batch_size, size,
                     rows):
            assert batch_size == 2 and rows == range(2)
            self.parts = [real(pipe, images[i::2], masks[i::2], pes[i::2],
                               batch_size=1, size=size) for i in range(2)]

        def __iter__(self):
            for parts in zip(*self.parts):
                yield {k: np.concatenate([b[k] for b in parts])
                       for k in parts[0]}
    monkeypatch.setattr(tdata, "BlobDataLoader", Strided)
    with torch_ranks.fp32_train_steps() as want:
        ref = tcli.main(_argv(models_root, data_root, tmp_path / "one",
                              "--steps", "2"))
    for _, got, _ in ranks:
        _steps_agree(got, want)
    _states_agree(tckpt.restore(str(tmp_path / "rank0" / "ckpts"),
                                device="cpu"), ref, 2)
    assert os.path.isdir(tmp_path / "rank0" / "exp" / "blobnet")
    assert not os.path.exists(tmp_path / "rank1")


def test_a_stride_short_of_a_batch_is_refused_on_every_rank(
        models_root, data_root, tmp_path):
    """``--coordinator``: 4 examples over 2 processes leave 2 a process,
    fewer than its --batch_size 3: every process refuses with one message,
    before the group forms (so nobody waits for the group's timeout)."""
    argv = _argv(models_root, data_root, tmp_path, "--steps", "2")
    argv[argv.index("--batch_size") + 1] = "3"
    msg = "4 examples over 2 hosts leave 2 a host, fewer than --batch_size 3"
    port = multihost.free_port()
    t0 = time.monotonic()
    res = _wait([_cli(argv + ["--coordinator", f"127.0.0.1:{port}",
                              "--num_processes", "2", "--process_id", str(i)])
                 for i in range(2)], timeout=120)
    assert time.monotonic() - t0 < 60
    for rc, err in res:
        assert rc != 0 and msg in err, err
    assert not os.path.exists(tmp_path / "ckpts")


@pytest.mark.parametrize("batch,msg", [
    ("3", "--batch_size 3 is the global batch: 2 ranks do not divide it"),
    ("6", "dataset has 4 examples but batch_size is 6; the loader would "
          "yield zero batches")])
def test_an_indivisible_batch_is_refused_on_every_rank(
        batch, msg, models_root, data_root, tmp_path, monkeypatch):
    """The spawned form's --batch_size is the global batch: 3 over 2 ranks
    (JAX's ``shard_batch`` cannot place it either), or 6 of 4 examples.
    Both ranks refuse with one message before the group forms, with this
    process as rank 0 and under ``python -m`` (where both ranks' messages
    reach stderr)."""
    argv = _argv(models_root, data_root, tmp_path, "--steps", "2",
                 "--data_parallel", "2")
    argv[argv.index("--batch_size") + 1] = batch
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the spawned rank's
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert str(e.value) == (f"data-parallel training failed: rank 0: {msg}; "
                            f"ranks 1-1: exit codes [1]")
    [(rc, err)] = _wait([_cli(argv)], timeout=120)
    assert time.monotonic() - t0 < 90
    assert rc != 0 and err.count(msg) == 2, err
    assert not os.path.exists(tmp_path / "ckpts")


@pytest.mark.parametrize("flags,match", [
    (["--coordinator", "127.0.0.1:1234"], "go together"),
    (["--coordinator", "127.0.0.1:1234", "--num_processes", "2"],
     "go together"),
    (["--process_id", "0"], "go together"),
    (["--coordinator", "127.0.0.1:1234", "--num_processes", "2",
      "--process_id", "2"], "not a rank of --num_processes 2"),
    (["--coordinator", "127.0.0.1:1234", "--num_processes", "2",
      "--process_id", "0", "--data_parallel", "3"],
     "--data_parallel 3 with --num_processes 2: every host runs as many "
     "ranks, so the data axis is a multiple of 2"),
    (["--data_parallel", "-1", "--device", "cpu"], "< 0"),
])
def test_inconsistent_rank_flags_refused(flags, match, tmp_path):
    """Refused before anything loads (the data root does not exist)."""
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--data_root", str(tmp_path / "absent"), *flags])


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
@pytest.mark.parametrize("cards", [0, 1])
def test_more_spawned_ranks_than_cards_refused(device, cards, tmp_path,
                                               monkeypatch):
    """--data_parallel 2 on the card wants two cards, rank r on cuda:r:
    refused where CUDA has none or one (faked), and for a device that
    names one card, before anything loads."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    match = (f"needs 2 cards, one a rank; {cards} are visible"
             if device == "cuda" else "name --device cuda, not cuda:0")
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--data_root", str(tmp_path / "absent"), "--device",
                   device, "--data_parallel", "2"])


@pytest.mark.parametrize("device", ["cuda:0", "cuda:1"])
def test_a_named_card_trains_one_rank(device, tmp_path, monkeypatch):
    """On a host with 2 (faked) cards, ``--device cuda:K`` without
    --coordinator is one rank on that card (spawning a rank a card onto
    one card would fail in NCCL), and ``--data_parallel 2`` with it is
    refused before anything loads."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = tcli.build_parser().parse_args(["--data_root", "x", "--device",
                                           device])
    assert tcli.ranks(args) == (1, None, False)
    args.data_parallel = 1
    assert tcli.ranks(args) == (1, None, False)
    with pytest.raises(SystemExit, match=f"not {device}"):
        tcli.main(["--data_root", str(tmp_path / "absent"), "--device",
                   device, "--data_parallel", "2"])


def test_data_parallel_zero_means_every_card(monkeypatch):
    """--data_parallel 0 is every visible card (1 on the CPU); with
    --coordinator, every card of every host: 8 hosts of 1 card are 8
    ranks, of 4 cards 32, each process spawning its host's other 3."""
    args = tcli.build_parser().parse_args(["--data_root", "x", "--device",
                                           "cpu"])
    assert tcli.ranks(args) == (1, None, False)
    args.device = "cuda"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tcli.ranks(args) == (4, "nccl", True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tcli.ranks(args) == (1, None, False)
    args.coordinator, args.num_processes, args.process_id = "h:1", 8, 5
    assert tcli.ranks(args) == (8, "nccl", False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tcli.ranks(args) == (32, "nccl", True)
    args.device = "cpu"
    assert tcli.ranks(args) == (8, "gloo", False)
    args.data_parallel = 16
    assert tcli.ranks(args) == (16, "gloo", True)


def test_a_coordinator_host_runs_its_share_of_the_data_axis(monkeypatch):
    """With --coordinator a process is a host that runs --data_parallel /
    --num_processes ranks, local rank r on its card r over NCCL: more than
    its cards is refused before anything loads. ``--device cuda:K`` is
    one rank a host on card K (faked cards), which refuses more."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(multihost, "resolve_device", torch.device)
    args = tcli.build_parser().parse_args([
        "--data_root", "x", "--coordinator", "h:1", "--num_processes", "2",
        "--process_id", "1", "--data_parallel", "4"])
    assert tcli.ranks(args) == (4, "nccl", True)
    assert [multihost.nccl_card(args.device, r) for r in range(2)] == [
        torch.device("cuda", r) for r in range(2)]
    args.data_parallel = 8
    with pytest.raises(SystemExit, match="--data_parallel 8 over 2 hosts "
                       "needs 4 cards, one a rank; 2 are visible"):
        tcli.ranks(args)
    for device in ("cuda:0", "cuda:1"):
        args.device = device
        for dp in (0, 2):
            args.data_parallel = dp
            assert tcli.ranks(args) == (2, "nccl", False)
            assert multihost.nccl_card(device, 0) == torch.device(device)
        args.data_parallel = 4
        with pytest.raises(SystemExit, match=f"name --device cuda, not "
                           f"{device}"):
            tcli.ranks(args)


def test_a_host_batch_its_ranks_do_not_divide_is_refused_on_every_rank(
        models_root, data_root, tmp_path):
    """``--coordinator`` over 2 hosts of 2 gloo ranks: --batch_size 1 is
    each host's batch, which its 2 ranks cannot split. Every rank of both
    hosts refuses with one message before the group forms, and each host
    exits non-zero with its ranks' codes."""
    argv = _argv(models_root, data_root, tmp_path, "--steps", "2",
                 "--data_parallel", "4")
    argv[argv.index("--batch_size") + 1] = "1"
    msg = "--batch_size 1 is each host's batch: its 2 ranks do not divide it"
    port = multihost.free_port()
    t0 = time.monotonic()
    res = _wait([_cli(argv + ["--coordinator", f"127.0.0.1:{port}",
                              "--num_processes", "2", "--process_id", str(i)])
                 for i in range(2)], timeout=120)
    assert time.monotonic() - t0 < 60
    for h, (rc, err) in enumerate(res):
        assert rc != 0 and err.count(msg) == 2, err
        assert (f"data-parallel training failed: rank {2 * h}: {msg}; "
                f"ranks {2 * h + 1}-{2 * h + 1}: exit codes [1]") in err, err
    assert not os.path.exists(tmp_path / "ckpts")
