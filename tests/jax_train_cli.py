"""The JAX package's training CLI (``blobctrl_tpu/apps/train_cli.py``'s
``main``) run in this process on an argv, in fp32: its pipeline loaded in
fp32 and ``TrainConfig.compute_dtype`` fp32, as
``tests/torch_ranks.fp32_train_steps`` runs the port's, so that the two
CLIs are held to the fp32 bars of ``tests/test_torch_train_step.py``
(their bf16 rounding would differ more). Nothing in the JAX package
changes: its modules' attributes are swapped for the call and restored.
Used by ``tests/test_torch_train_cli.py`` and
``scripts/torch_orbax_fixtures.py``."""

import functools
import os
import sys


def run_jax_cli(argv):
    """``main`` of the JAX CLI on ``argv`` (``--data_parallel 1``: the
    tests' processes hold 8 virtual devices) -> each step's loss, in fp32,
    as floats."""
    import jax.numpy as jnp
    from blobctrl_tpu.apps import train_cli as jcli
    from blobctrl_tpu.params import io as jio
    from blobctrl_tpu.train import train_step as jts
    real = (jts.TrainConfig, jts.make_train_step, jio.load_pipeline,
            sys.argv, os.environ.get("BLOBCTRL_NO_COMPILE_CACHE"))
    losses = []

    def make(*a, **k):
        step = real[1](*a, **k)

        def run(*args):
            state, m = step(*args)
            losses.append(float(m["loss"]))
            return state, m
        return run

    def load(*a, **k):
        return real[2](*a, **dict(k, dtype=jnp.float32))
    jts.TrainConfig = functools.partial(real[0], compute_dtype=jnp.float32)
    jts.make_train_step, jio.load_pipeline = make, load
    sys.argv = ["train_cli", *argv, "--data_parallel", "1"]
    os.environ["BLOBCTRL_NO_COMPILE_CACHE"] = "1"
    try:
        jcli.main()
    finally:
        jts.TrainConfig, jts.make_train_step, jio.load_pipeline, sys.argv = \
            real[:4]
        if real[4] is None:
            os.environ.pop("BLOBCTRL_NO_COMPILE_CACHE", None)
        else:
            os.environ["BLOBCTRL_NO_COMPILE_CACHE"] = real[4]
    return losses


def cli_argv(models_root, data_root, ckpt_dir, steps, *extra):
    """The argv both CLIs take in these runs: size 64, 2 a batch, a
    checkpoint every 2 steps, rank 4, lr 1e-3."""
    return ["--models_root", models_root, "--data_root", data_root,
            "--size", "64", "--batch_size", "2", "--ckpt_every", "2",
            "--log_every", "1", "--lora_rank", "4", "--learning_rate",
            "1e-3", "--ckpt_dir", ckpt_dir, "--steps", str(steps), *extra]
