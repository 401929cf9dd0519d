"""The JAX package's training CLI (``blobctrl_tpu/apps/train_cli.py``'s
``main``) run in this process on an argv, in fp32: its pipeline loaded in
fp32 and ``TrainConfig.compute_dtype`` fp32, as
``tests/torch_ranks.fp32_train_steps`` runs the port's, so that the two
CLIs are held to the fp32 bars of ``tests/test_torch_train_step.py``
(their bf16 rounding would differ more). Nothing in the JAX package
changes: its modules' attributes are swapped for the call and restored.
Used by ``tests/test_torch_train_cli.py``,
``tests/test_torch_train_multihost.py`` and
``scripts/torch_orbax_fixtures.py``.

Run as a script, it is one process of JAX's multi-process form:

  python tests/jax_train_cli.py PROCESS_ID DEVICES OUT -- ARGV...

brings up DEVICES virtual CPU devices with gloo collectives (what
``tests/multihost_worker.py`` sets up), runs the CLI on ARGV (which names
--coordinator, --num_processes and --process_id) and pickles
``run_jax_cli``'s record to OUT. Its compilation cache is
$JAX_TEST_CACHE_DIR, else jax_test_cache in the temporary directory;
``start_processes`` starts such processes."""

import functools
import os
import pickle
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _local(x):
    """A replicated global array's value, read from this process's copy."""
    import numpy as np
    return np.asarray(x.addressable_shards[0].data)


def _adam_mu(opt_state):
    """The ``ScaleByAdamState.mu`` tree inside optax's chain state."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, tuple):
        for s in opt_state:
            mu = _adam_mu(s)
            if mu is not None:
                return mu
    return None


def run_jax_cli(argv, record=None):
    """``main`` of the JAX CLI on ``argv`` (``--data_parallel 1`` unless
    argv names it: the tests' processes hold 8 virtual devices) -> each
    step's loss, in fp32, as floats.

    record: a dict that receives, besides "loss", "grads" (the first
    step's averaged gradients before the clip, in ``tree_leaves`` order:
    Adam's first moment after one step, over 1 - b1, times the clip's
    factor), "examples" (each batch's example indices, into the data set
    this process's loader holds) and "rows" (for each global batch
    ``host_local_batch`` made, the global row that each local row of it
    landed on, read off the global array's shards)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from blobctrl_tpu.apps import train_cli as jcli
    from blobctrl_tpu.params import io as jio
    from blobctrl_tpu.parallel import multihost as jmh
    from blobctrl_tpu.train import checkpoint as jckpt
    from blobctrl_tpu.train import data as jdata
    from blobctrl_tpu.train import train_step as jts
    real = (jts.TrainConfig, jts.make_train_step, jio.load_pipeline,
            jdata.build_example, jdata.collate, jmh.host_local_batch,
            jckpt.save, jckpt.restore, sys.argv,
            os.environ.get("BLOBCTRL_NO_COMPILE_CACHE"))
    rec = {"loss": [], "grads": None, "examples": [], "rows": []}
    made = {}

    def make(*a, **k):
        step = real[1](*a, **k)
        cfg = a[0]
        compiled = []

        def run(*args):
            if not compiled:
                # compile, then meet: gloo's first collective tolerates
                # little skew between the processes' compiles
                compiled.append(step.lower(*args).compile())
                jmh.barrier("train_step_compiled")
            state, m = compiled[0](*args)
            rec["loss"].append(float(_local(m["loss"])))
            if rec["grads"] is None:
                norm = float(_local(m["grad_norm"]))
                scale = max(1.0, norm / cfg.max_grad_norm)
                rec["grads"] = [
                    _local(mu) / np.float32(1 - 0.9) * np.float32(scale)
                    for mu in jax.tree_util.tree_leaves(
                        _adam_mu(state["opt_state"]))]
            return state, m
        return run

    def load(*a, **k):
        return real[2](*a, **dict(k, dtype=jnp.float32))

    def build(*a, **k):
        ex = real[3](*a, **k)
        made[id(ex)] = len(made)
        return ex

    def collate(examples):
        rec["examples"].append([made[id(e)] for e in examples])
        return real[4](examples)

    def host_local_batch(mesh, tree):
        out = real[5](mesh, tree)
        local = np.asarray(tree["x0_latents"])
        rows = [None] * len(local)
        for shard in out["x0_latents"].addressable_shards:
            start = shard.index[0].start or 0
            data = np.asarray(shard.data)
            for j in range(len(data)):
                (i,) = [i for i in range(len(local))
                        if np.array_equal(local[i], data[j])]
                rows[i] = start + j
        rec["rows"].append(rows)
        return out
    def met(fn, tag):
        """fn after every process reaches it: orbax's first collective
        over gloo, like the step's, tolerates little skew."""
        def call(*a, **k):
            jmh.barrier(f"{tag} {len(rec['loss'])}")
            return fn(*a, **k)
        return call
    jts.TrainConfig = functools.partial(real[0], compute_dtype=jnp.float32)
    jckpt.save, jckpt.restore = met(real[6], "save"), met(real[7],
                                                           "restore")
    jts.make_train_step, jio.load_pipeline = make, load
    jdata.build_example, jdata.collate = build, collate
    jmh.host_local_batch = host_local_batch
    if "--data_parallel" not in argv:
        argv = [*argv, "--data_parallel", "1"]
    sys.argv = ["train_cli", *argv]
    os.environ["BLOBCTRL_NO_COMPILE_CACHE"] = "1"
    try:
        jcli.main()
    finally:
        (jts.TrainConfig, jts.make_train_step, jio.load_pipeline,
         jdata.build_example, jdata.collate, jmh.host_local_batch,
         jckpt.save, jckpt.restore, sys.argv) = real[:9]
        if real[9] is None:
            os.environ.pop("BLOBCTRL_NO_COMPILE_CACHE", None)
        else:
            os.environ["BLOBCTRL_NO_COMPILE_CACHE"] = real[9]
    if record is not None:
        record.update(rec)
    return rec["loss"]


def cli_argv(models_root, data_root, ckpt_dir, steps, *extra):
    """The argv both CLIs take in these runs: size 64, 2 a batch, a
    checkpoint every 2 steps, rank 4, lr 1e-3."""
    return ["--models_root", models_root, "--data_root", data_root,
            "--size", "64", "--batch_size", "2", "--ckpt_every", "2",
            "--log_every", "1", "--lora_rank", "4", "--learning_rate",
            "1e-3", "--ckpt_dir", ckpt_dir, "--steps", str(steps), *extra]


def cache_dir():
    """The compilation cache the script's processes share."""
    return os.environ.get("JAX_TEST_CACHE_DIR") or os.path.join(
        tempfile.gettempdir(), "jax_test_cache")


def start_processes(argv, out, processes, devices, port, data_parallel):
    """JAX's CLI on ``argv`` as ``processes`` processes of ``devices``
    virtual CPU devices, meeting at 127.0.0.1:``port`` with
    --data_parallel ``data_parallel``, from the repository root: -> the
    processes (output piped); process p pickles its record to
    out/jax{p}.pkl. They share ``cache_dir()``, named to them."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_TEST_CACHE_DIR=cache_dir())
    env.pop("XLA_FLAGS", None)   # the processes set their own
    env.pop("JAX_PLATFORMS", None)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(p), str(devices),
         os.path.join(out, f"jax{p}.pkl"), "--", *argv, "--coordinator",
         f"127.0.0.1:{port}", "--num_processes", str(processes),
         "--process_id", str(p), "--data_parallel", str(data_parallel)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in range(processes)]


def main():
    pid, devices, out = sys.argv[1:4]
    assert sys.argv[4] == "--", sys.argv
    argv = sys.argv[5:]
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices}")
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    rec = {}
    run_jax_cli(argv, rec)
    assert jax.process_index() == int(pid), (jax.process_index(), pid)
    with open(out, "wb") as f:
        pickle.dump(rec, f)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
