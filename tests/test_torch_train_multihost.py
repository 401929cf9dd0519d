"""The port's multi-host training form against the JAX package's, on the
CPU: the same argv (``tests/jax_train_cli.cli_argv``'s, on
``benchkit.write_tiny_training_roots``' roots) with ``--coordinator ...
--num_processes 2 --process_id h --data_parallel 4``, run by JAX's CLI as
2 processes of 2 virtual devices (``tests/jax_train_cli.py``) and by the
port's as 2 hosts of 2 gloo ranks (``tests/torch_ranks.py``), both in
fp32. Each host loads --batch_size 2 rows of its stride of the data set
a step, so the global batch is 4.

Held: each rank's rows and draws (its slice of JAX's global batch), each
step's loss and the first step's averaged gradients, the final state,
``img_per_sec`` over the global batch and the collective log; then a
checkpoint moving both ways between the two forms, each resumed run
against the other form resumed from the same checkpoint (both CLIs
restart their loader on --resume, so that run, not the uninterrupted
one, trains the batch a resumed step 3 trains). About 100 s on 8 cores,
JAX's processes most of it."""

import os
import pickle
import shutil

import numpy as np
import pytest

from blobctrl_torch.parallel import multihost
from blobctrl_torch.train import checkpoint as tckpt
from blobctrl_torch.train import train_step as tts
from blobctrl_torch.utils import benchkit
from tests.jax_train_cli import cli_argv, start_processes
from tests.test_torch_train_cli import _states_agree, _steps_agree
from tests.torch_ranks import start_hosts, wait_processes

HOSTS, RANKS, BATCH, STEPS = 2, 2, 2, 2   # RANKS a host, BATCH a host
SHAPE = (8, 8, 4)                          # the latents at --size 64


def _jax(argv, out):
    """JAX's CLI on ``argv`` as HOSTS processes of RANKS devices; each
    pickles its record to out/jax{h}.pkl."""
    return start_processes(argv, out, HOSTS, RANKS, multihost.free_port(),
                           HOSTS * RANKS)


def _port(argv, out):
    """The port's CLI on ``argv`` as HOSTS host processes, each spawning
    its other RANKS - 1 ranks; every rank pickles its record to
    out/rank{g}.pkl."""
    return start_hosts([*argv, "--device", "cpu"], out, HOSTS,
                       HOSTS * RANKS, multihost.free_port())


def _wait(procs, timeout=400):
    done = wait_processes(procs, timeout)
    assert [c for c, _ in done] == [0] * len(procs), "\n".join(
        f"process {i}, exit code {c}:\n{out[-3000:]}"
        for i, (c, out) in enumerate(done) if c)


def _load(out, names):
    recs = []
    for name in names:
        with open(os.path.join(out, f"{name}.pkl"), "rb") as f:
            recs.append(pickle.load(f))
    return recs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both forms STEPS steps from scratch, side by side; as each ends,
    runs resumed from its checkpoint to STEPS + 1: the port's and JAX's
    from the port's, JAX's and the port's from JAX's. -> {run: (records,
    checkpoint directory)}: "jax", "port", "port_resumed",
    "jax_from_port", "jax_resumed", "port_from_jax"."""
    work = tmp_path_factory.mktemp("multihost")
    roots = str(work / "models"), str(work / "data")
    benchkit.write_tiny_training_roots(*roots)
    dirs = {k: str(work / k) for k in ("jax", "port", "port_resumed",
                                        "jax_from_port", "jax_resumed",
                                        "port_from_jax")}
    for d in dirs.values():
        os.makedirs(d)

    def argv(run, steps, *extra):
        return cli_argv(*roots, os.path.join(dirs[run], "ckpts"), steps,
                        *extra)

    def resume(start, run, src):
        shutil.copytree(os.path.join(dirs[src], "ckpts"),
                        os.path.join(dirs[run], "ckpts"))
        return start(argv(run, STEPS + 1, "--resume"), dirs[run])
    jax_run = _jax(argv("jax", STEPS), dirs["jax"])
    _wait(_port(argv("port", STEPS), dirs["port"]))
    later = (resume(_port, "port_resumed", "port")
             + resume(_jax, "jax_from_port", "port"))
    _wait(jax_run)
    later += (resume(_jax, "jax_resumed", "jax")
              + resume(_port, "port_from_jax", "jax"))
    _wait(later)
    out = {}
    for run, d in dirs.items():
        names = ([f"jax{h}" for h in range(HOSTS)] if run.startswith("jax")
                 else [f"rank{g}" for g in range(HOSTS * RANKS)])
        out[run] = _load(d, names), os.path.join(d, "ckpts")
    return out


def test_host_rows_are_the_global_batchs_contiguous_rows():
    """Host h's local rank r of N, each host loading B rows, trains
    global rows h*B + local_rows(B, N, r): the contiguous split of the
    global batch H*B over the H*N ranks in rank order."""
    for hosts, local, batch in ((2, 2, 2), (2, 4, 8), (3, 1, 5), (4, 2, 6)):
        for h in range(hosts):
            for r in range(local):
                assert multihost.host_rows(batch, local, r, h) == \
                    multihost.local_rows(hosts * batch, hosts * local,
                                         h * local + r)


def test_each_rank_trains_its_rows_of_jaxs_global_batch(runs):
    """Rank r of host h trains, at every step, rows local_rows(B, N, r)
    of the batch JAX's process h loads from its stride (the same
    examples), which JAX's global array holds at rows
    ``host_rows(B, N, r, h)``; its t and noise are those rows of JAX's
    draws for the global batch of 4, bit-equal."""
    import jax
    import jax.numpy as jnp
    jax_recs, _ = runs["jax"]
    port_recs, _ = runs["port"]
    for g, rec in enumerate(port_recs):
        h, r = divmod(g, RANKS)
        mine = multihost.local_rows(BATCH, RANKS, r)
        want = jax_recs[h]
        assert len(want["examples"]) == len(want["rows"]) == STEPS
        for step in range(STEPS):
            assert rec["seen"][step] == \
                want["examples"][step][mine.start:mine.stop], (g, step)
            batch, rows, t, noise = rec["draws"][step]
            assert batch == HOSTS * BATCH
            assert list(rows) == want["rows"][step][mine.start:mine.stop]
            assert rows == multihost.host_rows(BATCH, RANKS, r, h)
            rng_t, rng_n = jax.random.split(jax.random.PRNGKey(step))
            np.testing.assert_array_equal(t, np.asarray(jax.random.randint(
                rng_t, (batch,), 0, 1000))[rows.start:rows.stop])
            np.testing.assert_array_equal(noise, np.asarray(
                jax.random.normal(rng_n, (batch,) + SHAPE, jnp.float32))[
                    rows.start:rows.stop])


def test_the_hosts_train_jaxs_steps(runs):
    """Every rank's step losses JAX's within 1e-6, the first step's
    averaged gradients within 1e-5 of each leaf's max |gradient|
    (``_steps_agree``; JAX's read off Adam's first moment), and the final
    checkpoint, which global rank 0 alone writes, JAX's 2-process one
    within the multi-step bar. Global rank 0 alone narrates, its
    img_per_sec over the global batch of 4; every rank's collective log
    is ``training_counts``' for 4 ranks."""
    (jax_recs, jax_ckpts), (port_recs, port_ckpts) = runs["jax"], \
        runs["port"]
    # JAX's record holds the first step's gradients alone, which are all
    # that _steps_agree reads
    want = {"loss": jax_recs[0]["loss"],
            "grads": [jax_recs[0]["grads"]] + [None] * (STEPS - 1)}
    assert jax_recs[1]["loss"] == want["loss"]
    state = tckpt.restore(port_ckpts, device="cpu")
    counts = tts.training_counts(state["params"], HOSTS * RANKS,
                                 steps=STEPS, replicated=state,
                                 checkpoints=1)
    for g, rec in enumerate(port_recs):
        _steps_agree(rec["steps"], want)
        assert rec["sizes"] == counts, g
        logged = [e for e in rec["events"] if e.get("event") == "train"]
        assert len(logged) == (STEPS if g == 0 else 0), g
        for e in logged:
            dt = e["sec_per_step"]
            assert abs(e["img_per_sec"] - HOSTS * BATCH / dt) <= \
                0.005 + HOSTS * BATCH * 5e-4 / (dt * (dt - 5e-4)), e
    assert os.listdir(port_ckpts) == ["step_00000002"]
    _states_agree(state, tckpt.restore(jax_ckpts, device="cpu"), STEPS)


@pytest.mark.parametrize("run", ["jax_from_port", "port_from_jax"])
def test_a_checkpoint_moves_between_the_multihost_forms(runs, run):
    """JAX's 2 processes resume the step-2 checkpoint the port's 2 x 2
    ranks saved, and the port's ranks resume the one JAX's 2 processes
    saved (``ocdbt.process_0`` and ``ocdbt.process_1``). Each is held
    against the other form resumed from the same checkpoint: JAX from
    the port's against the port's ranks resumed from their own, the port
    from JAX's against JAX's processes resumed from theirs. Every
    process's step-3 loss within 1e-6 of the other form's, the final
    state within ``test_torch_train_step.py``'s multi-step bar. Both CLIs
    restart their loader on --resume, so a resumed run, not the
    uninterrupted one, trains what a resumed step 3 trains. In the port
    only global rank 0 reads the checkpoint, and every rank of both hosts
    starts from the state it broadcasts."""
    other = {"jax_from_port": "port_resumed", "port_from_jax": "jax_resumed"}
    (want_recs, want_ckpts), (recs, ckpts) = runs[other[run]], runs[run]
    assert {"ocdbt.process_0", "ocdbt.process_1"} <= set(os.listdir(
        os.path.join(runs["jax"][1], "step_00000002")))

    def losses(name, recs):
        if name.startswith("jax"):
            return [rec["loss"] for rec in recs]
        resumed = [[e["step"] for e in rec["events"]
                    if e.get("event") == "resumed"] for rec in recs]
        assert resumed == [[STEPS]] + [[]] * (HOSTS * RANKS - 1)
        return [rec["steps"]["loss"] for rec in recs]
    (want,) = losses(other[run], want_recs)[0]
    for got in losses(run, recs):
        assert len(got) == 1 and abs(got[0] - want) <= 1e-6 * abs(want), (
            got, want)
    _states_agree(tckpt.restore(ckpts, device="cpu"),
                  tckpt.restore(want_ckpts, device="cpu"), STEPS + 1)
