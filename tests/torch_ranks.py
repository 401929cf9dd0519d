"""Run a function on several gloo ranks on the CPU, for the parallel tests.

``run_ranks(target, world, *args)`` spawns ``world`` processes (spawn: the
way the entry points start theirs), each joining one gloo group over
127.0.0.1 with a 120 s collective timeout, and calls ``target(mesh_shape,
*args)`` in each (``target`` must live in an importable module that does
not import JAX: every rank imports it). Returns each rank's result in rank
order. The whole group has its own deadline: a rank that raises, dies or
hangs fails the call within ``timeout`` seconds, and every process is
joined or killed before it returns.

The rank targets below build the toy pipelines and blocks of the tests and
report what each rank saw: its outputs, its collective log and its kernel
launch shapes (recorded by spies on the wrappers, since on the CPU the
wrappers take their plain versions and count nothing).
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import queue
import time
import traceback

import numpy as np

GROUP_TIMEOUT_S = 120.0
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _rank_main(rank, world, port, target, args, out):
    try:
        import torch
        torch.set_num_threads(1)
        from blobctrl_torch.parallel import multihost
        multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                             backend="gloo", timeout_s=GROUP_TIMEOUT_S)
        try:
            out.put((rank, "ok", target(*args)))
        finally:
            multihost.shutdown()
    except BaseException:  # noqa: BLE001 — report, then exit
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(target, world: int, *args, timeout: float = 240.0):
    from blobctrl_torch.parallel import multihost
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = multihost.free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, target, args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout} s ({sorted(results)} did)")
            try:
                rank, status, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not any(p.is_alive() for p in procs):
                    raise RuntimeError(f"ranks died: "
                                       f"{[p.exitcode for p in procs]}")
                continue
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(10.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)


# ---------------------------------------------------------------------------
# rank targets
# ---------------------------------------------------------------------------

def spy_launch_shapes():
    """Record the input shapes of every K1/K5 (flash, exact and int8) and
    K6/K8 (conv3x3, exact and int8) call, which on the CPU go to their plain
    versions: {name: [shapes, ...]}."""
    from blobctrl_torch.ops import conv3x3, flash_attention
    seen = {"flash": [], "flash_int8": [], "conv3x3": [], "conv3x3_int8": []}

    def spy(mod, attr, name):
        real = getattr(mod, attr)

        def wrapper(a, b, *rest, **kw):
            seen[name].append((tuple(a.shape), tuple(b.shape)))
            return real(a, b, *rest, **kw)
        setattr(mod, attr, wrapper)
    spy(flash_attention, "_flash_forward", "flash")
    spy(flash_attention, "_int8_forward", "flash_int8")
    spy(conv3x3, "_conv3x3_forward", "conv3x3")
    spy(conv3x3, "_int8_forward", "conv3x3_int8")
    return seen


def _mesh(shape):
    from blobctrl_torch.parallel import mesh as mesh_lib
    return mesh_lib.make_mesh(**shape)


def _tensor(x):
    import torch
    return torch.as_tensor(np.asarray(x, np.float32))


def block_rank(shape, axes, cases):
    """Blocks on local slices, one case after another: (kind, params,
    inputs, heads, groups) with kind "resnet" (x, temb), "transformer" (x,
    context) or "vae_mid" (x). -> [(output, collective counts)] a case."""
    import torch
    from blobctrl_torch.models import vae
    from blobctrl_torch.nn import attention, resnet
    from blobctrl_torch.params.from_jax import from_jax
    from blobctrl_torch.parallel import collectives
    from blobctrl_torch.parallel import kernel_sharding as ks
    from blobctrl_torch.parallel import mesh as mesh_lib
    mesh = _mesh(shape)
    prof = {"m": ks.KernelProfile(mesh, model=axes)}
    out = []
    for kind, params_np, inputs_np, heads, groups in cases:
        local = mesh_lib.shard_params(mesh, from_jax(params_np, device="cpu"),
                                      True, axes, heads, groups)
        x = [_tensor(a) if a is not None else None for a in inputs_np]
        collectives.reset()
        with torch.no_grad(), ks.activate(prof), ks.scope("m"):
            if kind == "resnet":
                y = resnet.resnet_block(local, x[0], x[1], groups)
            elif kind == "transformer":
                y = attention.transformer_block(local, x[0], heads, x[1])
            else:
                y = vae._mid_block(local, x[0], groups)
        out.append((y.numpy(), collectives.counts()))
    return out


TOY = {"128": "assets/toy_ckpt", "256": "assets/toy_ckpt_256"}


def edit_rank(shape, toy, method, kwargs, recipe, modes=(),
              latents_by_seed=None):
    """The toy pipeline sharded by ``recipe`` ("model", "data" or
    "hybrid"), then ``pipe.method(**kwargs)`` (edit_batch takes
    kwargs["requests"]). modes: "int8" runs it in the int8-everything
    mode. latents_by_seed: {seed: initial latents} in place of the port's
    draws (for deterministic samplers). -> dict(images, counts, shapes,
    digests: BlobNet's residuals of every step, hashed)."""
    import hashlib
    import torch
    from blobctrl_torch.models import blobnet as blobnet_lib
    from blobctrl_torch.parallel import collectives
    from blobctrl_torch.train import toy as ttoy
    from blobctrl_torch.utils import benchkit
    pipe, _ = ttoy.load_toy(TOY[toy], device="cpu")
    mesh = _mesh(shape)
    pipe.shard_to_mesh(mesh, model_parallel=recipe in ("model", "hybrid"),
                       hybrid_cfg_data=recipe == "hybrid")
    if latents_by_seed is not None:
        def seed_noise(seed, shape, device=None):
            seeds = seed if isinstance(seed, (list, tuple)) else [seed]
            lat = torch.cat([torch.as_tensor(np.asarray(
                latents_by_seed[s], np.float32)).reshape(shape)
                for s in seeds])
            return lat, lambda i, s: torch.zeros(tuple(s))
        pipe._seed_noise = seed_noise
    seen = spy_launch_shapes()
    digests = []
    apply = blobnet_lib.blobnet_apply

    def blob(*a, **k):
        res = apply(*a, **k)
        h = hashlib.blake2b(digest_size=8)
        for r in list(res[0]) + [res[1]] + list(res[2]):
            h.update(r.float().numpy().tobytes())
        digests.append(h.hexdigest())
        return res
    blobnet_lib.blobnet_apply = blob
    collectives.reset()
    kw = dict(kwargs)
    ctx = (benchkit.int8_everything() if "int8" in modes
           else contextlib.nullcontext())
    with ctx, torch.no_grad():
        if method == "edit_batch":
            out = pipe.edit_batch(kw.pop("requests"), **kw)
        else:
            out = pipe(**kw)
    return {"images": out.images, "counts": collectives.counts(),
            "shapes": seen, "digests": digests}



def replicate_rank(shape):
    """Rank-dependent leaves through ``multihost.replicate`` and ``fetch``
    (then a barrier). -> (fetched tree, rows this rank owns of 4,
    collective counts)."""
    import torch
    from blobctrl_torch.parallel import collectives, multihost
    rank = multihost.process_index()
    collectives.reset()
    tree = multihost.replicate({"a": torch.full((3,), float(rank)),
                                "b": [torch.arange(2) + rank], "c": 7})
    multihost.barrier("after replicate")
    return (multihost.fetch(tree), list(multihost.local_rows(4)),
            collectives.counts())


def train_dp_rank(trees, batches, draws, runs, ckpt_dir):
    """Data-parallel training of the tiny nets: each rank takes its rows of
    each global batch and of the step's draws. ``trees``: numpy
    {"unet", "blobnet", "lora"}; ``runs``: [(TrainConfig kwargs,
    ``train_step.GRAD_BUCKET_BYTES`` for the run)], each started from a state that rank 1 perturbs before
    ``replicate_state``. Each run ends with a checkpoint (rank 0 writes,
    every rank meets at the barrier). -> per run: {"grads": the averaged
    gradients of the first batch (nothing updated), "metrics": [(loss,
    grad_norm)] a step, "states": [the state, numpy leaves] a step,
    "replicate" / "steps" / "ckpt": the collective log's sizes of the
    replicate, of each step and of the checkpoint, "draw": this rank's
    rows of a drawn global batch}."""
    import torch
    from blobctrl_torch.apps import flagship
    from blobctrl_torch.params.from_jax import from_jax
    from blobctrl_torch.parallel import collectives, multihost
    from blobctrl_torch.train import checkpoint
    from blobctrl_torch.train import train_step as ts
    from blobctrl_torch.utils import threefry
    rank = multihost.process_index()
    b = len(batches[0]["x0_latents"])
    rows = multihost.local_rows(b)
    ucfg, bcfg = flagship.tiny_configs()
    frozen = from_jax(trees["unet"], "cpu")
    out = []
    for kw, bucket in runs:
        ts.GRAD_BUCKET_BYTES = bucket   # this rank's process alone
        cfg = ts.TrainConfig(compute_dtype=torch.float32, remat=False, **kw)
        state = ts.init_train_state(cfg, from_jax(trees["blobnet"], "cpu"),
                                    from_jax(trees["lora"], "cpu"))
        if rank:   # replicate_state must undo this
            for t in ts.tree_leaves(state["params"]):
                t.add_(1.0)
            state["step"] = 7
        collectives.reset()
        state = ts.replicate_state(state)
        rec = {"replicate": collectives.sizes(), "metrics": [], "states": [],
               "steps": []}
        step = ts.make_train_step(cfg, ucfg, bcfg,
                                  group=multihost.world_group())

        def local(i):
            batch = {k: v[rows.start:rows.stop] for k, v in
                     batches[i].items()}
            t, noise = (torch.from_numpy(np.asarray(a)[rows.start:rows.stop])
                        for a in draws[i])
            return batch, t.long(), noise
        loss, grads = step.loss_and_grads(state, frozen, *local(0))
        grads, _ = ts.mean_over_ranks(grads, loss, step.group)
        rec["grads"] = [g.numpy().copy() for g in grads]
        for i in range(len(batches)):
            collectives.reset()
            state, m = step(state, frozen, *local(i))
            rec["steps"].append(collectives.sizes())
            rec["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
            rec["states"].append(ts.tree_map(
                lambda t: t.numpy().copy() if isinstance(t, torch.Tensor)
                else t, state))
        collectives.reset()
        if rank == 0:
            checkpoint.save(ckpt_dir, state, cfg)
        multihost.barrier("checkpoint")
        rec["ckpt"] = collectives.sizes()
        t, noise = ts.draw_t_noise(threefry.key(5), b,
                                   (4, 4, 4), rows=rows)
        rec["draw"] = (t.numpy(), noise.numpy())
        out.append(rec)
    return out


def mismatched_state_rank(refused=False):
    """``replicate_state`` on a train state whose layout differs by rank:
    rank 0's carries an EMA shadow, the others' do not (a checkpoint made
    with EMA resumed without it); with ``refused``, states of one layout
    that rank 0 refuses (a checkpoint that misfits the flags in what the
    layout does not show). -> (the error every rank raised, the
    collective counts)."""
    import torch
    from blobctrl_torch.parallel import collectives, multihost
    from blobctrl_torch.train import train_step as ts
    rank = multihost.process_index()
    cfg = ts.TrainConfig(ema_decay=0.9 if rank == 0 and not refused
                         else 0.0)
    state = ts.init_train_state(cfg, {"w": torch.ones(3, 2)},
                                {"a": torch.zeros(4)})
    collectives.reset()
    try:
        ts.replicate_state(state, refused=refused and rank == 0)
    except ValueError as e:
        return str(e), collectives.counts()
    return None, collectives.counts()


@contextlib.contextmanager
def fp32_train_steps():
    """The training CLI in fp32 (its pipeline loaded in fp32,
    ``TrainConfig.compute_dtype`` fp32), each step's loss and the
    gradients it applied (averaged over the ranks) recorded: yields
    {"loss": [float], "grads": [[numpy]]}, a step each. The CLI trains in
    bf16, whose rounding depends on the rows a call holds and would hide
    the data-parallel arithmetic that the CLI tests compare at fp32
    bars. On the card TF32 is off."""
    import functools
    import torch
    from blobctrl_torch.params import io
    from blobctrl_torch.train import train_step as ts
    real = (ts.TrainConfig, ts.make_train_step, ts.apply_optimizer,
            io.load_pipeline, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    rec = {"loss": [], "grads": []}

    def make(*a, **k):
        step = real[1](*a, **k)

        def run(*args):
            state, m = step(*args)
            rec["loss"].append(float(m["loss"]))
            return state, m
        return run

    def apply(cfg, trainable, opt_state, grads):
        rec["grads"].append([g.detach().cpu().numpy().copy()
                             for g in grads])
        return real[2](cfg, trainable, opt_state, grads)

    def load(*a, **k):
        return real[3](*a, **dict(k, dtype=torch.float32))
    ts.TrainConfig = functools.partial(real[0], compute_dtype=torch.float32)
    ts.make_train_step, ts.apply_optimizer, io.load_pipeline = (
        make, apply, load)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield rec
    finally:
        (ts.TrainConfig, ts.make_train_step, ts.apply_optimizer,
         io.load_pipeline, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = real


@contextlib.contextmanager
def recorded_cli():
    """The training CLI's steps in fp32 (``fp32_train_steps``), with spies
    on its loader, its draws and its log: yields {"seen": the example
    indices of each batch the loader gave this rank, in order, the last
    one possibly drawn after the final step; "steps": the record of
    ``fp32_train_steps``; "draws": (the global batch, the rows drawn, t,
    noise) of each step; "events": the log events, which rank 0 alone
    narrates}."""
    import json
    import logging
    from blobctrl_torch.train import data
    from blobctrl_torch.train import train_step as ts
    out = {"seen": [], "draws": [], "events": []}
    real = data.BlobDataLoader.index_batches, ts.draw_t_noise

    def spy(self):
        for idx in real[0](self):
            out["seen"].append([int(i) for i in idx])
            yield idx

    def draw(key, batch, shape, *a, rows=None, **k):
        t, noise = real[1](key, batch, shape, *a, rows=rows, **k)
        out["draws"].append((batch, rows, t.cpu().numpy(),
                             noise.cpu().numpy()))
        return t, noise

    class Events(logging.Handler):
        def emit(self, record):
            try:
                out["events"].append(json.loads(record.getMessage()))
            except ValueError:
                pass
    handler = Events()
    logging.getLogger("blobctrl_torch").addHandler(handler)
    data.BlobDataLoader.index_batches, ts.draw_t_noise = spy, draw
    try:
        with fp32_train_steps() as out["steps"]:
            yield out
    finally:
        data.BlobDataLoader.index_batches, ts.draw_t_noise = real
        logging.getLogger("blobctrl_torch").removeHandler(handler)


def train_cli_rank(argv, port, coordinator=False):
    """The training CLI on ``argv`` (each ``{rank}`` in it this rank) in
    a group of its own (the group ``run_ranks`` made is left first),
    under ``recorded_cli``: the spawned form's rank body
    ``train_cli.run_rank``, or with ``coordinator`` ``train_cli.main`` as
    one ``--coordinator`` process. -> (the loader's example indices,
    the steps' record, the log events: ``recorded_cli``'s)."""
    from blobctrl_torch.apps import train_cli
    from blobctrl_torch.parallel import multihost
    rank, world = multihost.process_index(), multihost.process_count()
    multihost.shutdown()
    argv = [a.format(rank=rank) for a in argv]
    address = f"127.0.0.1:{port}"
    with recorded_cli() as rec:
        if coordinator:
            train_cli.main(argv + ["--coordinator", address,
                                   "--num_processes", str(world),
                                   "--process_id", str(rank)])
        else:
            train_cli.run_rank(train_cli.build_parser().parse_args(argv),
                               rank, world, address, "gloo", "cpu")
    return rec["seen"], rec["steps"], rec["events"]


def staging_rank():
    """``chip_smoke.py``'s staging counter on a rank (what its ranks
    report to ``scripts/torch_nccl_mesh.py``): -> [collectives, staged
    through host memory] after an all-reduce, an all-gather and a
    broadcast of CPU tensors and a barrier."""
    import torch
    import chip_smoke
    from blobctrl_torch.parallel import collectives, multihost
    seen = chip_smoke.count_staging()
    group = multihost.world_group()
    collectives.all_reduce(torch.ones(3), group)
    collectives.all_gather(torch.ones(2), group)
    collectives.broadcast(torch.ones(1))
    collectives.barrier()
    return list(seen)


def teardown_follower(rank, world, address, conn, flag):
    """A ``multihost.Followers`` target that ends, once told to, only
    after its leader has left the process group (``flag`` exists), as an
    nccl rank's teardown waits for every rank of its group."""
    while conn.recv() is not None:
        pass
    deadline = time.monotonic() + 30.0
    while not os.path.exists(flag):
        if time.monotonic() > deadline:
            raise SystemExit(3)
        time.sleep(0.02)


def spawned_rank(rank, world, port, fail, out):
    """A target of ``chip_smoke.spawn``: 10 x its rank, or rank
    ``fail``'s error."""
    out.put((rank, "error" if rank == fail else "ok", 10 * rank))


# one process of the CLI's --coordinator form (a host), started by
# start_hosts: each of its ranks pickles its record into the directory
# this names
RANK_OUT = "BLOBCTRL_TEST_RANK_OUT"


def _save_rank(rank, rec):
    import pickle
    from blobctrl_torch.parallel import collectives
    rec["sizes"] = collectives.sizes()
    with open(os.path.join(os.environ[RANK_OUT], f"rank{rank}.pkl"),
              "wb") as f:
        pickle.dump(rec, f)


def host_follower(rank, world, address, conn, args, backend):
    """``train_cli._follower`` under ``recorded_cli``, its record saved."""
    import torch
    from blobctrl_torch.apps import train_cli
    torch.set_num_threads(1)
    with recorded_cli() as rec:
        train_cli._follower(rank, world, address, conn, args, backend)
    _save_rank(rank, rec)


def host_main():
    """A host process's body, its argv ``OUT -- ARGV``: ``train_cli.main``
    on ARGV (the --coordinator form, which names the host) under
    ``recorded_cli``, its followers ``host_follower``; every rank of the
    host pickles its record to OUT/rank{rank}.pkl."""
    import sys
    import torch
    from blobctrl_torch.apps import train_cli
    out, sep, *argv = sys.argv[1:]
    assert sep == "--", sys.argv
    os.environ[RANK_OUT] = out
    torch.set_num_threads(1)
    train_cli._follower = host_follower
    with recorded_cli() as rec:
        train_cli.main(argv)
    (rank,) = [e["process"] for e in rec["events"]
               if e.get("event") == "multihost"]
    _save_rank(rank, rec)


def start_host(argv, out, tree=ROOT, env=None):
    """One process of the training CLI on ``argv`` (``host_main``), which
    spawns its host's other ranks: -> the process (output piped); every
    rank pickles its record to out/rank{g}.pkl. tree: the checkout whose
    ``blobctrl_torch`` runs (this one by default; this module is always
    this checkout's, imported from its own directory, where no other
    package named ``tests`` can shadow it); env: more of its
    environment. Without --coordinator in argv this is the spawned form
    (one host, ``--data_parallel`` ranks)."""
    import subprocess
    import sys
    boot = (f"import sys; sys.path[:0] = [{tree!r}, {HERE!r}]; "
            f"import torch_ranks; torch_ranks.host_main()")
    return subprocess.Popen(
        [sys.executable, "-c", boot, out, "--", *argv], cwd=tree,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def start_hosts(argv, out, hosts, data_parallel, port, tree=ROOT,
                env=None):
    """The training CLI on ``argv`` as ``hosts`` --coordinator processes
    (``start_host``) meeting at 127.0.0.1:``port`` with --data_parallel
    ``data_parallel``: -> the processes; env(h): more of host h's
    environment."""
    return [start_host(
        [*argv, "--coordinator", f"127.0.0.1:{port}", "--num_processes",
         str(hosts), "--process_id", str(h), "--data_parallel",
         str(data_parallel)], out, tree, env(h) if env else None)
        for h in range(hosts)]


def wait_processes(procs, timeout):
    """-> [(exit code, output)] of ``procs``, all within ``timeout``
    seconds; any still running then is killed, and every one reaped."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]
