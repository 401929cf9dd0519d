"""Process-group bring-up and the rank helpers (counterpart of
``blobctrl_tpu/parallel/multihost.py``).

Under explicit SPMD a rank is one process with one device. ``initialize``
starts ``torch.distributed`` with the backend the caller names, never one
picked for it:

  * ``"nccl"``: one card a rank: the card the device names
    (``cuda:K``), or, for bare ``cuda``, ``cuda:r`` for rank r, refused
    when r is not a card of this host (ranks that span several hosts
    each name a card of their host: ``nccl_card``).
  * ``"gloo"``: the CPU, or every rank on the one card the caller names
    (``device="cuda:0"``): the form a one-card machine can run, which
    exercises the local-shard kernels and the collectives (through host
    memory) but neither NCCL nor the recipe's speed.

The group has a finite timeout, so a rank that dies fails the others'
next collective instead of hanging it.

``host_local_batch`` of the JAX package has no counterpart: there is no
global array to assemble, each rank simply keeps its own rows
(``local_rows``; ``host_rows`` where several hosts each load their own
batch, the rows JAX's global array gives their devices). ``replicate``
and ``fetch`` keep their roles: a broadcast from rank 0, and tensors to
host numpy.

``Followers`` runs ranks 1.. of an entry point (the CLI, the server) as
spawned processes fed commands over pipes by rank 0, the process that owns
the entry; ``LeaderPipeline`` forwards each edit to them before running it
itself, so that every rank runs the same collectives. An edit refused
before its first collective (its arguments) is refused on every rank
alike, which then meet at one barrier and serve on (``in_step``); a
failure after it leaves the mesh out of step for good (``OutOfStep``).
"""

from __future__ import annotations

import datetime
import multiprocessing
import socket
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from blobctrl_torch import resolve_device
from blobctrl_torch.parallel import collectives

DEFAULT_TIMEOUT_S = 600.0
BACKENDS = ("nccl", "gloo")
_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device="cuda", backend: str = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group; -> the device this rank runs on.

    coordinator_address: "host:port" (or "tcp://host:port") of rank 0.
    backend: "nccl" or "gloo", named by the caller (see the module
    docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be named: one of {BACKENDS} (nccl: "
                         f"one card a rank; gloo: the CPU, or ranks that "
                         f"share the one card named by device), got "
                         f"{backend!r}")
    if backend == "nccl":
        dev = nccl_card(device, process_id)
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    global _timeout
    _timeout = datetime.timedelta(seconds=timeout_s)
    # nccl is told the rank's card, or it guesses it for a barrier
    card = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout, **card)
    return dev


def nccl_card(device, process_id: int) -> torch.device:
    """The card rank ``process_id`` runs on over nccl: the one ``device``
    names (``cuda:K``), or for bare ``cuda`` ``cuda:process_id``, which
    must be a card of this host. Where the ranks span several hosts, the
    caller passes a rank's index among its host's ranks (as the training
    CLI does) or names its card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("nccl runs on the card: device must be cuda")
    resolve_device(dev)
    cards = torch.cuda.device_count()
    if dev.index is None:
        dev = torch.device("cuda", process_id)
        if process_id >= cards:
            raise RuntimeError(
                f"nccl needs one card a rank: rank {process_id} would run "
                f"on cuda:{process_id}, and this host has {cards} cards; "
                f"ranks on several hosts must each name their card "
                f"(--device cuda:K), or name gloo to share one card")
    elif dev.index >= cards:
        raise RuntimeError(f"{dev} is not a card of this host ({cards} "
                           f"cards)")
    return dev


def new_group(ranks):
    """A sub-group of the world with the world's timeout (``new_group``
    would otherwise take the backend's default, 30 minutes)."""
    return dist.new_group(ranks, timeout=_timeout)


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def world_group():
    """The group of every rank, or None in one process (collectives are
    then the identity)."""
    return dist.group.WORLD if process_count() > 1 else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def local_rows(global_batch: int, count: Optional[int] = None,
               index: Optional[int] = None) -> range:
    """The contiguous rows of ``global_batch`` that position ``index`` of
    ``count`` owns (this process of all of them by default; the pipeline
    passes its data group). The batch must divide evenly: ragged rows would
    desynchronize the ranks."""
    n = process_count() if count is None else count
    i = process_index() if index is None else index
    assert global_batch % n == 0, (global_batch, n)
    per = global_batch // n
    return range(i * per, (i + 1) * per)


def host_rows(batch: int, local: int, index: int, host: int) -> range:
    """The global rows that local rank ``index`` of the ``local`` ranks of
    host ``host`` trains, where every host loads ``batch`` rows of its own:
    ``host * batch + local_rows(batch, local, index)``. This is where JAX's
    ``host_local_batch`` puts them: ``make_mesh`` takes ``jax.devices()``,
    process by process, as the data axis, so process p's rows land at
    global rows [p * batch, (p + 1) * batch), over its devices in order."""
    rows = local_rows(batch, local, index)
    return range(host * batch + rows.start, host * batch + rows.stop)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def replicate(tree, src: int = 0):
    """Every tensor leaf broadcast from rank ``src`` to all ranks (the
    identity in one process)."""
    return _map(lambda t: collectives.broadcast(t, src)
                if isinstance(t, torch.Tensor) else t, tree)


def fetch(tree):
    """Tensor leaves -> host numpy arrays (replicated results: every rank
    holds the same values)."""
    return _map(lambda t: t.detach().cpu().numpy()
                if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def barrier(tag: str = "barrier"):
    """Every rank reaches this point (around checkpoint writes, or to line
    ranks up after their kernels' builds). ``tag`` names it in errors."""
    try:
        collectives.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed: {e}") from e


sync = barrier


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for the coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# entry points over several ranks
# ---------------------------------------------------------------------------

class Followers:
    """Ranks 1..world-1 (or the ``ranks`` given: a host's ranks after its
    first) as spawned processes (CUDA cannot fork), each running
    ``target(rank, world, address, conn, *args)`` with ``conn`` the read
    end of its command pipe. The caller, the rank before them, sends
    commands with ``send``; a follower that reads None ends. ``close``
    sends None, leaves the group, joins and, after ``join_timeout_s``,
    kills the stragglers."""

    def __init__(self, target: Callable, world: int, address: str,
                 args: Sequence = (), join_timeout_s: float = 60.0,
                 ranks: Optional[Sequence[int]] = None):
        ctx = multiprocessing.get_context("spawn")
        self.join_timeout_s = join_timeout_s
        self.ranks = list(range(1, world) if ranks is None else ranks)
        self.procs: List = []
        self.conns: List = []
        for rank in self.ranks:
            r, w = ctx.Pipe(duplex=False)
            p = ctx.Process(target=target,
                            args=(rank, world, address, r) + tuple(args),
                            daemon=True, name=f"blobctrl-rank{rank}")
            p.start()
            r.close()
            self.procs.append(p)
            self.conns.append(w)

    def send(self, cmd):
        """The same command to every follower; RuntimeError when one has
        died (its pipe is closed)."""
        for rank, p, c in zip(self.ranks, self.procs, self.conns):
            if not p.is_alive():
                raise RuntimeError(f"rank {rank} of the mesh has died "
                                   f"(exit code {p.exitcode})")
            try:
                c.send(cmd)
            except (BrokenPipeError, OSError) as e:
                raise RuntimeError(f"rank {rank} of the mesh is gone: "
                                   f"{e}") from e

    def close(self) -> List[Optional[int]]:
        """Stop every follower, leave the process group, then join them;
        -> their exit codes. nccl tears a group down with all of its
        ranks at once: a follower leaving the group waits for this rank
        to leave it too, so this rank must not wait for the followers
        before it leaves."""
        for c in self.conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
            c.close()
        shutdown()
        for p in self.procs:
            p.join(self.join_timeout_s)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        return [p.exitcode for p in self.procs]


class OutOfStep(RuntimeError):
    """An edit failed after its first collective: the ranks may no longer
    meet at the same collectives."""


def in_step(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` as one rank of an edit that every rank runs.
    An error raised before fn's first collective comes from the arguments,
    which every rank shares, so every rank raises it: the ranks meet at one
    barrier, which keeps them in step, and the error is raised as it was.
    An error after the first collective, or at that barrier, is raised as
    ``OutOfStep``."""
    start = collectives.mark()
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        if collectives.since(start):
            raise OutOfStep(f"{type(e).__name__}: {e}") from e
        try:
            collectives.barrier()
        except Exception as b:
            raise OutOfStep(f"{type(e).__name__}: {e}, then the ranks did "
                            f"not meet: {b}") from b
        raise


def follow(conn, run: Callable):
    """A follower's loop: ``run(cmd)`` for each command read from ``conn``
    until None or the leader's end of the pipe closes."""
    while True:
        try:
            cmd = conn.recv()
        except (EOFError, OSError):
            return
        if cmd is None:
            return
        run(cmd)


# arguments an edit's followers never see: they only observe (previews)
_LEADER_ONLY = ("callback_on_step_end", "callback_on_step_end_tensor_inputs",
                "callback_interval")


class LeaderPipeline:
    """Rank 0's pipeline: each ``__call__`` / ``edit_batch`` goes to the
    followers first, then runs here, so every rank runs the same edit and
    meets the same collectives. Everything else is the pipeline's own.
    An edit refused by its arguments raises as it would unsharded; after
    an edit fails out of step (``in_step``), or a follower is gone, every
    later edit raises."""

    def __init__(self, pipeline, followers: Followers):
        self.pipeline = pipeline
        self.followers = followers
        self.failed: Optional[str] = None

    def __getattr__(self, name):
        return getattr(self.pipeline, name)

    def _run(self, method: str, args, kwargs):
        if self.failed:
            raise RuntimeError(f"the mesh failed an earlier edit "
                               f"({self.failed}); restart the server")
        fwd = {k: v for k, v in kwargs.items() if k not in _LEADER_ONLY}
        try:
            self.followers.send((method, args, fwd))
        except RuntimeError as e:
            self.failed = str(e)
            raise
        try:
            return in_step(getattr(self.pipeline, method), *args, **kwargs)
        except OutOfStep as e:
            self.failed = str(e)
            raise

    def __call__(self, **kwargs):
        return self._run("__call__", (), kwargs)

    def edit_batch(self, requests, **kwargs):
        return self._run("edit_batch", (requests,), kwargs)

    def close(self) -> List[Optional[int]]:
        """Stop the followers, leave the process group, join the
        followers; -> their exit codes."""
        return self.followers.close()


def run_followed(pipeline, cmd):
    """A follower's side of ``LeaderPipeline``: the same call, its result
    dropped (rank 0 holds the gathered images). An edit refused by its
    arguments is dropped too (rank 0 answers it with the same error); an
    ``OutOfStep`` failure ends the follower."""
    method, args, kwargs = cmd
    try:
        in_step(getattr(pipeline, method), *args, **kwargs)
    except OutOfStep:
        raise
    except Exception:  # noqa: BLE001 — the request's error, not the mesh's
        pass

