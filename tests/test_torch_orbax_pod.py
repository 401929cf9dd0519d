"""A checkpoint laid out as a TPU pod saves it, against the port's reader
and writer of the JAX package's checkpoints (``params/ocdbt.py``,
``params/zarr.py``, ``train/checkpoint.py``). Four JAX processes of two
virtual CPU devices (``tests/orbax_pod_worker.py``) save a train state on
a (4, 2) mesh with orbax: an fp32 array chunked 8 ways along both axes, a
bf16 array sharded along one axis and replicated along the other, an
int32 array, a replicated int32 step, and some 600 leaves in all, each
process its shards in its own ``ocdbt.process_<i>`` (orbax splits a
replicated shard among its replicas: every array there is 8 chunks).
Orbax's b-tree nodes hold up to 100 MB, so a real pod's save of a
million keys still has a root of one node; the worker saves with nodes
of ``NODE_BYTES`` so that these 1,300 keys give interior nodes, in the
merged root (height 3) and in every process's database.

- Read: ``ocdbt.Store`` lists and reads the merged root as tensorstore
  does, walking its interior nodes, its values reaching into every
  process's database;
  ``checkpoint.read_tree`` gives every leaf bit-equal to orbax's restore
  of the directory in this one process (onto its 8 devices in the same
  layout), dtypes equal; ``checkpoint.restore`` gives the port's state.
- Write: that state saved by the port as global rank 0 of a run of 8
  ranks saves it (``devices=8``: a (8, 1) ``_sharding`` without device
  ids), restored by four JAX processes onto their (4, 2) mesh, every
  shard bit-equal.
About 15 s, most of it the two sets of JAX processes."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
from jax.sharding import Mesh

from blobctrl_torch.params import ocdbt
from blobctrl_torch.train import checkpoint as tckpt
from blobctrl_torch.train import train_step as tts
from tests.orbax_pod_worker import PROCESSES, SMALL, STEP, _jax_state, \
    pod_state
from tests.test_torch_orbax import as_plain, assert_bit_equal, check_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "orbax_pod_worker.py")
DEVICES = 8


def run_pod(mode: str, directory: str):
    """The worker in ``mode`` as PROCESSES JAX processes on
    ``directory``; -> their outputs, each process having exited 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(i),
                               str(port), directory],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(PROCESSES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    return outs


@pytest.fixture(scope="module")
def pod_saved(tmp_path_factory):
    """The pod's save: -> (checkpoint directory, its step directory)."""
    d = str(tmp_path_factory.mktemp("pod_ckpt"))
    step_dir = os.path.join(d, f"step_{STEP:08d}")
    run_pod("save", step_dir)
    return d, step_dir


def _want():
    params, mu, nu, step = pod_state()
    return {"params": params, "opt_state": {"count": int(step), "mu": mu,
                                            "nu": nu}, "step": int(step)}


def test_the_pods_save_lists_as_tensorstore_lists_it(pod_saved):
    _, step_dir = pod_saved
    keys = check_store(step_dir)
    with ocdbt.Store(step_dir) as store:
        bases = {loc.base for loc in map(store.location, keys)
                 if not isinstance(loc, bytes)}
        chunks = {name: sorted(k for k in keys
                               if k.startswith(f"params.{name}/".encode()))
                  for name in ("grid", "half", "ids")}
        shapes = [json.loads(store.get(f"params.{name}/.zarray".encode()))[
            "chunks"] for name in chunks]
    # the root's b-tree reaches into every process's database, and the
    # processes' databases hold the root's keys between them
    assert bases == {f"ocdbt.process_{i}/" for i in range(PROCESSES)}
    held, heights = [], []
    for i in range(PROCESSES):
        db = os.path.join(step_dir, f"ocdbt.process_{i}")
        held += check_store(db)
        heights.append(root_height(db))
    assert sorted(held) == keys
    # interior nodes in the merged root and in every process's database,
    # walked by the listing and the root's node dumped as tensorstore does
    assert root_height(step_dir) >= 2 and min(heights) >= 1
    # 8 chunks an array, one a device: grid's shards; half's and ids'
    # shards, replicated over 2 and 4 devices, split among their replicas
    assert [len(v) - 1 for v in chunks.values()] == [8, 8, 8]
    assert shapes == [[16, 24], [4, 40], [6, 8]]


def root_height(root: str) -> int:
    """The height of the newest version's b-tree, as its root node has
    it."""
    with ocdbt.Store(root) as store:
        newest = store.versions[-1]
        assert store.dump_node(newest["root"])["height"] == \
            newest["root_height"]
        return newest["root_height"]


def test_the_pods_save_reads_as_orbax_restores_it(pod_saved):
    ckpt_dir, step_dir = pod_saved
    mesh = Mesh(np.array(jax.devices()[:DEVICES]).reshape(
        PROCESSES, DEVICES // PROCESSES), ("x", "y"))
    target = _jax_state(mesh, lambda a, s: jax.ShapeDtypeStruct(
        a.shape, a.dtype, sharding=s))
    with ocp.StandardCheckpointer() as ckptr:
        want = ckptr.restore(step_dir, target)
    got = tckpt.read_tree(step_dir)
    assert_bit_equal(got, as_plain(want))
    state = tckpt.restore(ckpt_dir, device="cpu")
    assert_bit_equal(state, _want())


def test_a_pod_restores_the_ports_save(pod_saved, tmp_path):
    ckpt_dir, _ = pod_saved
    state = tckpt.restore(ckpt_dir, device="cpu")
    path = tckpt.save(str(tmp_path / "port"), state, tts.TrainConfig(),
                      devices=DEVICES)
    with open(os.path.join(path, tckpt.SHARDING)) as f:
        shardings = {json.dumps(v) for v in json.load(f).values()}
    assert len(shardings) == 1
    (sharding,) = (json.loads(json.loads(s)) for s in shardings)
    assert sharding["shape"] == [DEVICES, 1]
    assert "device_mesh" not in sharding
    outs = run_pod("restore", path)
    leaves = 2 + 3 * (3 + SMALL)   # step, count, and params, mu, nu
    for i, out in enumerate(outs):
        assert f"RESTORED {i} {leaves}" in out, out[-2000:]
