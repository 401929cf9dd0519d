"""The port's reader and writer of the JAX package's checkpoints
(``params/ocdbt.py``, ``params/zarr.py``, ``train/checkpoint.py``) against
the libraries that write them (orbax, tensorstore), which the tests use
as oracles and the port does not import.

- Read: checkpoints that orbax writes, through the JAX package's
  ``checkpoint.save`` and ``ocp.StandardCheckpointer``: each key's bytes
  equal to a ``tensorstore.KvStore`` read, the manifest and the b-tree
  nodes as ``tensorstore.ocdbt.dump`` gives them (interior nodes and a
  version tree included), every array bit-equal to orbax's restore: every
  dtype, scalars, inline and indirect values, several chunks (sharded over
  4 of this process's virtual devices, and saved by two JAX processes),
  and through tensorstore's zarr driver a missing chunk (its fill value)
  and a zero-length axis, which orbax refuses to save.
- Write: what the port writes is read back by tensorstore, by orbax and
  by the JAX package's ``checkpoint.restore`` bit-equal.
- The committed fixture (``tests/data/orbax``, written by
  ``scripts/torch_orbax_fixtures.py``): every leaf bit-equal to orbax's
  restore and to the digests JAX recorded; the weights frame decoded by
  both decoders as libzstd decodes it.
About 45 s, a quarter of it the two JAX processes."""

import base64
import dataclasses
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from blobctrl_tpu.apps import flagship as jflag
from blobctrl_tpu.models import blobnet as jblob
from blobctrl_tpu.models import lora as jlora
from blobctrl_tpu.models import unet as junet
from blobctrl_tpu.train import checkpoint as jckpt
from blobctrl_tpu.train import train_step as jts
from blobctrl_torch.params import ocdbt, zarr
from blobctrl_torch.train import checkpoint as tckpt
from blobctrl_torch.train import train_step as tts
from blobctrl_torch.utils import zstd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax")
torch.set_num_threads(2)


def host(x) -> np.ndarray:
    """An array's bytes as numpy, bf16 as its 16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def assert_bit_equal(got, want, path="tree"):
    """The port's tree (dicts, lists, tensors, None) against a JAX tree
    (dicts, lists, tuples, arrays, None)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_bit_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bit_equal(g, w, f"{path}.{i}")
    elif want is None or (hasattr(want, "_fields") and not want._fields):
        assert got is None, path
    else:
        g, w = host(got), host(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def as_plain(tree):
    """optax's namedtuples as lists, EmptyState as None (orbax's tree)."""
    if isinstance(tree, dict):
        return {k: as_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            if not tree._fields:
                return None
            return {f: as_plain(getattr(tree, f)) for f in tree._fields}
        return [as_plain(v) for v in tree]
    return tree


def ts_values(root: str):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    keys = kv.list().result()
    reads = [kv.read(k) for k in keys]       # all issued, then awaited
    return {k: r.result().value for k, r in zip(keys, reads)}


def check_store(root: str):
    """Keys, bytes, manifest and root node against tensorstore."""
    with ocdbt.Store(root) as store:
        want = ts_values(root)
        assert store.keys() == sorted(want)
        for k, v in want.items():
            assert store.get(k) == bytes(v), k
        base = ts.KvStore.open({"driver": "file",
                                "path": root + "/"}).result()
        assert store.dump() == ts.ocdbt.dump(base).result()
        for v in store.versions:
            loc = v["root"]
            if v["num_keys"]:
                assert store.dump_node(loc) == ts.ocdbt.dump(
                    base, loc.dump("btreenode")).result()
        return store.keys()


def _jax_state(ema, **kw):
    """A LoRA train state at ``benchkit.write_tiny_training_roots``'
    geometry (one level of one layer), its leaves seeded."""
    ucfg, bcfg = jflag.tiny_configs()
    one = dict(block_out_channels=(8,), layers_per_block=1)
    ucfg = dataclasses.replace(ucfg, down_block_has_attn=(True,),
                               up_block_has_attn=(True,), **one)
    bcfg = dataclasses.replace(bcfg, down_block_has_attn=(False,),
                               up_block_has_attn=(False,), **one)
    up = junet.init_unet(jax.random.PRNGKey(1), ucfg)
    bp = jblob.init_blobnet(jax.random.PRNGKey(2), bcfg)
    lora = jlora.init_lora(jax.random.PRNGKey(4), up, rank=4)
    cfg = jts.TrainConfig(ema_decay=ema, **kw)
    state = jts.init_train_state(cfg, bp, lora)
    # moments and step as after training, so no leaf is all zeros
    leaves, treedef = jax.tree_util.tree_flatten(state)
    rng = np.random.RandomState(5)
    leaves = [jnp.asarray(rng.randn(*x.shape).astype(x.dtype)
                          if jnp.issubdtype(x.dtype, jnp.floating)
                          else np.full(x.shape, 3, x.dtype)) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """The JAX package's save of a LoRA train state with an EMA under a
    cosine schedule: (state, checkpoint directory, step directory)."""
    state = _jax_state(0.99, lr_schedule="cosine", lr_total_steps=10,
                       lr_warmup_steps=2)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.save(d, state)
    return state, d, os.path.join(d, "step_00000003")


def test_reader_matches_tensorstore(jax_saved, tmp_path):
    _, _, step_dir = jax_saved
    keys = check_store(step_dir)
    # the root's b-tree reaches into ocdbt.process_0/, a database itself
    assert any(not isinstance(loc, bytes) and loc.base == "ocdbt.process_0/"
               for loc in map(ocdbt.Store(step_dir).location, keys))
    assert check_store(os.path.join(step_dir, "ocdbt.process_0")) == keys
    # how many versions orbax leaves there depends on how tensorstore
    # batches its commits; one more commit to a copy makes several
    copy = str(tmp_path / "process_0")
    shutil.copytree(os.path.join(step_dir, "ocdbt.process_0"), copy)
    ts.KvStore.open({"driver": "ocdbt", "base": f"file://{copy}/"}) \
        .result().write(b"zz/extra", b"x" * 2000).result()
    assert check_store(copy) == sorted(keys + [b"zz/extra"])
    # the manifest holds the newest versions inline and, at some
    # generations, every older one in a version-tree node: count both
    store = ocdbt.Store(copy)
    held = len(store.versions) + sum(
        node["num_generations"] for node in store.version_tree_nodes)
    assert held > 1 and store.generation > 1, (
        store.generation, len(store.versions), store.version_tree_nodes)


def test_reader_walks_interior_nodes_and_version_trees(tmp_path):
    """A database of 40 commits (a version tree under the manifest) with
    nodes of at most 300 bytes (a b-tree of height 3), written by
    tensorstore."""
    root = str(tmp_path / "kv")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    for i in range(40):
        kv.write(f"key{i:03d}/abc".encode(),
                 (f"value{i}" * (1 + i % 5)).encode()).result()
    check_store(root)
    with ocdbt.Store(root) as store:
        assert store.generation == 41 and store.version_tree_nodes
        assert store.versions[-1]["root_height"] >= 2


def test_jax_save_reads_as_orbax_restores(jax_saved):
    state, _, step_dir = jax_saved
    with ocp.StandardCheckpointer() as ckptr:
        want = ckptr.restore(step_dir)
    got = tckpt.read_tree(step_dir)
    assert_bit_equal(got, want)
    assert_bit_equal(got, as_plain(state))


def test_every_dtype_scalars_inline_and_indirect(tmp_path):
    rng = np.random.RandomState(0)
    tree = {
        "f4": jnp.asarray(rng.randn(3, 5).astype(np.float32)),
        "f4_big": jnp.asarray(rng.randn(40, 33).astype(np.float32)),
        "f2": jnp.asarray(rng.randn(7).astype(np.float16)),
        "bf16": jnp.asarray(rng.randn(4, 300), jnp.bfloat16),
        "i4": jnp.asarray(rng.randint(-9, 9, (6,)).astype(np.int32)),
        "u4": jnp.asarray(rng.randint(0, 1 << 31, (5,)).astype(np.uint32)),
        "u1": jnp.arange(11, dtype=jnp.uint8),
        "b1": jnp.asarray(rng.rand(9) > 0.5),
        "scalar": jnp.asarray(np.float32(2.5)), "step": jnp.int32(12),
        "nested": [{"a/b": jnp.ones((2,), jnp.float32)}, None],
    }
    d = str(tmp_path / "ck")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(d, tree)
        want = ckptr.restore(d)
    got = tckpt.read_tree(d)
    assert_bit_equal(got, want)
    assert got["bf16"].dtype == torch.bfloat16 and got["b1"].dtype == \
        torch.bool and got["u4"].dtype == torch.uint32
    with ocdbt.Store(d) as store:
        kinds = {k: isinstance(store.location(k), bytes)
                 for k in store.keys()}
    assert not kinds[b"f4_big/0.0"] and kinds[b"f4/0.0"]    # indirect, inline


def test_several_chunks_sharded_over_four_devices(tmp_path):
    devices = np.array(jax.devices()[:4])
    full = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
    tree = {
        "rows": jax.device_put(full, NamedSharding(Mesh(devices, ("x",)),
                                                   PartitionSpec("x"))),
        "grid": jax.device_put(full, NamedSharding(
            Mesh(devices.reshape(2, 2), ("x", "y")),
            PartitionSpec("x", "y"))),
    }
    d = str(tmp_path / "ck")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(d, tree)
        want = ckptr.restore(d)
    with ocdbt.Store(d) as store:
        assert {k for k in store.keys() if k.startswith(b"grid/")} == {
            b"grid/.zarray", b"grid/0.0", b"grid/0.1", b"grid/1.0",
            b"grid/1.1"}
        assert sum(k.startswith(b"rows/") for k in store.keys()) == 5
    got = tckpt.read_tree(d)
    assert_bit_equal(got, want)
    np.testing.assert_array_equal(got["grid"].numpy(), full)


def test_a_save_by_two_jax_processes(tmp_path):
    """Two processes of 2 devices each write their shards of one array
    into their own ``ocdbt.process_<i>``, merged under the root."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    d = str(tmp_path / "ck")
    worker = os.path.join(ROOT, "tests", "orbax_multiprocess_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(i), str(port), d],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    assert {"ocdbt.process_0", "ocdbt.process_1"} <= set(os.listdir(d))
    got = tckpt.read_tree(d)
    np.testing.assert_array_equal(
        got["w"].numpy(), np.arange(48, dtype=np.float32).reshape(8, 6))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    with ocdbt.Store(d) as store:
        assert sum(k.startswith(b"w/") for k in store.keys()) == 5
    check_store(d)


def test_missing_chunks_and_zero_length_axes(tmp_path):
    """tensorstore's zarr driver over an OCDBT kvstore: an array of six
    chunks of which two are written (the rest read as the fill value,
    null as zeros), and arrays with a zero-length axis."""
    root = str(tmp_path / "kv")

    def make(name, shape, chunks, fill):
        meta = {"chunks": chunks, "dtype": "<f4", "fill_value": fill,
                "compressor": {"id": "zstd", "level": 3}}
        return ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{root}/", "path": name},
            "metadata": meta}, create=True, shape=shape).result()
    rng = np.random.RandomState(3)
    for name, fill in (("nullfill", None), ("fill", 1.5)):
        arr = make(name, [5, 7], [2, 3], fill)
        arr[0:2, 0:3] = rng.randn(2, 3).astype(np.float32)
        arr[4:5, 6:7] = rng.randn(1, 1).astype(np.float32)
    make("empty", [2, 0, 3], [1, 1, 3], None)
    make("empty1", [0], [4], None)
    with ocdbt.Store(root) as store:
        assert sum(k.startswith(b"fill/") for k in store.keys()) == 3
        for name in ("nullfill", "fill", "empty", "empty1"):
            want = ts.open({"driver": "zarr", "kvstore": {
                "driver": "ocdbt", "base": f"file://{root}/",
                "path": name}}).result().read().result()
            got, zdtype = zarr.read_array(store, name)
            assert zdtype == "<f4" and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert got.size == 0


def test_the_ports_save_reads_back_everywhere(jax_saved, tmp_path):
    """The JAX state read by the port and saved by it: tensorstore reads
    every key as the port's reader does, orbax and the JAX package's
    restore give the original state bit for bit."""
    state, ckpt_dir, _ = jax_saved
    tstate = tckpt.restore(ckpt_dir, device="cpu")
    cfg = tts.TrainConfig(ema_decay=0.99, lr_schedule="cosine",
                          lr_total_steps=10, lr_warmup_steps=2)
    out = str(tmp_path / "port")
    path = tckpt.save(out, tstate, cfg)
    check_store(path)
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    back = jckpt.restore(out, abstract)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(host(a), host(b))
    with ocp.StandardCheckpointer() as ckptr:
        assert_bit_equal(tckpt.read_tree(path), ckptr.restore(path))
    with open(os.path.join(path, tckpt.SHARDING)) as f:
        sharding = json.load(f)
    assert base64.b64decode(next(iter(sharding))).decode() == \
        "ema.blobnet.conv_in.bias"


def test_the_ports_writer_makes_interior_nodes_tensorstore_reads(tmp_path):
    rng = np.random.RandomState(0)
    values = [(f"k/{i:05d}{'x' * (i % 7)}".encode(),
               rng.bytes(int(rng.choice([3, 500, 1025, 5000]))))
              for i in range(1500)]
    root = str(tmp_path / "w")
    ocdbt.write(root, values[::-1], max_decoded_node_bytes=4000,
                data_file_bytes=1 << 20)
    assert check_store(root) == sorted(k for k, _ in values)
    with ocdbt.Store(root) as store:
        assert store.versions[0]["root_height"] >= 2
        assert len(os.listdir(os.path.join(root, "d"))) > 2


def test_the_committed_fixture():
    step_dir = os.path.join(FIXTURE, "step_00000002")
    with open(os.path.join(FIXTURE, "jax_run.json")) as f:
        record = json.load(f)
    with ocp.StandardCheckpointer() as ckptr:
        want = ckptr.restore(step_dir)
    got = tckpt.read_tree(step_dir)
    assert_bit_equal(got, want)
    with ocdbt.Store(step_dir) as store:
        assert any(not isinstance(store.location(k), bytes)
                   for k in store.keys())
    check_store(step_dir)
    flat = dict(tckpt._tree_leaves(got, ()))
    leaves = {".".join(k for k, _ in keys): v for keys, v in flat.items()
              if v is not None}
    assert set(leaves) == set(record["leaves"])
    for name, (dtype, shape, digest, total, first) in \
            record["leaves"].items():
        arr = host(leaves[name])
        assert str(arr.dtype) == dtype and list(arr.shape) == shape, name
        assert hashlib.sha256(arr.tobytes()).hexdigest()[:16] == digest
        assert float(arr.astype(np.float64).sum()) == total, name
        assert arr.reshape(-1)[:len(first)].tolist() == first, name
    state = tckpt.restore(FIXTURE, device="cpu")
    assert state["step"] == state["opt_state"]["count"] == 2
    with open(os.path.join(FIXTURE, "weights_l1.zst"), "rb") as f:
        frame = f.read()
    data = zstandard.decompress(frame)
    assert hashlib.sha256(data).hexdigest() == record["weights"]["sha256"]
    assert len(data) == 4 * record["weights"]["elements"]
    assert zstd.decompress(frame) == data
    assert ocdbt.zstd_decompress(frame).tobytes() == data


def test_a_store_without_a_manifest_or_with_a_bad_checksum(tmp_path,
                                                           jax_saved):
    with pytest.raises(FileNotFoundError):
        ocdbt.Store(str(tmp_path))
    d = str(tmp_path / "copy")
    shutil.copytree(jax_saved[2], d)
    path = os.path.join(d, "manifest.ocdbt")
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 1
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.Store(d)
