"""One of the four JAX processes of a checkpoint laid out as a TPU pod
saves it, for ``tests/test_torch_orbax_pod.py``:

  python tests/orbax_pod_worker.py save|restore <process_id> <port> <dir>

Each process brings up ``LOCAL`` virtual CPU devices and joins the
distributed runtime (gloo collectives); the 8 devices form a (4, 2) mesh
("x", "y"), a process a row, as a pod's hosts and their chips. The state
(``pod_state``) is a train state of the JAX package's shape (params, the
optax chain's clip, Adam and decay states, step) whose params hold an
fp32 array chunked 8 ways along both axes, a bf16 array sharded along
"x" and replicated along "y", an int32 array sharded along "y", and
``SMALL`` small replicated fp32 leaves; mu and nu have the params' shape.

``save``: orbax's ``StandardCheckpointer`` saves it into <dir>, each
process its shards into its own ``ocdbt.process_<i>``, with b-tree nodes
of at most ``NODE_BYTES`` decoded (orbax's own are 100 MB) so that its
b-trees have interior nodes. ``restore``: orbax
restores <dir> onto the same layout, and every shard this process holds
must equal ``pod_state``'s bit for bit, dtype included; it prints
``RESTORED <i> <leaves>``.

``pod_state`` and ``SPECS`` import no JAX: the test reads them too."""

import os
import sys

import ml_dtypes
import numpy as np

PROCESSES, LOCAL = 4, 2
SMALL = 200      # small leaves, their values inline in the b-trees
STEP = 7
NODE_BYTES = 1024
# a params leaf -> its PartitionSpec over ("x", "y"); every other leaf is
# replicated
SPECS = {"grid": ("x", "y"), "half": ("x",), "ids": (None, "y")}


def _params(rng, scale):
    tree = {"grid": (rng.randn(64, 48) * scale).astype(np.float32),
            "half": (rng.randn(32, 40) * scale).astype(ml_dtypes.bfloat16),
            "ids": rng.randint(-1000, 1000, (24, 16)).astype(np.int32),
            "small": {f"w{i:03d}": (rng.randn(3) * scale).astype(np.float32)
                      for i in range(SMALL)}}
    return tree


def pod_state():
    """-> (params, mu, nu, step) as numpy trees, the same in every
    process."""
    rng = np.random.RandomState(21)
    return (_params(rng, 1.0), _params(rng, 1e-3), _params(rng, 1e-6),
            np.int32(STEP))


def _jax_state(mesh, arrays):
    """The train state of global arrays laid out as ``SPECS`` says."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    def place(spec, a):
        return arrays(a, NamedSharding(mesh, PartitionSpec(*spec)))

    def tree(params):
        return {k: ({n: place((), x) for n, x in v.items()}
                    if isinstance(v, dict) else place(SPECS[k], v))
                for k, v in params.items()}
    params, mu, nu, step = pod_state()
    adam = optax.ScaleByAdamState(count=place((), step), mu=tree(mu),
                                  nu=tree(nu))
    return {"params": tree(params),
            "opt_state": (optax.EmptyState(),
                          (adam, optax.EmptyState(), optax.EmptyState())),
            "step": place((), step)}


def main():
    mode, pid, port, directory = sys.argv[1:5]
    pid = int(pid)
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={LOCAL}"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(f"127.0.0.1:{port}",
                               num_processes=PROCESSES, process_id=pid)
    import orbax.checkpoint as ocp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()).reshape(PROCESSES, LOCAL),
                ("x", "y"))
    # gloo's first collective allows little skew: meet before orbax's
    multihost_utils.sync_global_devices(f"before {mode}")
    if mode == "save":
        _small_nodes()
        state = _jax_state(mesh, lambda a, s: jax.make_array_from_callback(
            a.shape, s, lambda idx: a[idx]))
        with ocp.StandardCheckpointer() as ckptr:
            ckptr.save(directory, state)
        print(f"SAVED {pid}", flush=True)
        return
    want = _jax_state(mesh, lambda a, s: a)
    target = _jax_state(mesh, lambda a, s: jax.ShapeDtypeStruct(
        a.shape, a.dtype, sharding=s))
    with ocp.StandardCheckpointer() as ckptr:
        got = ckptr.restore(directory, target)
    pairs = list(zip(jax.tree_util.tree_leaves_with_path(got),
                     jax.tree_util.tree_leaves(want)))
    for (path, g), w in pairs:
        name = jax.tree_util.keystr(path)
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype)
        assert g.sharding.is_equivalent_to(
            target_sharding(target, path), g.ndim), name
        for shard in g.addressable_shards:
            a, b = np.asarray(shard.data), w[shard.index]
            assert a.tobytes() == np.ascontiguousarray(b).tobytes(), name
    print(f"RESTORED {pid} {len(pairs)}", flush=True)


def _small_nodes():
    """Orbax's OCDBT write options with nodes of ``NODE_BYTES``."""
    from orbax.checkpoint._src.serialization import tensorstore_utils as tsu
    write_options = tsu.add_ocdbt_write_options

    def small(spec, *args, **kwargs):
        write_options(spec, *args, **kwargs)
        spec["config"]["max_decoded_node_bytes"] = NODE_BYTES
    tsu.add_ocdbt_write_options = small


def target_sharding(target, path):
    node = target
    for k in path:
        node = (node[k.key] if hasattr(k, "key") else
                getattr(node, k.name) if hasattr(k, "name") else node[k.idx])
    return node.sharding


if __name__ == "__main__":
    main()
