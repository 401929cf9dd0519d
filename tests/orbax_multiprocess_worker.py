"""One of two JAX processes that save one checkpoint together, for
``tests/test_torch_orbax.py``: ``python tests/orbax_multiprocess_worker.py
<process_id> <coordinator_port> <directory>``. Each process brings up 2
virtual CPU devices and joins the distributed runtime; a (8, 6) float32
array (``np.arange``) sharded by rows over the 4 devices and a replicated
int32 scalar are saved with orbax's ``StandardCheckpointer``, each process
writing its own shards (its ``ocdbt.process_<i>`` database)."""

import os
import sys


def main():
    pid, port, directory = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                               process_id=pid)
    import numpy as np
    import orbax.checkpoint as ocp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    mesh = Mesh(np.array(jax.devices()), ("x",))
    full = np.arange(48, dtype=np.float32).reshape(8, 6)
    rows = NamedSharding(mesh, PartitionSpec("x"))
    arr = jax.make_array_from_callback(full.shape, rows,
                                       lambda idx: full[idx])
    step = jax.make_array_from_callback(
        (), NamedSharding(mesh, PartitionSpec()),
        lambda idx: np.array(7, np.int32))
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(directory, {"w": arr, "step": step})
    print(f"SAVED {pid}", flush=True)


if __name__ == "__main__":
    main()
