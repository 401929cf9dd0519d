"""Each step's loss of the training CLI's --coordinator form, as some
checkout of the port runs it, against the JAX package's CLI as 2
processes of 2 virtual CPU devices, on the same argv: both in fp32 on the
CPU (``tests/torch_ranks.start_hosts``, ``tests/jax_train_cli.
start_processes``), on ``benchkit.write_tiny_training_roots``' models
root and 8 toy scenes, at --batch_size 2 a process, 2 steps.

  python scripts/torch_multihost_losses.py [--tree DIR] [--processes 2]
      [--data_parallel 4]

--tree: the checkout whose ``blobctrl_torch`` runs (this one by default;
a parent unpacked with ``git archive``); --processes and --data_parallel:
the port's flags (JAX's are always 2 processes, --data_parallel 4).
Prints each run's losses, the global batch the port drew for and the
relative difference of each step's loss."""

import argparse
import os
import pickle
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--data_parallel", type=int, default=4)
    a = ap.parse_args()
    from blobctrl_torch.parallel import multihost
    from blobctrl_torch.utils import benchkit
    from tests.jax_train_cli import cli_argv, start_processes
    from tests.torch_ranks import start_hosts, wait_processes
    work = tempfile.mkdtemp(prefix="multihost_losses_")
    try:
        roots = os.path.join(work, "models"), os.path.join(work, "data")
        benchkit.write_tiny_training_roots(*roots, scenes=8)
        procs = start_processes(cli_argv(*roots, os.path.join(work, "jax"),
                                         2), work, 2, 2,
                                multihost.free_port(), 4)
        procs += start_hosts(
            cli_argv(*roots, os.path.join(work, "ckpts"), 2, "--device",
                     "cpu"), work, a.processes, a.data_parallel,
            multihost.free_port(), tree=a.tree)
        failed = [out[-3000:] for code, out in wait_processes(procs, 900)
                  if code]
        if failed:
            print("\n".join(failed))
            return 1
        recs = []
        for name in ("jax0", "rank0"):
            with open(os.path.join(work, f"{name}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    jax, port = recs[0]["loss"], recs[1]["steps"]["loss"]
    print(f"JAX, 2 processes x 2 devices, global batch 4: {jax}")
    print(f"port, {a.processes} processes, --data_parallel "
          f"{a.data_parallel}, global batch {recs[1]['draws'][0][0]}: "
          f"{port}")
    print(f"relative difference a step: "
          f"{[abs(x - y) / abs(y) for x, y in zip(port, jax)]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
