"""The training CLI's --coordinator form over NCCL on one machine of four
cards, as 2 hosts of 2 cards: each host's process sees its own 2 cards
(``CUDA_VISIBLE_DEVICES``), as a host does, runs ``train_cli.main`` and
spawns its second rank; all 4 ranks meet at one coordinator. The same
form runs meanwhile over gloo on the CPU as the reference. Both run in
fp32 with TF32 off through ``tests/torch_ranks.py``'s host worker (every
rank records its loader's examples, its draws, its losses and first
gradients), on ``chip_smoke.py`` 10d's roots and flags (the trained 256^2
toy, 2 steps, a checkpoint at the last).

Checked, with 10d's bars: every rank's examples and global rows those of
the CPU's rank, its t bit-equal; its losses within 1e-4 relative and its
first gradients within 1e-3 of each leaf's max; every rank's collective
log ``train_step.training_counts``'; global rank 0's checkpoint against
the CPU run's (``chip_smoke.hosts_state_check``).

Run from the repository root on a machine with 4 cards:

  python scripts/torch_nccl_hosts.py [--out chiprun_out/nccl_hosts.json]

It prints the card's name and power limit, the run's seconds and each
rank's rows and losses, and writes them as JSON to --out. Exit code 1
where a check fails."""

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

HOSTS, RANKS = cs.DP_HOSTS, cs.DP_HOST_RANKS


def hosts(argv, out, device, cards):
    """HOSTS host processes of the form on ``argv``
    (``tests/torch_ranks.start_hosts``); ``cards(h)`` is host h's
    CUDA_VISIBLE_DEVICES."""
    from blobctrl_torch.parallel import multihost
    return cs.tests_module("torch_ranks").start_hosts(
        [*argv, "--device", device], out, HOSTS, HOSTS * RANKS,
        multihost.free_port(),
        env=lambda h: {"CUDA_VISIBLE_DEVICES": cards(h)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=400.0)
    a = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if torch.cuda.device_count() < HOSTS * RANKS:
        print(f"needs {HOSTS * RANKS} cards, {torch.cuda.device_count()} "
              f"visible", flush=True)
        return 1
    work = tempfile.mkdtemp(prefix="nccl_hosts_")
    try:
        return run(a, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(a, card, work):
    from blobctrl_torch.ops import _build
    from blobctrl_torch.train import checkpoint as ckpt_lib
    from blobctrl_torch.train import train_step as ts
    _build.build_all()   # once, before the ranks load the kernels
    cs.write_hosts_roots(work)
    for d in ("nccl", "gloo"):
        os.makedirs(os.path.join(work, d, "records"))
    t0 = time.perf_counter()
    procs = (hosts(cs.hosts_argv(work, os.path.join(work, "nccl", "ckpts")),
                   os.path.join(work, "nccl", "records"), "cuda",
                   lambda h: ",".join(str(h * RANKS + r)
                                      for r in range(RANKS)))
             + hosts(cs.hosts_argv(work, os.path.join(work, "gloo",
                                                      "ckpts")),
                     os.path.join(work, "gloo", "records"), "cpu",
                     lambda h: ""))
    done = cs.tests_module("torch_ranks").wait_processes(procs, a.timeout)
    secs = time.perf_counter() - t0
    failed = [(i, out[-3000:]) for i, (rc, out) in enumerate(done) if rc]
    for i, out in failed:
        print(f"host process {i} failed:\n{out}", flush=True)
    if failed:
        return 1
    recs = {}
    for d in ("nccl", "gloo"):
        recs[d] = []
        for g in range(HOSTS * RANKS):
            with open(os.path.join(work, d, "records", f"rank{g}.pkl"),
                      "rb") as f:
                recs[d].append(pickle.load(f))
    got, want = (ckpt_lib.restore(os.path.join(work, d, "ckpts"),
                                  device="cpu") for d in ("nccl", "gloo"))
    counts = ts.training_counts(got["params"], HOSTS * RANKS,
                                steps=cs.DP_HOST_STEPS, replicated=got,
                                checkpoints=1)
    report, ok = {"card": card, "seconds": secs, "ranks": []}, True
    for g, (n, c) in enumerate(zip(recs["nccl"], recs["gloo"])):
        rel = max(abs(x - y) / abs(y) for x, y in zip(
            n["steps"]["loss"], c["steps"]["loss"]))
        grads = cs.worst_leaf(n["steps"]["grads"][0],
                              c["steps"]["grads"][0])
        rows = [[d[1].start, d[1].stop] for d in n["draws"]]
        same = (n["seen"] == c["seen"]
                and rows == [[d[1].start, d[1].stop] for d in c["draws"]]
                and all(np.array_equal(x[2], y[2])
                        for x, y in zip(n["draws"], c["draws"])))
        good = (same and rel <= 1e-4 and grads <= 1e-3
                and n["sizes"] == counts and c["sizes"] == counts)
        ok &= good
        line = {"rank": g, "host": g // RANKS, "examples": n["seen"],
                "global_rows": rows, "loss": n["steps"]["loss"],
                "cpu_loss": c["steps"]["loss"], "loss_rel": rel,
                "grads_rel": grads, "collectives": n["sizes"], "ok": good}
        report["ranks"].append(line)
        print(json.dumps(line), flush=True)
    held, report["state"] = cs.hosts_state_check(
        got, want, recs["nccl"][0]["steps"]["grads"],
        recs["gloo"][0]["steps"]["grads"])
    print(cs.hosts_state_reading(report["state"]), flush=True)
    ok &= got["step"] == cs.DP_HOST_STEPS and held
    report["ok"] = ok
    print(json.dumps({k: v for k, v in report.items() if k != "ranks"}),
          flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
