"""Writes ``tests/data/orbax/``: what the JAX package's training writes,
for the port's checkpoint reader to be held against where neither JAX,
orbax nor zstandard is installed (``chip_smoke.py`` phase 8e):

- ``step_00000002/``: the JAX training CLI (``blobctrl_tpu/apps/
  train_cli.py``, fp32 as ``tests/jax_train_cli.py`` runs it) after 2 steps
  on ``utils/benchkit.write_tiny_training_roots``' models root and data,
  which the port rebuilds bit for bit; orbax writes it (OCDBT, zarr v2,
  zstd), values above 1 KiB indirect in data files;
- ``jax_run.json``: the argv, JAX's losses at steps 1-4 (the run resumed
  from that directory to 4), and for every leaf of the step-2 state its
  dtype, shape, sha256 (its first 16 hex digits), float64 sum and first
  two elements;
- ``weights_l1.zst``: one zstd level-1 frame (``zstandard``) of 2 MiB of
  fp32 weights from JAX's production init (the SD-1.5 UNet's mid-block
  attn1 to_q kernel for ``PRNGKey(0)``, its first 524,288 elements, drawn
  as ``scripts/torch_init_constants.py`` draws it), and its sha256.

    python scripts/torch_orbax_fixtures.py      (JAX on the CPU, ~1 min)
"""

import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import zstandard  # noqa: E402

from blobctrl_torch.utils import benchkit  # noqa: E402
from tests.jax_train_cli import cli_argv, run_jax_cli  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "orbax")
FIRST = 2            # first elements kept of each leaf
DIGITS = 16          # hex digits kept of each leaf's sha256
WEIGHT_ELEMENTS = 1 << 19


def leaf_table(step_dir):
    """{dotted name: [dtype, shape, sha256, float64 sum, first elements]}
    of every array orbax restores."""
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.restore(step_dir)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        arr = np.asarray(leaf)
        out[name] = [str(arr.dtype), list(arr.shape),
                     hashlib.sha256(arr.tobytes()).hexdigest()[:DIGITS],
                     float(arr.astype(np.float64).sum()),
                     arr.reshape(-1)[:FIRST].tolist()]
    return out


def production_weights():
    path = os.path.join(ROOT, "scripts", "torch_init_constants.py")
    spec = importlib.util.spec_from_file_location("init_constants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tree, seed, _, splits, kind, shape = mod.LEAVES["unet mid attn1 to_q"]
    leaf = np.asarray(mod.draw(seed, splits, kind, shape), np.float32)
    return leaf.reshape(-1)[:WEIGHT_ELEMENTS]


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    with tempfile.TemporaryDirectory() as work:
        models, data = os.path.join(work, "models"), os.path.join(work,
                                                                 "data")
        benchkit.write_tiny_training_roots(models, data)
        ckpts = os.path.join(work, "ckpts")
        first = run_jax_cli(cli_argv(models, data, ckpts, 2))
        shutil.copytree(os.path.join(ckpts, "step_00000002"),
                        os.path.join(OUT, "step_00000002"))
        leaves = leaf_table(os.path.join(ckpts, "step_00000002"))
        later = run_jax_cli(cli_argv(models, data, ckpts, 4, "--resume"))
    weights = production_weights()
    frame = zstandard.ZstdCompressor(level=1).compress(weights.tobytes())
    with open(os.path.join(OUT, "weights_l1.zst"), "wb") as f:
        f.write(frame)
    record = {
        "argv": cli_argv("MODELS", "DATA", "CKPTS", 4, "--resume"),
        "losses": dict(zip(("1", "2", "3", "4"), first + later)),
        "leaves": leaves,
        "weights": {"elements": WEIGHT_ELEMENTS, "sha256": hashlib.sha256(
            weights.tobytes()).hexdigest()}}
    with open(os.path.join(OUT, "jax_run.json"), "w") as f:
        json.dump(record, f, separators=(",", ":"))
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, names in os.walk(OUT) for n in names)
    print(f"wrote {OUT}: {total} bytes; losses {record['losses']}")


if __name__ == "__main__":
    main()
