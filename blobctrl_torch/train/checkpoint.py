"""Training checkpoints in the JAX package's format, and the export to
the reference formats (counterpart of ``blobctrl_tpu/train/checkpoint.py``).

A save is a ``step_NNNNNNNN`` directory, written under a temporary name
and renamed into place, that the JAX package's ``restore`` (orbax,
``blobctrl_tpu/train/checkpoint.py``) reads with JAX's abstract state:
``_METADATA`` (the tree, its key tuples and each leaf's shape),
``_sharding`` (each array on device 0, or over the mesh of a run over
several hosts),
``_CHECKPOINT_METADATA`` and an OCDBT database of zarr v2 arrays
(``params/ocdbt.py``, ``params/zarr.py``), written without orbax or
tensorstore, which neither machine of the port has. The tree is JAX's:
``params``, ``ema`` when on, ``step`` (int32) and ``opt_state``, optax's
chain of clip, adamw's ``ScaleByAdamState`` (count, mu, nu), the decay's
empty state and the learning rate's: empty for a constant rate,
``ScaleByScheduleState`` (count) under a schedule, as ``make_lr`` says.

``restore`` reads that format, as orbax wrote it on either machine (the
OCDBT root with ``ocdbt.process_N/`` below it, several chunks an array),
and the port's earlier one (``state.safetensors`` + ``state.json``). It
gives the port's state: ``opt_state`` is ``{count, mu, nu}``, ``step`` and
``count`` Python ints, every tree key-sorted (as a fresh state's); both
counts of the chain must equal the step and the clip's and decay's
states must be empty. ``saved_schedule`` says whether the saved chain
holds a schedule's count, which the port's state leaves to its
``TrainConfig``. Layouts are NHWC/HWIO in both packages: no leaf is
transposed.

The exports write the trained BlobNet in diffusers' BlobNetModel keys and
the LoRA in PEFT's, fp32, with the JAX package's key inversion (the same
as ``params.export``'s).
"""

from __future__ import annotations

import base64
import json
import os
import re
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.nn.layers import sorted_tree
from blobctrl_torch.params import export, ocdbt, zarr
from blobctrl_torch.params.io import load_safetensors

METADATA, CHECKPOINT_METADATA, SHARDING = ("_METADATA",
                                           "_CHECKPOINT_METADATA",
                                           "_sharding")
# the port's earlier format, still read
STATE_FILE, LAYOUT_FILE = "state.safetensors", "state.json"
_TENSOR = "__tensor__"  # a layout leaf: {"__tensor__": name}
_DICT, _SEQ = 2, 1      # orbax's key types
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
READ_THREADS = 8


def _replicated(devices: Optional[int]) -> str:
    """An array's sharding as the JAX package's training CLI saves it:
    replicated over its mesh of data x model. One process (``devices``
    None): the mesh 1 x 1 of device 0, whatever the platform (orbax finds
    the device by its id). Several processes: ``devices`` x 1, its devices
    left unnamed, so that orbax lays the resuming run's ``jax.devices()``
    over it, as that CLI's mesh does (device ids differ by platform)."""
    sharding = {"sharding_type": "NamedSharding",
                "shape": [1 if devices is None else devices, 1],
                "axis_names": ["data", "model"],
                "axis_types": ["AxisType.Auto", "AxisType.Auto"],
                "partition_spec": []}
    if devices is None:
        sharding["device_mesh"] = {"mesh": [[{"id": 0}]]}
    return json.dumps(sharding)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def has_schedule(cfg) -> bool:
    """Whether JAX's ``make_lr`` returns a schedule for ``cfg`` (and its
    optimizer state then holds the schedule's count)."""
    return cfg.lr_schedule == "cosine" or cfg.lr_warmup_steps > 0


def _tree_leaves(tree, keys):
    """(key tuple of (key, key type), leaf) in JAX's order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], keys + ((str(k), _DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, keys + ((str(i), _SEQ),))
    else:
        yield keys, tree


def _jax_leaves(state, cfg):
    """The port's train state as the JAX package's tree: (key tuple, leaf)
    in JAX's flatten order, a leaf a tensor or None (an empty optax
    state)."""
    def scalar(v):
        return torch.tensor(int(v), dtype=torch.int32)
    opt = state["opt_state"]
    adam = {"count": scalar(opt["count"]), "mu": opt["mu"], "nu": opt["nu"]}
    o = (("opt_state", _DICT),)
    tree = []
    if "ema" in state:
        tree += list(_tree_leaves(state["ema"], (("ema", _DICT),)))
    tree.append((o + (("0", _SEQ),), None))
    for name in ("count", "mu", "nu"):
        tree += list(_tree_leaves(adam[name], o + (("1", _SEQ), ("0", _SEQ),
                                                   (name, _DICT))))
    tree.append((o + (("1", _SEQ), ("1", _SEQ)), None))
    sched = o + (("1", _SEQ), ("2", _SEQ))
    tree.append((sched + (("count", _DICT),), scalar(opt["count"]))
                if has_schedule(cfg) else (sched, None))
    tree += list(_tree_leaves(state["params"], (("params", _DICT),)))
    tree.append(((("step", _DICT),), scalar(state["step"])))
    return tree


def save(ckpt_dir: str, state, cfg, step: Optional[int] = None,
         devices: Optional[int] = None) -> str:
    """Write the train state of a run under ``cfg`` (a TrainConfig: the
    schedule's count is saved exactly when it has a schedule) in the JAX
    package's format as ``step_NNNNNNNN`` under ckpt_dir
    (``state["step"]`` unless given); an existing one is replaced.
    devices: the data axis of a run over several hosts, which JAX's CLI
    resumes in as many processes over as many devices; None for one
    host. -> its path."""
    s = int(state["step"]) if step is None else int(step)
    final = _step_dir(ckpt_dir, s)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    t0 = time.time_ns()
    leaves = _jax_leaves(state, cfg)
    replicated = _replicated(devices)
    tree_meta, sharding = {}, {}
    # the card's tensors cross through one pinned buffer, each written
    # before the next is copied into it
    staging = zarr.Staging()

    def values():
        for keys, leaf in leaves:
            names = tuple(k for k, _ in keys)
            meta = {"key_metadata": [{"key": k, "key_type": t}
                                     for k, t in keys]}
            if leaf is None:
                meta["value_metadata"] = {"value_type": "None",
                                          "skip_deserialize": True}
            else:
                arr, zdtype = zarr.host_bytes(leaf, staging)
                meta["value_metadata"] = {"value_type": "jax.Array",
                                          "skip_deserialize": False,
                                          "write_shape": list(arr.shape)}
                name = ".".join(names)
                sharding[base64.b64encode(name.encode()).decode()] = \
                    replicated
                yield from zarr.array_items(name, arr, zdtype)
            tree_meta[str(names)] = meta

    ocdbt.write(tmp, values())
    with open(os.path.join(tmp, METADATA), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, SHARDING), "w") as f:
        json.dump(sharding, f)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest N of the exact ``step_N`` directories under ckpt_dir,
    whatever their format, or None: a save cut short leaves ``step_N.tmp``
    (orbax: ``step_N.orbax-checkpoint-tmp-<ts>``), which must neither
    crash a resume nor be picked up by it."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def saved_schedule(ckpt_dir: str, step: int) -> Optional[bool]:
    """Whether the optimizer state saved at ``step`` holds a learning-rate
    schedule's count (``has_schedule`` of the run that saved it), or None
    for the port's earlier format, which did not record it. A resume
    under another schedule would train at another rate, and its next save
    would have a layout that the JAX package's restore refuses."""
    path = os.path.join(_step_dir(ckpt_dir, step), METADATA)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        tree = json.load(f)["tree_metadata"]
    return str(("opt_state", "1", "2", "count")) in tree


def restore(ckpt_dir: str, step: Optional[int] = None, device="cuda"):
    """The train state saved at ``step`` (the latest by default) in the
    JAX package's format or the port's earlier one, its tensors on
    ``device`` in their saved dtypes."""
    dev = resolve_device(device)
    s = step if step is not None else latest_step(ckpt_dir)
    if s is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _step_dir(ckpt_dir, s)
    if os.path.exists(os.path.join(path, LAYOUT_FILE)):
        return _restore_port(path, dev)
    meta_path = os.path.join(path, METADATA)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("use_ocdbt") and not meta.get("use_zarr3"):
            return _restore_jax(path, meta, dev)
    raise ValueError(
        f"{path} is neither a checkpoint of the JAX package (orbax: "
        f"{METADATA} with use_ocdbt, zarr v2) nor of the port's earlier "
        f"format ({LAYOUT_FILE} + {STATE_FILE})")


def _restore_port(path: str, dev):
    with open(os.path.join(path, LAYOUT_FILE)) as f:
        layout = json.load(f)["layout"]
    arrays = load_safetensors(os.path.join(path, STATE_FILE))

    def build(node):
        if isinstance(node, dict):
            if set(node) == {_TENSOR}:
                return torch.from_numpy(arrays[node[_TENSOR]].copy()).to(dev)
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return node

    state = build(layout)
    return _canonical(state)


def _canonical(state):
    """The state's trees key-sorted, as ``train_step.init_train_state``
    makes them (its top level stays in that function's order)."""
    out = {"params": sorted_tree(state["params"]),
           "opt_state": {"count": state["opt_state"]["count"],
                         "mu": sorted_tree(state["opt_state"]["mu"]),
                         "nu": sorted_tree(state["opt_state"]["nu"])},
           "step": state["step"]}
    if "ema" in state:
        out["ema"] = sorted_tree(state["ema"])
    return out


def read_tree(path: str, device="cpu"):
    """The tree of an orbax checkpoint directory as written: dicts for
    dict keys, lists for sequence indices, tensors on ``device`` (their
    saved dtypes), None where orbax saved an empty state. Arrays are read
    on ``READ_THREADS`` threads (the decoder releases the GIL)."""
    dev = resolve_device(device)
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    entries = []
    for info in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in info["key_metadata"]]
        value = info["value_metadata"]
        if value.get("skip_deserialize") or value.get("value_type") == \
                "None":
            entries.append((keys, None))
        elif value.get("value_type") == "jax.Array":
            entries.append((keys, ".".join(k for k, _ in keys)))
        else:
            raise ValueError(f"{path}: leaf {keys} of value type "
                             f"{value.get('value_type')!r}")
    # for the card each thread decodes into its own pinned buffer, then
    # copies the array over (a blocking copy: the buffer is free after it)
    staging = zarr.Staging() if dev.type == "cuda" else None
    with ocdbt.Store(path) as store:
        def load(name):
            arr, zdtype = zarr.read_array(
                store, name, np.empty if staging is None else staging.alloc)
            return zarr.to_torch(arr, zdtype, dev)
        names = [n for _, n in entries if n is not None]
        with ThreadPoolExecutor(READ_THREADS) as pool:
            arrays = dict(zip(names, pool.map(load, names)))
    root: Dict[Any, Any] = {}
    for keys, name in entries:
        node = root
        for k, t in keys[:-1]:
            node = node.setdefault(int(k) if t == _SEQ else k, {})
        k, t = keys[-1]
        node[int(k) if t == _SEQ else k] = None if name is None else \
            arrays[name]

    def lists(node):   # sequence levels become lists, by index
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"{path}: sequence indices {sorted(node)}")
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _restore_jax(path: str, meta: dict, dev):
    tree = read_tree(path, dev)

    def leaf(*keys):
        node = tree
        for k in keys:
            try:
                node = node[k]
            except (KeyError, IndexError, TypeError):
                raise ValueError(
                    f"{path}: no leaf {'.'.join(map(str, keys))}: not the "
                    f"JAX package's train state") from None
        return node

    def count(name, *keys):
        t = leaf(*keys)
        if not torch.is_tensor(t) or t.ndim or t.dtype != torch.int32:
            raise ValueError(f"{path}: {name} must be an int32 scalar")
        return int(t)

    step = count("step", "step")
    adam = leaf("opt_state", 1, 0)
    for name, empty in (("opt_state.0 (the clip's state)", (0,)),
                        ("opt_state.1.1 (the weight decay's state)",
                         (1, 1))):
        if leaf("opt_state", *empty) is not None:
            raise ValueError(f"{path}: {name} must be empty")
    n = count("opt_state.1.0.count", "opt_state", 1, 0, "count")
    if n != step:
        raise ValueError(f"{path}: opt_state.1.0.count (Adam's) is {n} "
                         f"where step is {step}")
    sched = leaf("opt_state", 1, 2)
    if sched is not None:
        m = count("opt_state.1.2.count", "opt_state", 1, 2, "count")
        if m != step:
            raise ValueError(f"{path}: opt_state.1.2.count (the "
                             f"schedule's) is {m} where step is {step}")
    extra = set(tree) - {"params", "opt_state", "step", "ema"}
    if extra or set(adam) != {"count", "mu", "nu"}:
        raise ValueError(f"{path}: not the JAX package's train state "
                         f"({sorted(extra) or sorted(adam)})")
    state = {"params": leaf("params"),
             "opt_state": {"count": n, "mu": adam["mu"], "nu": adam["nu"]},
             "step": step}
    if "ema" in tree:
        state["ema"] = tree["ema"]
    return _canonical(state)


# ---------------------------------------------------------------------------
# export to the reference formats
# ---------------------------------------------------------------------------

def _save(sd: Dict[str, Any], out_path: str) -> Dict[str, Any]:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    export.save_safetensors(out_path, sd, torch.float32)
    return sd


def export_blobnet_safetensors(blobnet_params, out_path: str
                               ) -> Dict[str, Any]:
    """A BlobNet (or UNet-structured) tree -> diffusers-format fp32
    safetensors. -> the state dict written (torch layouts, views)."""
    return _save(export.unet_state_dict(blobnet_params), out_path)


def export_lora_safetensors(lora_params, out_path: str) -> Dict[str, Any]:
    """A LoRA tree -> PEFT-format fp32 safetensors. -> the state dict."""
    return _save(export.lora_state_dict(lora_params), out_path)
