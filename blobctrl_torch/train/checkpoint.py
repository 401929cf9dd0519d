"""Training checkpoints and the export to the reference formats
(counterpart of ``blobctrl_tpu/train/checkpoint.py``).

The JAX package saves the train state with orbax, which neither machine
of the port has; the port keeps its own format. Each save is a
``step_NNNNNNNN`` directory, written under a temporary name and renamed
into place, holding ``state.safetensors`` (every tensor of the state,
named by its path, written by ``params.export.save_safetensors``) and
``state.json`` (the tree's layout, its Python numbers and the step).
``restore`` reads it back bit-equal.

The exports write the trained BlobNet in diffusers' BlobNetModel keys and
the LoRA in PEFT's, fp32, with the JAX package's key inversion (the same
as ``params.export``'s).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.params import export
from blobctrl_torch.params.io import load_safetensors

STATE_FILE, LAYOUT_FILE = "state.safetensors", "state.json"
_TENSOR = "__tensor__"  # a layout leaf: {"__tensor__": name}


def _layout(tree, path: str, tensors: Dict[str, torch.Tensor]):
    """The tree with each tensor replaced by its name (collected into
    ``tensors``); numbers stay as they are."""
    if isinstance(tree, dict):
        return {k: _layout(v, f"{path}.{k}", tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v, f"{path}.{i}", tensors) for i, v in enumerate(tree)]
    if torch.is_tensor(tree):
        name = path[1:]
        tensors[name] = tree
        return {_TENSOR: name}
    if isinstance(tree, (int, float)):
        return tree
    raise TypeError(f"{path[1:]}: cannot checkpoint a {type(tree).__name__}")


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    """Write the train state (any tree of dicts, lists, tensors and
    numbers) as ``step_NNNNNNNN`` under ckpt_dir (``state["step"]`` unless
    given); an existing one is replaced. -> its path."""
    s = int(state["step"]) if step is None else int(step)
    final = _step_dir(ckpt_dir, s)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tensors: Dict[str, torch.Tensor] = {}
    layout = _layout(state, "", tensors)
    export.save_safetensors(os.path.join(tmp, STATE_FILE), tensors)
    with open(os.path.join(tmp, LAYOUT_FILE), "w") as f:
        json.dump({"step": s, "layout": layout}, f)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest N of the exact ``step_N`` directories under ckpt_dir, or
    None: a save cut short leaves ``step_N.tmp``, which must neither crash
    a resume nor be picked up by it."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, device="cuda"):
    """The train state saved at ``step`` (the latest by default), its
    tensors on ``device`` in their saved dtypes."""
    dev = resolve_device(device)
    s = step if step is not None else latest_step(ckpt_dir)
    if s is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _step_dir(ckpt_dir, s)
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

    return build(layout)


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
