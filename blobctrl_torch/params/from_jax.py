"""Weights carried across from the JAX package's parameter pytrees.

A JAX param tree is nested dicts and lists of arrays whose key names are
those of ``init_unet`` / ``init_blobnet`` / ``init_vae`` and of the JAX
converters (the encoders, SAM, the safety checker); the port's modules
read exactly those names and layouts (conv kernels HWIO, linear kernels
(in, out), SAM's transposed-conv kernels (kh, kw, c_out, c_in)), so the
conversion is one walk that turns every leaf into a tensor on the target
device and dtype. This is the one place where a layout change would go.

``load_safetensors`` is the numpy-only reader of ``params.io``, named here
for the toy checkpoints' loader.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.params.io import load_safetensors  # noqa: F401


def from_jax(tree, device="cuda", dtype=torch.float32):
    """JAX param pytree (numpy or JAX arrays at the leaves) -> the same
    structure with torch tensors on ``device``; floating leaves in
    ``dtype``, except ``w_scale`` (fp32); integer leaves (``kernel_q``)
    keep their integer type."""
    dev = resolve_device(device)

    def conv(node, name=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.asarray(node)
        if np.issubdtype(arr.dtype, np.floating):
            # the int8 weights' per-output-channel scales stay fp32, as the
            # JAX package applies them
            t = torch.from_numpy(np.array(arr, np.float32))
            return t.to(dev, torch.float32 if name == "w_scale" else dtype)
        return torch.from_numpy(np.array(arr)).to(dev)

    return conv(tree)


def unflatten(flat: Dict[str, np.ndarray]):
    """{"a.b.0.c": x} -> {"a": {"b": [{"c": x}]}}: dotted names back into a
    pytree, all-digit keys becoming lists."""
    nested: dict = {}
    for k, v in flat.items():
        node = nested
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(p.isdigit() for p in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(nested)
