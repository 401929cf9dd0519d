"""Weights carried across from the JAX package's parameter pytrees.

A JAX param tree is nested dicts and lists of arrays whose key names are
those of ``init_unet`` / ``init_blobnet`` / ``init_vae``; the port's
modules read exactly those names and layouts (conv kernels HWIO, linear
kernels (in, out)), so the conversion is one walk that turns every leaf
into a tensor on the target device and dtype. This is the one place where
a layout change would go.

Also a numpy-only safetensors reader (the u64 header length, the JSON
header, raw little-endian data), so checkpoints load where the
``safetensors`` package is not installed.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from blobctrl_torch import resolve_device

_ST_DTYPES = {"F16": np.float16, "F32": np.float32}


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


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """name -> array, from a .safetensors file."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{name}: unsupported dtype {info['dtype']}")
        dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
        start, end = info["data_offsets"]
        arr = np.frombuffer(data, dtype=dt,
                            count=(end - start) // dt.itemsize,
                            offset=base + start)
        out[name] = arr.reshape(info["shape"])
    return out


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
