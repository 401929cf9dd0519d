"""LoRA adapters for the UNet (counterpart of ``blobctrl_tpu/models/
lora.py``).

An adapter is a flat dict keyed by the UNet tree path of its target
("down_blocks/0/attentions/0/blocks/0/attn1/to_q"), each entry {"A": (in,
r), "B": (r, out)}; a k x k conv target's A is (kh, kw, in, r). Inference
merges it into the kernels, W += (scale * alpha / r) * A @ B, once at load
and again by the increment when the scale changes; training merges per
step (``merge_lora`` is differentiable in A and B) over a frozen UNet.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from blobctrl_torch.utils import threefry


DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out")


def _attention_paths(params, prefix=()):
    """(path, leaf dict) of every attention projection named in
    ``DEFAULT_TARGETS`` of a UNet tree, in the tree's order."""
    if isinstance(params, dict):
        for k, v in params.items():
            if k in DEFAULT_TARGETS and isinstance(v, dict) and "kernel" in v:
                yield prefix + (k,), v
            else:
                yield from _attention_paths(v, prefix + (k,))
    elif isinstance(params, list):
        for i, v in enumerate(params):
            yield from _attention_paths(v, prefix + (i,))


def init_lora(key, unet_params, rank: int = 16,
              targets: Tuple[str, ...] = DEFAULT_TARGETS,
              device=None) -> Dict[str, Any]:
    """A fresh fp32 adapter over ``targets``: "path/as/string" -> {"A": (in,
    r) standard normal / sqrt(in), "B": (r, out) zeros}, on ``device`` (the
    UNet's by default). The JAX package's ``init_lora`` and its draws for
    ``key`` (``utils.threefry``): in the tree's order, ``key, sub =
    split(key)`` and A from ``normal(sub, (in, r))``."""
    lora: Dict[str, Any] = {}
    for path, leaf in _attention_paths(unet_params):
        if path[-1] not in targets:
            continue
        d_in, d_out = leaf["kernel"].shape
        dev = leaf["kernel"].device if device is None else device
        key, sub = threefry.split(key)
        a = threefry.normal(sub, (d_in, rank), device=dev)
        lora["/".join(map(str, path))] = {
            "A": a / np.float32(math.sqrt(d_in)),
            "B": torch.zeros((rank, d_out), dtype=torch.float32, device=dev)}
    return lora


def _copy_structure(node):
    if isinstance(node, dict):
        return {k: _copy_structure(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_structure(v) for v in node]
    return node


def merge_kernel(kernel: torch.Tensor, ab: Dict[str, torch.Tensor],
                 scale: float, alpha: Optional[float], key: str = ""
                 ) -> torch.Tensor:
    """kernel + (scale * alpha / r) * A @ B, the delta computed in the
    adapter's dtype on its device and rounded to the kernel's dtype, and
    moved to its device, before the add. A linear
    delta lands on a 1x1 conv kernel (HWIO (1, 1, in, out)) through its
    singleton spatial dims; a k x k conv adapter composes as PEFT's does,
    delta[h, w, i, o] = sum_r A[h, w, i, r] * B[r, o]."""
    a, b = ab["A"], ab["B"]
    rank = a.shape[-1]
    eff = scale * (alpha if alpha is not None else rank) / rank
    if a.dim() == 4:
        if tuple(kernel.shape[:2]) != tuple(a.shape[:2]):
            raise ValueError(f"LoRA delta for {key} has spatial dims "
                             f"{tuple(a.shape[:2])} but the target kernel "
                             f"is {tuple(kernel.shape)}")
        delta = torch.einsum("hwir,ro->hwio", a, b) * eff
    else:
        delta = (a @ b) * eff
        if kernel.dim() == 4:
            if tuple(kernel.shape[:2]) != (1, 1):
                raise ValueError(f"LoRA delta for {key} is a linear map but "
                                 f"the target kernel is "
                                 f"{tuple(kernel.shape)}")
            delta = delta[None, None]
    return kernel + delta.to(device=kernel.device, dtype=kernel.dtype)


def _path(key: str) -> List:
    return [int(p) if p.isdigit() else p for p in key.split("/")]


def merge_lora(unet_params, lora: Dict[str, Any], scale: float = 1.0,
               alpha: Optional[float] = None):
    """A NEW param tree with every adapter merged into its target kernel
    (alpha defaults to r: an effective factor of ``scale``). The input tree
    is not changed; untouched leaves are shared."""
    new_params = _copy_structure(unet_params)
    for key, ab in lora.items():
        node = new_params
        for p in _path(key):
            node = node[p]
        node["kernel"] = merge_kernel(node["kernel"], ab, scale, alpha, key)
    return new_params


# ---------------------------------------------------------------------------
# checkpoint conversion (PEFT and diffusers key forms)
# ---------------------------------------------------------------------------

_PEFT_RE = re.compile(
    r"^(?:base_model\.model\.|unet\.)?(?P<body>.+?)\.(?P<ab>lora_[AB])"
    r"(?:\.(?:default|weight))*(?:\.weight)?$")


def _tree_path(body: str) -> str:
    """A diffusers module path -> the UNet tree path of the port."""
    parts = body.split(".")
    norm: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "transformer_blocks":
            norm.append("blocks")
        elif p == "to_out":
            norm.append("to_out")
            if i + 1 < len(parts) and parts[i + 1] == "0":
                i += 1
        elif p == "ff" and parts[i + 1:i + 3] == ["net", "0"]:
            # ff.net.0.proj -> ff/proj_in (the GEGLU input projection)
            norm += ["ff", "proj_in"]
            i += 4 if parts[i + 3:i + 4] == ["proj"] else 3
            continue
        elif p == "ff" and parts[i + 1:i + 3] == ["net", "2"]:
            norm += ["ff", "proj_out"]
            i += 3
            continue
        elif p == "processor":
            i += 1
            continue
        elif (p in ("downsamplers", "upsamplers")
                and parts[i + 1:i + 2] == ["0"]):
            norm.append("downsample" if p == "downsamplers" else "upsample")
            i += 2
            continue
        else:
            norm.append(p)
        i += 1
    return "/".join(norm)


def convert_lora_state_dict(state_dict: Dict[str, Any],
                            alpha: Optional[float] = None) -> Dict[str, Any]:
    """A PEFT or diffusers LoRA state dict -> the adapter dict of float32
    numpy arrays. Keys like
      base_model.model.down_blocks.0.attentions.0.transformer_blocks.0.
        attn1.to_q.lora_A.weight                          (PEFT)
      unet.....attn1.to_q.lora_A.weight, or lora.down / lora.up (diffusers)
    lora_A (r, in) -> A (in, r); lora_B (out, r) -> B (r, out). PEFT's
    Conv2d adapters are 4-D: a 1x1 pair squeezes to a linear map; a k x k
    lora_A (r, in, kh, kw) becomes A (kh, kw, in, r)."""
    out: Dict[str, Any] = {}
    rank = None
    unrecognized: List[str] = []
    for key, tensor in state_dict.items():
        k = key.replace(".lora.down.", ".lora_A.").replace(".lora.up.",
                                                           ".lora_B.")
        m = _PEFT_RE.match(k)
        if not m:
            unrecognized.append(key)
            continue
        ab = m.group("ab")
        arr = np.asarray(tensor.detach().cpu().float().numpy()
                         if hasattr(tensor, "detach") else tensor,
                         np.float32)
        conv_a = None
        if arr.ndim == 4:
            if arr.shape[2:] == (1, 1):
                arr = arr[:, :, 0, 0]
            elif ab == "lora_A":
                conv_a = np.transpose(arr, (2, 3, 1, 0))
            else:
                raise NotImplementedError(
                    f"LoRA lora_B on a {arr.shape[2]}x{arr.shape[3]} conv is "
                    f"not supported: {key} (shape {arr.shape}); PEFT Conv2d "
                    f"adapters always use a 1x1 lora_B")
        elif arr.ndim != 2:
            raise NotImplementedError(
                f"LoRA on a non-linear module is not supported: {key} "
                f"(shape {arr.shape})")
        entry = out.setdefault(_tree_path(m.group("body")), {})
        if ab == "lora_A":
            entry["A"] = np.ascontiguousarray(conv_a if conv_a is not None
                                              else arr.T)
            rank = arr.shape[0]
        else:
            entry["B"] = np.ascontiguousarray(arr.T)
            rank = arr.shape[1]
    if unrecognized:
        raise ValueError(
            f"{len(unrecognized)} LoRA keys not recognized (e.g. "
            f"{unrecognized[:3]}); extend convert_lora_state_dict's mapping")
    if rank is None:
        raise ValueError("no LoRA keys recognized")
    return out
