"""Converters: diffusers / transformers state dicts -> the port's param
trees (counterpart of ``blobctrl_tpu/params/convert.py``, the same key
rewriting, numpy and ``re`` only).

Layouts of the trees:
  * conv kernels HWIO (torch OIHW -> transpose (2, 3, 1, 0));
  * linear kernels (in, out) (torch (out, in) -> transpose);
  * norm weight / bias -> scale / bias.

Source key formats: the SD-1.5 UNet and BlobNet as diffusers ModelMixin
state dicts, the VAE as diffusers AutoencoderKL, CLIP text and DINOv2 as
transformers models.

Each ``convert_*`` walks the state dict once and hands every converted
array, a view of the source where the layout allows it, to ``leaf(path,
array)`` before it goes into the tree, so a loader can move one leaf at a
time to its device and dtype. The default leaf keeps a float32 numpy copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

Leaf = Callable[[List, np.ndarray], Any]


def float32_leaf(path: List, arr: np.ndarray) -> np.ndarray:
    """The default leaf: a C-contiguous float32 copy (integers stay)."""
    if np.issubdtype(arr.dtype, np.floating):
        return np.array(arr, np.float32, order="C")
    return np.array(arr, order="C")


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    # a torch tensor (a .bin checkpoint)
    t = t.detach().cpu()
    if str(t.dtype) == "torch.bfloat16":  # numpy has no bfloat16
        t = t.float()
    return t.numpy()


def _set(tree: Dict[str, Any], path: List, value):
    """Insert value at a nested path; integer components index lists."""
    node = tree
    for i, part in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(part, int):
            while len(node) <= part:
                node.append({} if not isinstance(nxt, int) else [])
            if node[part] == {} and isinstance(nxt, int):
                node[part] = []
            node = node[part]
        else:
            if part not in node:
                node[part] = [] if isinstance(nxt, int) else {}
            node = node[part]
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
    node[last] = value


def _tokenize(key: str) -> List:
    return [int(p) if p.isdigit() else p for p in key.split(".")]


def _convert_param(path: List, arr: np.ndarray) -> tuple:
    """(new path, array in the tree's layout) for one torch parameter."""
    *prefix, last = path
    if last == "weight":
        if arr.ndim == 4:
            return prefix + ["kernel"], arr.transpose(2, 3, 1, 0)
        if arr.ndim == 2:
            return prefix + ["kernel"], arr.T
        return prefix + ["scale"], arr
    if last == "bias":
        return prefix + ["bias"], arr
    raise ValueError(f"unhandled param {path}")


def _put(tree, leaf: Optional[Leaf], path: List, arr: np.ndarray):
    _set(tree, path, (leaf or float32_leaf)(path, arr))


# ---------------------------------------------------------------------------
# UNet / BlobNet
# ---------------------------------------------------------------------------

def _rewrite_unet_path(path: List) -> List:
    """A diffusers module path -> the tree path (UNet and BlobNet)."""
    out: List = []
    i = 0
    while i < len(path):
        p = path[i]
        if p == "downsamplers":
            out.append("downsample")
            i += 2  # skip the index 0
        elif p == "upsamplers":
            out.append("upsample")
            i += 2
        elif p == "transformer_blocks":
            out.append("blocks")
            i += 1
        elif p == "to_out":
            out.append("to_out")
            i += 2  # skip ".0" (the Dropout is .1)
        elif p == "ff":
            # ff.net.0.proj -> ff.proj_in; ff.net.2 -> ff.proj_out
            if path[i + 1] != "net":
                raise ValueError(f"unhandled feed-forward path {path}")
            out.append("ff")
            if path[i + 2] == 0:
                out.append("proj_in")
                i += 4
            else:
                out.append("proj_out")
                i += 3
        elif p == "blobnet_down_blocks":
            out.append("zero_down")
            i += 1
        elif p == "blobnet_mid_block":
            out.append("zero_mid")
            i += 1
        elif p == "blobnet_up_blocks":
            out.append("zero_up")
            i += 1
        else:
            out.append(p)
            i += 1
    return out


def convert_unet(state_dict, leaf: Optional[Leaf] = None) -> Dict[str, Any]:
    """A diffusers UNet2DConditionModel (or the reference BlobNetModel)
    state dict -> a UNet (or BlobNet) param tree."""
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        path = _tokenize(key)
        if path[0] == "time_proj" or "conv_act" in path:
            continue  # buffers and parameter-free heads
        new_path, arr = _convert_param(_rewrite_unet_path(path),
                                       _to_np(tensor))
        _put(tree, leaf, new_path, arr)
    return tree


# ---------------------------------------------------------------------------
# VAE (AutoencoderKL)
# ---------------------------------------------------------------------------

def _rewrite_vae_path(path: List) -> List:
    out: List = []
    i = 0
    while i < len(path):
        p = path[i]
        if p == "downsamplers":
            out.append("downsample")
            i += 2
        elif p == "upsamplers":
            out.append("upsample")
            i += 2
        elif p in ("to_q", "to_k", "to_v", "to_out", "group_norm"):
            out.append({"group_norm": "norm"}.get(p, p))
            i += 2 if p == "to_out" else 1
        else:
            out.append(p)
            i += 1
    return out


def convert_vae(state_dict, leaf: Optional[Leaf] = None) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        new_path, arr = _convert_param(_rewrite_vae_path(_tokenize(key)),
                                       _to_np(tensor))
        _put(tree, leaf, new_path, arr)
    return tree


# ---------------------------------------------------------------------------
# CLIP text encoder (transformers CLIPTextModel)
# ---------------------------------------------------------------------------

def convert_clip_text(state_dict, leaf: Optional[Leaf] = None
                      ) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        path = _tokenize(key.replace("text_model.", ""))
        if path[:2] == ["embeddings", "position_ids"]:
            continue
        if path[:2] in (["embeddings", "token_embedding"],
                        ["embeddings", "position_embedding"]):
            _put(tree, leaf, [path[1]], _to_np(tensor))  # (n, d) as it is
            continue
        if path[0] == "encoder":
            path = path[1:]  # encoder.layers.i...
        new_path, arr = _convert_param(path, _to_np(tensor))
        _put(tree, leaf, new_path, arr)
    return tree


# ---------------------------------------------------------------------------
# DINOv2 (transformers Dinov2Model)
# ---------------------------------------------------------------------------

def convert_dinov2(state_dict, leaf: Optional[Leaf] = None) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        path = _tokenize(key)
        arr = _to_np(tensor)
        if path[0] == "embeddings":
            if path[1] == "cls_token":
                _put(tree, leaf, ["cls_token"], arr[0])  # (1, 1, d) -> (1, d)
            elif path[1] == "position_embeddings":
                _put(tree, leaf, ["position_embeddings"], arr[0])
            elif path[1] == "patch_embeddings":
                # the projection conv (d, 3, p, p)
                if path[-1] == "weight":
                    _put(tree, leaf, ["patch_embed", "kernel"],
                         arr.transpose(2, 3, 1, 0))
                else:
                    _put(tree, leaf, ["patch_embed", "bias"], arr)
            continue  # the mask token is unused
        if path[0] == "encoder":
            path = path[1:]
        if path[0] == "layer":
            # encoder.layer.N.attention.attention.query -> layers.N.attn.q
            path = ["layers"] + path[1:]
            if len(path) > 3 and path[2] == "attention":
                if path[3] == "attention":
                    name = {"query": "q", "key": "k", "value": "v"}[path[4]]
                    path = path[:2] + ["attn", name] + path[5:]
                elif path[3] == "output":  # attention.output.dense
                    path = path[:2] + ["attn", "out"] + path[5:]
            if len(path) > 2 and path[2] in ("layer_scale1", "layer_scale2"):
                ls = "ls1" if path[2] == "layer_scale1" else "ls2"
                _put(tree, leaf, path[:2] + [ls], arr)
                continue
        new_path, arr = _convert_param(path, arr)
        _put(tree, leaf, new_path, arr)
    return tree
