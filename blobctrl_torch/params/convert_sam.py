"""SAM state dicts -> the port's SAM param tree (counterpart of
``blobctrl_tpu/params/convert_sam.py``, the same key rules, numpy only).
Two key formats, told apart by the vision tower's prefix: transformers'
``SamModel`` and the original ``segment_anything`` checkpoint
(``sam_vit_h_4b8939.pth``, what the reference downloads).

The tree (see ``models/sam.py``):
  vision: patch_embed, pos_embed (g, g, C), layers[i]{layer_norm1,
          attn{qkv, proj, rel_pos_h, rel_pos_w}, layer_norm2, mlp{lin1,
          lin2}}, neck{conv1, layer_norm1, conv2, layer_norm2}
  prompt: shared_embedding (2, C/2), point_embed (4, C), not_a_point_embed,
          no_mask_embed
  decoder: iou_token (1, C), mask_tokens (4, C), transformer{layers[i]{...},
           final_attn_token_to_image, layer_norm_final_attn},
           upscale_conv1/2 (transposed: (kh, kw, c_out, c_in)),
           upscale_layer_norm, output_hypernetworks_mlps[i] (lists of
           linears), iou_prediction_head (a list of linears)

As in ``params.convert``, every converted array (a view of the source
where the layout allows) goes through ``leaf(path, array)`` before it goes
into the tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from blobctrl_torch.params.convert import Leaf, _put, _to_np


def convert_sam(state_dict, leaf: Optional[Leaf] = None) -> Dict[str, Any]:
    """Either key format -> the tree; dispatched on the vision prefix."""
    if any(k.startswith("image_encoder.") for k in state_dict):
        return _convert_original(state_dict, leaf)
    return _convert_transformers(state_dict, leaf)


def _convert_transformers(sd, leaf: Optional[Leaf]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}

    def put(path: List, key: str, layout=None):
        arr = _to_np(sd[key])
        if layout == "lin":
            arr = arr.T
        elif layout in ("conv", "convt"):
            # conv (out, in, kh, kw) -> HWIO; transposed conv (in, out, kh,
            # kw) -> (kh, kw, out, in), the JAX package's layout for
            # conv_transpose(transpose_kernel=True)
            arr = arr.transpose(2, 3, 1, 0)
        elif layout == "row0":
            arr = arr[0]
        _put(tree, leaf, path, arr)

    def linear(path: List, prefix: str):
        put(path + ["kernel"], prefix + ".weight", "lin")
        put(path + ["bias"], prefix + ".bias")

    def norm(path: List, prefix: str):
        put(path + ["scale"], prefix + ".weight")
        put(path + ["bias"], prefix + ".bias")

    def count(prefix: str, part: int) -> int:
        return 1 + max(int(k.split(".")[part]) for k in sd
                       if k.startswith(prefix))

    v = ["vision"]
    put(v + ["patch_embed", "kernel"],
        "vision_encoder.patch_embed.projection.weight", "conv")
    put(v + ["patch_embed", "bias"],
        "vision_encoder.patch_embed.projection.bias")
    put(v + ["pos_embed"], "vision_encoder.pos_embed", "row0")
    for i in range(count("vision_encoder.layers.", 2)):
        p, t = f"vision_encoder.layers.{i}.", v + ["layers", i]
        norm(t + ["layer_norm1"], p + "layer_norm1")
        linear(t + ["attn", "qkv"], p + "attn.qkv")
        linear(t + ["attn", "proj"], p + "attn.proj")
        put(t + ["attn", "rel_pos_h"], p + "attn.rel_pos_h")
        put(t + ["attn", "rel_pos_w"], p + "attn.rel_pos_w")
        norm(t + ["layer_norm2"], p + "layer_norm2")
        linear(t + ["mlp", "lin1"], p + "mlp.lin1")
        linear(t + ["mlp", "lin2"], p + "mlp.lin2")
    put(v + ["neck", "conv1", "kernel"], "vision_encoder.neck.conv1.weight",
        "conv")
    norm(v + ["neck", "layer_norm1"], "vision_encoder.neck.layer_norm1")
    put(v + ["neck", "conv2", "kernel"], "vision_encoder.neck.conv2.weight",
        "conv")
    norm(v + ["neck", "layer_norm2"], "vision_encoder.neck.layer_norm2")

    pr = ["prompt"]
    put(pr + ["shared_embedding"],
        "prompt_encoder.shared_embedding.positional_embedding")
    _put(tree, leaf, pr + ["point_embed"], np.stack([
        _to_np(sd[f"prompt_encoder.point_embed.{i}.weight"])[0]
        for i in range(4)]))
    put(pr + ["not_a_point_embed"], "prompt_encoder.not_a_point_embed.weight",
        "row0")
    put(pr + ["no_mask_embed"], "prompt_encoder.no_mask_embed.weight", "row0")

    def attn(path: List, prefix: str):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(path + [n], f"{prefix}.{n}")

    def ff(path: List, prefix: str):
        linear(path + [0], prefix + ".proj_in")
        i = 0
        while f"{prefix}.layers.{i}.weight" in sd:
            linear(path + [1 + i], f"{prefix}.layers.{i}")
            i += 1
        linear(path + [1 + i], prefix + ".proj_out")

    d = ["decoder"]
    put(d + ["iou_token"], "mask_decoder.iou_token.weight")
    put(d + ["mask_tokens"], "mask_decoder.mask_tokens.weight")
    tr = d + ["transformer"]
    for i in range(count("mask_decoder.transformer.layers.", 3)):
        p, t = f"mask_decoder.transformer.layers.{i}", tr + ["layers", i]
        attn(t + ["self_attn"], p + ".self_attn")
        norm(t + ["layer_norm1"], p + ".layer_norm1")
        attn(t + ["cross_attn_token_to_image"],
             p + ".cross_attn_token_to_image")
        norm(t + ["layer_norm2"], p + ".layer_norm2")
        linear(t + ["mlp", "lin1"], p + ".mlp.lin1")
        linear(t + ["mlp", "lin2"], p + ".mlp.lin2")
        norm(t + ["layer_norm3"], p + ".layer_norm3")
        attn(t + ["cross_attn_image_to_token"],
             p + ".cross_attn_image_to_token")
        norm(t + ["layer_norm4"], p + ".layer_norm4")
    attn(tr + ["final_attn_token_to_image"],
         "mask_decoder.transformer.final_attn_token_to_image")
    norm(tr + ["layer_norm_final_attn"],
         "mask_decoder.transformer.layer_norm_final_attn")
    for n in ("upscale_conv1", "upscale_conv2"):
        put(d + [n, "kernel"], f"mask_decoder.{n}.weight", "convt")
        put(d + [n, "bias"], f"mask_decoder.{n}.bias")
    norm(d + ["upscale_layer_norm"], "mask_decoder.upscale_layer_norm")
    for i in range(count("mask_decoder.output_hypernetworks_mlps.", 2)):
        ff(d + ["output_hypernetworks_mlps", i],
           f"mask_decoder.output_hypernetworks_mlps.{i}")
    ff(d + ["iou_prediction_head"], "mask_decoder.iou_prediction_head")
    return tree


# the original checkpoint's key fragments -> transformers', in order
ORIGINAL_RENAMES = (
    ("image_encoder.blocks.", "vision_encoder.layers."),
    ("image_encoder.patch_embed.proj.", "vision_encoder.patch_embed.projection."),
    ("image_encoder.pos_embed", "vision_encoder.pos_embed"),
    (".norm1.", ".layer_norm1."),
    (".norm2.", ".layer_norm2."),
    (".norm3.", ".layer_norm3."),
    (".norm4.", ".layer_norm4."),
    # the neck: Sequential(conv1, LN, conv2, LN)
    ("image_encoder.neck.0.", "vision_encoder.neck.conv1."),
    ("image_encoder.neck.1.", "vision_encoder.neck.layer_norm1."),
    ("image_encoder.neck.2.", "vision_encoder.neck.conv2."),
    ("image_encoder.neck.3.", "vision_encoder.neck.layer_norm2."),
    ("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
     "prompt_encoder.shared_embedding.positional_embedding"),
    ("prompt_encoder.point_embeddings.", "prompt_encoder.point_embed."),
    (".norm_final_attn.", ".layer_norm_final_attn."),
    ("mask_decoder.output_upscaling.0.", "mask_decoder.upscale_conv1."),
    ("mask_decoder.output_upscaling.1.", "mask_decoder.upscale_layer_norm."),
    ("mask_decoder.output_upscaling.3.", "mask_decoder.upscale_conv2."),
)


def _convert_original(sd, leaf: Optional[Leaf]) -> Dict[str, Any]:
    """The original segment_anything keys -> transformers' keys, then the
    transformers converter."""
    remap: Dict[str, Any] = {}
    for k, v in sd.items():
        for old, new in ORIGINAL_RENAMES:
            k = k.replace(old, new)
        remap[k] = v
    # the original MLP heads are layers.{0, 1, ..., n}; transformers' are
    # proj_in, layers.{0, ...}, proj_out
    out: Dict[str, Any] = {}
    for k, v in remap.items():
        if ".layers." in k and ("hypernetworks" in k
                                or "iou_prediction_head" in k):
            head, tail = k.split(".layers.", 1)
            idx, rest = tail.split(".", 1)
            last = max(int(kk.split(".layers.")[1].split(".")[0])
                       for kk in remap if kk.startswith(head + ".layers."))
            i = int(idx)
            if i == 0:
                k = f"{head}.proj_in.{rest}"
            elif i == last:
                k = f"{head}.proj_out.{rest}"
            else:
                k = f"{head}.layers.{i - 1}.{rest}"
        out[k] = v
    return _convert_transformers(out, leaf)
