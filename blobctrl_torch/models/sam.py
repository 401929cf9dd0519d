"""SAM (Segment Anything), the demo's click -> mask step (counterpart of
``blobctrl_tpu/models/sam.py``): the windowed ViT image encoder with
decomposed relative positions and its neck, the point prompt encoder, the
two-way mask decoder, and a ``SamPredictor`` with SAM's host-side pre- and
post-processing.

Plain torch in fp32, as the JAX package leaves all of it to XLA (no Pallas
kernel): the global attention keeps its explicit einsum and relative bias,
in the JAX package's order of operations. The image embedding stays on the
device between clicks. TF32 is off for the length of every device call
(``layers.strict_fp32``), so fp32 means fp32 on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from blobctrl_torch import resolve_device
from blobctrl_torch.nn import layers
from blobctrl_torch.utils import resample


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    # vision encoder
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    patch_size: int = 16
    image_size: int = 1024
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    output_channels: int = 256
    # prompt encoder / mask decoder
    prompt_dim: int = 256
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    layer_norm_eps: float = 1e-6

    @staticmethod
    def vit_h() -> "SAMConfig":
        return SAMConfig()

    @property
    def embed_grid(self) -> int:
        return self.image_size // self.patch_size  # 64


# ---------------------------------------------------------------------------
# vision encoder
# ---------------------------------------------------------------------------

def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                 ) -> torch.Tensor:
    """Relative positional table lookup, linearly interpolated to the span
    it needs when the table is of another length (SAM's get_rel_pos)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    dev = rel_pos.device
    if rel_pos.shape[0] != max_rel_dist:
        # a linear resize along the first axis (F.interpolate 'linear')
        src = rel_pos.float()
        n = src.shape[0]
        scale = n / max_rel_dist
        coords = (torch.arange(max_rel_dist, dtype=torch.float32, device=dev)
                  + 0.5) * scale - 0.5
        coords = torch.clamp(coords, 0, n - 1)
        lo = torch.floor(coords).long()
        hi = torch.clamp(lo + 1, max=n - 1)
        frac = (coords - lo.float())[:, None]
        rel_pos = (src[lo] * (1 - frac) + src[hi] * frac).to(rel_pos.dtype)
    q_coords = (torch.arange(q_size, device=dev)[:, None].float()
                * max(k_size / q_size, 1.0))
    k_coords = (torch.arange(k_size, device=dev)[None, :].float()
                * max(q_size / k_size, 1.0))
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def _vision_attention(params, x: torch.Tensor, heads: int,
                      use_rel_pos: bool = True) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H, W, C), with decomposed relative
    positions."""
    b, h, w, c = x.shape
    d = c // heads
    qkv = layers.linear(params["qkv"], x.reshape(b, h * w, c))
    qkv = qkv.reshape(b, h * w, 3, heads, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3).reshape(b * heads, h * w, d)
               for i in range(3))
    attn = torch.matmul((q * (d ** -0.5)).float(),
                        k.float().transpose(-1, -2))
    if use_rel_pos:
        rh = _get_rel_pos(h, h, params["rel_pos_h"]).float()
        rw = _get_rel_pos(w, w, params["rel_pos_w"]).float()
        r_q = q.reshape(b * heads, h, w, d).float()
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = (attn.reshape(b * heads, h, w, h, w)
                + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
                ).reshape(b * heads, h * w, h * w)
    probs = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v)
    out = out.reshape(b, heads, h * w, d).permute(0, 2, 1, 3).reshape(
        b, h, w, c)
    return layers.linear(params["proj"], out)


def _window_partition(x: torch.Tensor, win: int
                      ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)
    return x, (hp, wp)


def _window_unpartition(x: torch.Tensor, win: int, pad_hw: Tuple[int, int],
                        hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp // win * wp // win)
    x = x.reshape(b, hp // win, wp // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def vision_encoder(params, cfg: SAMConfig, pixel_values: torch.Tensor
                   ) -> torch.Tensor:
    """pixel_values: (B, 1024, 1024, 3) normalized -> (B, 64, 64, 256)."""
    x = layers.conv2d(params["patch_embed"], pixel_values,
                      stride=cfg.patch_size)
    x = x + params["pos_embed"].to(x.dtype)
    eps = cfg.layer_norm_eps
    for i, layer in enumerate(params["layers"]):
        shortcut = x
        h = layers.layer_norm(layer["layer_norm1"], x, eps)
        if i in cfg.global_attn_indexes:
            h = _vision_attention(layer["attn"], h, cfg.num_heads)
        else:
            hw = tuple(h.shape[1:3])
            hwin, pad_hw = _window_partition(h, cfg.window_size)
            hwin = _vision_attention(layer["attn"], hwin, cfg.num_heads)
            h = _window_unpartition(hwin, cfg.window_size, pad_hw, hw)
        x = shortcut + h
        h = layers.layer_norm(layer["layer_norm2"], x, eps)
        h = layers.gelu(layers.linear(layer["mlp"]["lin1"], h))
        x = x + layers.linear(layer["mlp"]["lin2"], h)
    # neck: conv1x1 -> LN -> conv3x3 -> LN (a channels-last LN is SAM's
    # channels-first LayerNorm2d)
    x = layers.conv2d(params["neck"]["conv1"], x)
    x = layers.layer_norm(params["neck"]["layer_norm1"], x, eps)
    x = layers.conv2d(params["neck"]["conv2"], x, padding=1)
    return layers.layer_norm(params["neck"]["layer_norm2"], x, eps)


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def _positional_embed(coords01: torch.Tensor, gaussian_matrix: torch.Tensor
                      ) -> torch.Tensor:
    """coords01 in [0, 1] (..., 2) -> (..., C) random Fourier features."""
    coords = coords01 * 2.0 - 1.0
    coords = torch.matmul(coords, gaussian_matrix.to(coords.dtype))
    coords = 2.0 * math.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def encode_points(params, cfg: SAMConfig, points: torch.Tensor,
                  labels: torch.Tensor, pad_with_not_a_point: bool = True
                  ) -> torch.Tensor:
    """points: (B, N, 2) pixel coordinates in the 1024-padded frame; labels
    (B, N) in {1 positive, 0 negative, -1 padding}. -> the sparse
    embeddings (B, N(+1), C); SAM appends a padding point when there are no
    boxes."""
    if pad_with_not_a_point:
        points = torch.cat([points, torch.zeros(
            (points.shape[0], 1, 2), dtype=points.dtype,
            device=points.device)], 1)
        labels = torch.cat([labels, -torch.ones(
            (labels.shape[0], 1), dtype=labels.dtype,
            device=labels.device)], 1)
    coords = (points + 0.5) / cfg.image_size
    pe = _positional_embed(coords, params["shared_embedding"])
    lb = labels[..., None]
    out = torch.where(lb == -1, params["not_a_point_embed"][None, None], pe)
    out = torch.where(lb == 0, out + params["point_embed"][0][None, None],
                      out)
    return torch.where(lb == 1, out + params["point_embed"][1][None, None],
                       out)


def dense_no_mask_embedding(params, cfg: SAMConfig, batch: int
                            ) -> torch.Tensor:
    g = cfg.embed_grid
    return params["no_mask_embed"][None, None, None, :].expand(
        batch, g, g, cfg.prompt_dim)


def image_grid_pe(params, cfg: SAMConfig) -> torch.Tensor:
    """(grid, grid, C) positional encoding of the image embedding grid."""
    g = cfg.embed_grid
    dev = params["shared_embedding"].device
    ys = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    xs = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    return _positional_embed(grid, params["shared_embedding"])


# ---------------------------------------------------------------------------
# mask decoder (the two-way transformer)
# ---------------------------------------------------------------------------

def _decoder_attn(params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int) -> torch.Tensor:
    b, nq, _ = q.shape
    qp = layers.linear(params["q_proj"], q)
    kp = layers.linear(params["k_proj"], k)
    vp = layers.linear(params["v_proj"], v)
    d = qp.shape[-1] // heads

    def split(t):
        return t.reshape(b, -1, heads, d).permute(0, 2, 1, 3)
    scores = torch.matmul(split(qp).float(),
                          split(kp).float().transpose(-1, -2)) * (d ** -0.5)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, split(vp))
    out = out.permute(0, 2, 1, 3).reshape(b, nq, -1)
    return layers.linear(params["out_proj"], out)


def _mlp(lins, h: torch.Tensor) -> torch.Tensor:
    """A stack of linears with ReLU between them."""
    for j, lin in enumerate(lins):
        h = layers.linear(lin, h)
        if j < len(lins) - 1:
            h = torch.relu(h)
    return h


def mask_decoder(params, cfg: SAMConfig, image_embeddings: torch.Tensor,
                 image_pe: torch.Tensor, sparse_prompt: torch.Tensor,
                 dense_prompt: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embeddings (B, g, g, C); image_pe (g, g, C); sparse_prompt
    (B, N, C); dense_prompt (B, g, g, C). -> (mask logits (B, num_masks,
    4g, 4g), iou predictions (B, num_masks))."""
    b = image_embeddings.shape[0]
    g = cfg.embed_grid
    c = cfg.prompt_dim
    heads = cfg.decoder_heads
    eps = cfg.layer_norm_eps

    num_mask_tokens = cfg.num_multimask_outputs + 1
    output_tokens = torch.cat([params["iou_token"], params["mask_tokens"]], 0)
    tokens = torch.cat([output_tokens[None].expand(b, num_mask_tokens + 1, c),
                        sparse_prompt], 1)

    src = (image_embeddings + dense_prompt).reshape(b, g * g, c)
    pos_src = image_pe.reshape(1, g * g, c).expand(b, g * g, c)

    queries, keys = tokens, src
    for i, layer in enumerate(params["transformer"]["layers"]):
        # self attention on the tokens. Layer 0 (skip_first_layer_pe)
        # REPLACES the queries with the attention output, no residual (SAM's
        # semantics); later layers add the token embeddings as the q/k
        # positions and keep the residual
        if i == 0:
            queries = _decoder_attn(layer["self_attn"], queries, queries,
                                    queries, heads)
        else:
            q = queries + tokens
            queries = queries + _decoder_attn(layer["self_attn"], q, q,
                                              queries, heads)
        queries = layers.layer_norm(layer["layer_norm1"], queries, eps)
        # cross attention, tokens -> image
        q = queries + tokens
        k = keys + pos_src
        attn_out = _decoder_attn(layer["cross_attn_token_to_image"], q, k,
                                 keys, heads)
        queries = layers.layer_norm(layer["layer_norm2"], queries + attn_out,
                                    eps)
        h = layers.linear(layer["mlp"]["lin2"], torch.relu(
            layers.linear(layer["mlp"]["lin1"], queries)))
        queries = layers.layer_norm(layer["layer_norm3"], queries + h, eps)
        # cross attention, image -> tokens
        q = queries + tokens
        k = keys + pos_src
        attn_out = _decoder_attn(layer["cross_attn_image_to_token"], k, q,
                                 queries, heads)
        keys = layers.layer_norm(layer["layer_norm4"], keys + attn_out, eps)

    q = queries + tokens
    k = keys + pos_src
    attn_out = _decoder_attn(
        params["transformer"]["final_attn_token_to_image"], q, k, keys,
        heads)
    queries = layers.layer_norm(params["transformer"]["layer_norm_final_attn"],
                                queries + attn_out, eps)

    iou_token_out = queries[:, 0]
    mask_tokens_out = queries[:, 1:1 + num_mask_tokens]

    # the image embedding upscaled 4x by two transposed convs
    up = _conv_transpose(params["upscale_conv1"], keys.reshape(b, g, g, c),
                         stride=2)
    up = layers.gelu(layers.layer_norm(params["upscale_layer_norm"], up, eps))
    up = layers.gelu(_conv_transpose(params["upscale_conv2"], up, stride=2))

    hyper = torch.stack([_mlp(mlp, mask_tokens_out[:, i]) for i, mlp in
                         enumerate(params["output_hypernetworks_mlps"])], 1)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper, up)
    return masks, _mlp(params["iou_prediction_head"], iou_token_out)


def _conv_transpose(params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """A 2x2 stride-2 transposed conv, torch's ConvTranspose2d: the kernel
    is stored (kh, kw, c_out, c_in), the JAX package's layout for
    ``conv_transpose(transpose_kernel=True)``, and goes back to torch's
    (c_in, c_out, kh, kw) unflipped."""
    w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y.contiguous()


def select_mask(masks: torch.Tensor, iou_pred: torch.Tensor, multimask: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SamPredictor's choice: multimask -> tokens 1..3, else token 0."""
    if multimask:
        return masks[:, 1:], iou_pred[:, 1:]
    return masks[:, :1], iou_pred[:, :1]


# ---------------------------------------------------------------------------
# the predictor (host-side pre- and post-processing, SamPredictor's)
# ---------------------------------------------------------------------------

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def preprocess_image(image_rgb_uint8: np.ndarray, cfg: SAMConfig
                     ) -> Tuple[np.ndarray, Tuple[int, int], Tuple[int, int]]:
    """(H, W, 3) uint8 -> ((1, 1024, 1024, 3) float32, the original (H, W),
    the resized (h', w') before padding): PIL's bilinear resize of the
    longest side to 1024 (ResizeLongestSide), bit for bit."""
    h, w = image_rgb_uint8.shape[:2]
    scale = cfg.image_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    resized = resample.pil_resize(image_rgb_uint8, (nw, nh), "bilinear")
    arr = (resized.astype(np.float32) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
    out = np.zeros((cfg.image_size, cfg.image_size, 3), np.float32)
    out[:nh, :nw] = arr
    return out[None], (h, w), (nh, nw)


def transform_points(points_xy: np.ndarray, orig_hw: Tuple[int, int],
                     cfg: SAMConfig) -> np.ndarray:
    h, w = orig_hw
    scale = cfg.image_size / max(h, w)
    return np.asarray(points_xy, np.float32) * scale


def postprocess_masks(low_res_masks: torch.Tensor, orig_hw: Tuple[int, int],
                      resized_hw: Tuple[int, int], cfg: SAMConfig
                      ) -> np.ndarray:
    """(B, M, 256, 256) logits -> (B, M, H, W) boolean masks: upscaled to
    the padded frame, cropped to the resized image, resized to the
    original, all bilinear in fp32 on the logits' device."""
    m = low_res_masks.float()
    b, nm, gh, gw = m.shape
    m = m.reshape(b * nm, gh, gw, 1)
    m = layers.bilinear_resize(m, cfg.image_size, cfg.image_size)
    m = m[:, :resized_hw[0], :resized_hw[1], :]
    m = layers.bilinear_resize(m, orig_hw[0], orig_hw[1])
    return (m.reshape(b, nm, orig_hw[0], orig_hw[1]) > 0.0).cpu().numpy()


def _tree_device(params) -> torch.device:
    node = params
    while not torch.is_tensor(node):
        node = next(iter(node.values())) if isinstance(node, dict) else node[0]
    return node.device


class SamPredictor:
    """The functional counterpart of segment_anything's SamPredictor, on
    ``device`` (the card unless the caller asks for the CPU). ``params``
    is the tree of ``params.io.load_sam`` (or ``init``) on that device."""

    def __init__(self, params, cfg: SAMConfig = SAMConfig.vit_h(),
                 device="cuda"):
        self.device = resolve_device(device)
        if _tree_device(params).type != self.device.type:
            raise ValueError(f"params live on {_tree_device(params)}, the "
                             f"predictor on {self.device}")
        self.params = params
        self.cfg = cfg
        self._embedding = None
        self._orig_hw = None
        self._resized_hw = None

    @torch.inference_mode()
    def set_image(self, image_rgb_uint8: np.ndarray):
        px, self._orig_hw, self._resized_hw = preprocess_image(
            np.asarray(image_rgb_uint8, np.uint8), self.cfg)
        with layers.strict_fp32(self.device):
            self._embedding = vision_encoder(
                self.params["vision"], self.cfg,
                torch.from_numpy(px).to(self.device))

    @torch.inference_mode()
    def predict(self, point_coords: np.ndarray, point_labels: np.ndarray,
                multimask_output: bool = False):
        """-> (boolean masks (M, H, W), iou predictions (M,), low-res logits
        (M, 256, 256)), numpy, as segment_anything returns them."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        cfg, params, dev = self.cfg, self.params, self.device
        pts = transform_points(point_coords, self._orig_hw, cfg)[None]
        lbs = np.asarray(point_labels, np.int32)[None]
        with layers.strict_fp32(dev):
            sparse = encode_points(params["prompt"], cfg,
                                   torch.from_numpy(pts).to(dev),
                                   torch.from_numpy(lbs).to(dev))
            dense = dense_no_mask_embedding(params["prompt"], cfg, 1)
            pe = image_grid_pe(params["prompt"], cfg)
            masks, iou = mask_decoder(params["decoder"], cfg,
                                      self._embedding, pe, sparse, dense)
            masks, iou = select_mask(masks, iou, multimask_output)
            out = postprocess_masks(masks, self._orig_hw, self._resized_hw,
                                    cfg)
        return out[0], iou[0].cpu().numpy(), masks[0].cpu().numpy()


# ---------------------------------------------------------------------------
# random params at any geometry (the checkpoint's layout)
# ---------------------------------------------------------------------------

def init(cfg: SAMConfig, seed: int = 0, device="cuda", dtype=torch.float32):
    """Random params with ``convert_sam``'s tree structure, drawn on
    ``device``: uniform +-1/sqrt(fan_in) kernels, and biases, norm offsets,
    tables and tokens drawn too (normal, 0.02 about their usual value), so
    that no two leaves of one shape are equal. The decoder's cross
    attentions project to half width, as SAM's do."""
    init_ = layers.ParamInit(seed, resolve_device(device), dtype)
    c, m = cfg.hidden_size, cfg.mlp_dim
    pc = cfg.prompt_dim
    g = cfg.embed_grid
    d = c // cfg.num_heads

    def lin(d_in, d_out, bias=True):
        p = layers.init_linear(init_, d_in, d_out, use_bias=False)
        if bias:
            p["bias"] = init_.normal((d_out,), 0.02)
        return p

    def conv(k, c_in, c_out, bias=True):
        p = layers.init_conv(init_, k, k, c_in, c_out, use_bias=False)
        if bias:
            p["bias"] = init_.normal((c_out,), 0.02)
        return p

    def norm(n):
        return {"scale": 1.0 + init_.normal((n,), 0.02),
                "bias": init_.normal((n,), 0.02)}

    vision = {"patch_embed": conv(cfg.patch_size, 3, c),
              "pos_embed": init_.normal((g, g, c), 0.02), "layers": []}
    for i in range(cfg.num_layers):
        span = 2 * (g if i in cfg.global_attn_indexes
                    else cfg.window_size) - 1
        vision["layers"].append({
            "layer_norm1": norm(c),
            "attn": {"qkv": lin(c, 3 * c), "proj": lin(c, c),
                     "rel_pos_h": init_.normal((span, d), 0.02),
                     "rel_pos_w": init_.normal((span, d), 0.02)},
            "layer_norm2": norm(c),
            "mlp": {"lin1": lin(c, m), "lin2": lin(m, c)}})
    oc = cfg.output_channels
    vision["neck"] = {"conv1": conv(1, c, oc, bias=False),
                      "layer_norm1": norm(oc),
                      "conv2": conv(3, oc, oc, bias=False),
                      "layer_norm2": norm(oc)}

    prompt = {"shared_embedding": init_.normal((2, pc // 2), 1.0),
              "point_embed": init_.normal((4, pc), 1.0),
              "not_a_point_embed": init_.normal((pc,), 1.0),
              "no_mask_embed": init_.normal((pc,), 1.0)}

    def attn(inner):
        return {"q_proj": lin(pc, inner), "k_proj": lin(pc, inner),
                "v_proj": lin(pc, inner), "out_proj": lin(inner, pc)}

    n_masks = cfg.num_multimask_outputs + 1
    tlayers = [{"self_attn": attn(pc), "layer_norm1": norm(pc),
                "cross_attn_token_to_image": attn(pc // 2),
                "layer_norm2": norm(pc),
                "mlp": {"lin1": lin(pc, cfg.decoder_mlp_dim),
                        "lin2": lin(cfg.decoder_mlp_dim, pc)},
                "layer_norm3": norm(pc),
                "cross_attn_image_to_token": attn(pc // 2),
                "layer_norm4": norm(pc)} for _ in range(2)]
    c4, c8 = pc // 4, pc // 8
    decoder = {
        "iou_token": init_.normal((1, pc), 1.0),
        "mask_tokens": init_.normal((n_masks, pc), 1.0),
        "transformer": {"layers": tlayers,
                        "final_attn_token_to_image": attn(pc // 2),
                        "layer_norm_final_attn": norm(pc)},
        # transposed convs, (kh, kw, c_out, c_in)
        "upscale_conv1": {"kernel": init_.uniform((2, 2, c4, pc),
                                                  1.0 / math.sqrt(c4 * 4)),
                          "bias": init_.normal((c4,), 0.02)},
        "upscale_layer_norm": norm(c4),
        "upscale_conv2": {"kernel": init_.uniform((2, 2, c8, c4),
                                                  1.0 / math.sqrt(c8 * 4)),
                          "bias": init_.normal((c8,), 0.02)},
        "output_hypernetworks_mlps": [[lin(pc, pc), lin(pc, pc), lin(pc, c8)]
                                      for _ in range(n_masks)],
        "iou_prediction_head": [lin(pc, pc), lin(pc, pc), lin(pc, n_masks)],
    }
    return {"vision": vision, "prompt": prompt, "decoder": decoder}
