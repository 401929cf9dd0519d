"""The from-scratch toy BlobCtrl (counterpart of ``blobctrl_tpu/train/
toy.py``): synthetic "coloured ellipse on a gradient" scenes, the toy VAE
and the diffusion training (BlobNet + the full UNet, the production
objective of ``train/train_step.py``), and the trained checkpoints
(``assets/toy_ckpt``, ``assets/toy_ckpt_256``): configs, the fixed class
embeddings, ``save_toy`` and ``load_toy``; and the evaluation half, the
quality gate's surface: the pipeline kwargs of a move, a two-blob compose
and a remove edit on a scene, ``psnr`` and ``color_error_inside``.

The scenes follow the inference path's conventions: bg conditioning is the
image with the object region blacked; in some examples a distractor
region clear of the objects is whited (the move edit's vacated region);
about 10 % carry no object (an all-background score, remove mode) and 10 %
a dropped text embedding (classifier-free guidance)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import checkpoint

from blobctrl_torch import resolve_device
from blobctrl_torch.blob import editor as editor_lib
from blobctrl_torch.blob import math as blob_math
from blobctrl_torch.blob import viz as viz_lib
from blobctrl_torch.models import blobnet as blobnet_lib
from blobctrl_torch.models import unet as unet_lib
from blobctrl_torch.models import vae as vae_lib
from blobctrl_torch.params import export
from blobctrl_torch.params import from_jax as fj
from blobctrl_torch.train import train_step as ts
from blobctrl_torch.utils import threefry

# (name, RGB): class identity is both the "prompt" and the "appearance"
COLORS = (("red", (214, 48, 38)), ("green", (52, 168, 83)),
          ("blue", (66, 103, 210)), ("yellow", (233, 196, 34)),
          ("magenta", (186, 60, 170)), ("cyan", (58, 186, 186)))


def toy_configs(ctx: int = 16, dino_c: int = 16, size: int = 128):
    """2-level nets at size 128, 3-level at size >= 256; 4-level f8 VAE."""
    if size >= 256:
        blocks = (32, 64, 96)
        down_attn, up_attn = (True, True, False), (False, True, True)
    else:
        blocks = (32, 64)
        down_attn, up_attn = (True, False), (False, True)
    unet_cfg = unet_lib.UNetConfig(
        in_channels=5, out_channels=4, block_out_channels=blocks,
        down_block_has_attn=down_attn, up_block_has_attn=up_attn,
        layers_per_block=2, cross_attention_dim=ctx, num_heads=2,
        norm_num_groups=8)
    blobnet_cfg = blobnet_lib.BlobNetConfig(
        in_channels=4, conditioning_channels=1 + dino_c,
        block_out_channels=blocks, down_block_has_attn=down_attn,
        up_block_has_attn=up_attn, layers_per_block=2,
        cross_attention_dim=None, num_heads=2, norm_num_groups=8)
    vae_cfg = vae_lib.VAEConfig(block_out_channels=(16, 32, 32, 32),
                                layers_per_block=1, norm_num_groups=8)
    return unet_cfg, blobnet_cfg, vae_cfg


def class_embeddings(ctx: int = 16, length: int = 7, seed: int = 7,
                     dino_c: int = 16) -> Dict[str, np.ndarray]:
    """Fixed random per-class embeddings: "text" (n, length, ctx) plays
    CLIP's role, "appearance" (n, dino_c) DINOv2's."""
    rng = np.random.RandomState(seed)
    n = len(COLORS)
    return {"text": (rng.randn(n, length, ctx) * 0.5).astype(np.float32),
            "appearance": rng.randn(n, dino_c).astype(np.float32)}


# ---------------------------------------------------------------------------
# synthetic scenes
# ---------------------------------------------------------------------------

def _gradient_background(rng: np.random.RandomState, size: int) -> np.ndarray:
    g0, g1 = rng.uniform(90, 175, 2)
    c0 = np.clip(g0 + rng.uniform(-14, 14, 3), 0, 255)
    c1 = np.clip(g1 + rng.uniform(-14, 14, 3), 0, 255)
    t = np.linspace(0.0, 1.0, size)[:, None, None]
    if rng.rand() < 0.5:
        t = t.transpose(1, 0, 2)
    return np.broadcast_to((1 - t) * c0 + t * c1, (size, size, 3)).copy()


def _random_ellipse(rng: np.random.RandomState, size: int,
                    lo: float = 0.24, hi: float = 0.46):
    d1 = rng.uniform(lo, hi) * size
    d2 = rng.uniform(lo, hi) * size
    xc = rng.uniform(0.28, 0.72) * size
    yc = rng.uniform(0.28, 0.72) * size
    return ((float(xc), float(yc)), (float(d1), float(d2)),
            float(rng.uniform(0, 180)))


def _paint(img, ellipse, cls, size):
    """The object of class cls in the ellipse, over img (float)."""
    mask = viz_lib.ellipse_mask(ellipse, size, size)
    a = (mask.astype(np.float32) / 255.0)[..., None]
    img = (1 - a) * img + a * np.asarray(COLORS[cls][1], np.float32)
    return img, {"cls": int(cls), "ellipse": ellipse, "mask": mask}


def make_scene(rng: np.random.RandomState, size: int = 128,
               with_object: bool = True, n_objects: int = 1):
    """One scene: {"image", "mask", "cls", "ellipse"} of the first object
    (cls -1, no ellipse and an empty mask without one) and "objects", a
    {cls, ellipse, mask} per object (distinct classes, ellipses clear of
    each other). The JAX package's draw sequence, draw for draw."""
    img = _gradient_background(rng, size)
    objects: List[Dict] = []
    if with_object and n_objects <= 1:
        cls = int(rng.randint(len(COLORS)))
        img, obj = _paint(img, _random_ellipse(rng, size), cls, size)
        objects.append(obj)
    elif with_object:
        for cls in rng.permutation(len(COLORS))[:n_objects]:
            # smaller ellipses, placed clear of every earlier one
            for _ in range(40):
                cand = _random_ellipse(rng, size, lo=0.14, hi=0.26)
                if all(_ellipses_clear(o["ellipse"], cand) for o in objects):
                    img, obj = _paint(img, cand, cls, size)
                    objects.append(obj)
                    break
    first = objects[0] if objects else {
        "cls": -1, "ellipse": None, "mask": np.zeros((size, size), np.uint8)}
    return {"image": np.clip(img, 0, 255).astype(np.uint8),
            "mask": first["mask"], "cls": first["cls"],
            "ellipse": first["ellipse"], "objects": objects}


def _ellipses_clear(a, b) -> bool:
    """Conservative non-overlap: the bounding circles 2 px apart."""
    (x0, y0), (da, db), _ = a
    (x1, y1), (dc, dd), _ = b
    return np.hypot(x0 - x1, y0 - y1) > (max(da, db) + max(dc, dd)) / 2.0 + 2.0


def _distractor_ellipse(rng: np.random.RandomState, size: int,
                        avoid) -> Optional[tuple]:
    """A white-out ellipse clear of ``avoid`` (an ellipse, a list of them,
    or None), or None after 20 tries."""
    avoid_list = ([] if avoid is None
                  else avoid if isinstance(avoid, list) else [avoid])
    for _ in range(20):
        cand = _random_ellipse(rng, size, lo=0.18, hi=0.38)
        if all(_ellipses_clear(a, cand) for a in avoid_list if a is not None):
            return cand
    return None


def build_dataset(n: int, size: int = 128, seed: int = 0,
                  p_no_object: float = 0.1, p_distractor: float = 0.6,
                  p_text_drop: float = 0.1, p_two_objects: float = 0.0,
                  ctx: int = 16, dino_c: int = 16) -> Dict[str, np.ndarray]:
    """Host arrays for n examples: uint8 images ("image", "fg_image",
    "bg_image"), the scores, text embeddings and the (h, w, dino_c)
    appearance splat; latents come later (``encode_dataset``). A two-object
    scene (p_two_objects) pastes both objects in place on a white canvas
    and splats each class's appearance on its own score layer; its text
    names the first object."""
    emb = class_embeddings(ctx=ctx, dino_c=dino_c)
    rng = np.random.RandomState(seed)
    lh = lw = size // 8
    out = {k: [] for k in ("image", "fg_image", "bg_image", "fg_score",
                           "bg_score", "text_embeds", "appearance")}
    for _ in range(n):
        with_object = rng.rand() >= p_no_object
        # p_two_objects == 0 must not consume a draw
        n_obj = (2 if with_object and p_two_objects > 0
                 and rng.rand() < p_two_objects else 1)
        sc = make_scene(rng, size, with_object, n_objects=n_obj)
        img = sc["image"]
        objs = sc["objects"]
        if objs:
            bg = img
            if len(objs) == 1:
                fg_img = editor_lib.object_region_on_canvas(
                    img, objs[0]["mask"], canvas=size)
            else:
                fg_img = np.full((size, size, 3), 255, np.uint8)
                for o in objs:
                    fg_img = np.where(o["mask"][..., None] > 127, img, fg_img)
            for o in objs:
                bg = viz_lib.composite_mask_and_image(o["mask"], bg,
                                                      (0, 0, 0))
            gs = blob_math.blob_scores_from_ellipses(
                [o["ellipse"] for o in objs], size, size, (lh, lw)).numpy()
            app = np.stack([emb["appearance"][o["cls"]] for o in objs])
            fg_score = gs[0, ..., 1:].sum(-1, keepdims=True)
            fg_feats = np.einsum("hwm,mc->hwc", gs[0, ..., 1:], app)
            avoid = [o["ellipse"] for o in objs]
            text = emb["text"][objs[0]["cls"]]
        else:
            fg_img = np.full((size, size, 3), 255, np.uint8)
            gs = np.stack([np.ones((1, lh, lw)), np.zeros((1, lh, lw))],
                          -1).astype(np.float32)
            bg = img
            fg_score = gs[0, ..., 1:2]
            fg_feats = np.zeros((lh, lw, dino_c), np.float32)
            avoid = []
            text = np.zeros_like(emb["text"][0])
        if rng.rand() < p_distractor:
            d = _distractor_ellipse(rng, size, avoid or None)
            if d is not None:
                bg = viz_lib.composite_mask_and_image(
                    viz_lib.ellipse_mask(d, size, size), bg, (255, 255, 255))
        if rng.rand() < p_text_drop:
            text = np.zeros_like(text)
        out["image"].append(img)
        out["fg_image"].append(fg_img)
        out["bg_image"].append(bg)
        out["fg_score"].append(fg_score)
        out["bg_score"].append(gs[0, ..., 0:1])
        out["text_embeds"].append(text)
        out["appearance"].append(fg_feats)
    return {k: np.stack(v) for k, v in out.items()}


@torch.no_grad()
def encode_dataset(vae_params, vae_cfg, data: Dict[str, np.ndarray],
                   batch: int = 64) -> Dict[str, np.ndarray]:
    """uint8 images -> scaled latents with the toy VAE (on its params'
    device), assembled into the batch dict ``train_step`` takes."""
    dev = next(iter(ts.tree_leaves(vae_params))).device

    def encode_all(imgs_u8):
        return np.concatenate([vae_lib.encode_to_scaled_latents(
            vae_params, vae_cfg, torch.from_numpy(
                imgs_u8[i:i + batch].astype(np.float32) / 127.5 - 1.0).to(
                    dev)).float().cpu().numpy()
            for i in range(0, len(imgs_u8), batch)])

    fg_score = data["fg_score"].astype(np.float32)
    app = data["appearance"].astype(np.float32)
    # (N, h, w, C) splatted features, or (N, C) class vectors splatted here
    fg_feats = app if app.ndim == 4 else fg_score * app[:, None, None, :]
    return {
        "x0_latents": encode_all(data["image"]),
        "fg_latents": encode_all(data["fg_image"]),
        "bg_latents": encode_all(data["bg_image"]),
        "fg_score": fg_score,
        "bg_score": data["bg_score"].astype(np.float32),
        "fg_feats": fg_feats,
        "text_embeds": data["text_embeds"].astype(np.float32),
    }


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _index_chunks(rng: np.random.RandomState, n: int, steps: int,
                  batch: int):
    """The example indices of each step, drawn in chunks of 100 steps as
    the JAX package draws them."""
    done = 0
    while done < steps:
        k = min(100, steps - done)
        yield from rng.randint(0, n, (k, batch))
        done += k


def _step_keys(key, steps: int):
    """Each step's key, split from ``key`` in chunks of 100 steps as the
    JAX package splits them (``utils.threefry``): ``key, sub = split(key)``,
    then the chunk's ``split(sub, k)``."""
    done = 0
    while done < steps:
        k = min(100, steps - done)
        key, sub = threefry.split(key)
        yield from threefry.split(sub, k)
        done += k


def train_toy_vae(images_u8: np.ndarray, vae_cfg, steps: int = 1500,
                  batch: int = 64, lr: float = 1e-3, kl_weight: float = 1e-4,
                  seed: int = 0, log_every: int = 250, device="cuda"):
    """MSE reconstruction + a tiny KL, Adam, the encoder and decoder
    recomputed in the backward. The JAX package's trainer for a seed: it
    starts from ``init_vae(PRNGKey(seed))``, and step i samples its
    latents with the JAX package's key for it, from ``PRNGKey(seed)``
    (``_step_keys``). -> (params, cfg with the measured scaling factor 1 /
    std(latents), final mse)."""
    dev = resolve_device(device)
    params = vae_lib.init_vae(vae_cfg, threefry.key(seed), dev)
    leaves = ts.tree_leaves(params)
    opt = ts.init_opt_state(params)
    x_all = torch.from_numpy(np.asarray(images_u8)).to(dev)

    def loss_fn(x, key):
        moments = checkpoint.checkpoint(
            lambda x: vae_lib.encode(params, vae_cfg, x), x,
            use_reentrant=False)
        mean, logvar = moments.chunk(2, dim=-1)
        logvar = torch.clamp(logvar, -30.0, 20.0)
        z = vae_lib.sample_latents(moments, key)
        rec = checkpoint.checkpoint(
            lambda z: vae_lib.decode(params, vae_cfg, z), z,
            use_reentrant=False)
        mse = torch.mean(torch.square(rec - x))
        kl = 0.5 * torch.mean(torch.square(mean) + torch.exp(logvar) - 1.0
                              - logvar)
        return mse + kl_weight * kl, mse

    rng = np.random.RandomState(seed)
    for p in leaves:
        p.requires_grad_(True)
    mse = None
    for step, (idx, key) in enumerate(zip(
            _index_chunks(rng, len(x_all), steps, batch),
            _step_keys(threefry.key(seed), steps)), 1):
        x = x_all[torch.from_numpy(idx).to(dev)].float() / 127.5 - 1.0
        loss, mse = loss_fn(x, key)
        ts.adam_update(leaves, torch.autograd.grad(loss, leaves), opt, lr)
        mse = mse.detach()
        if log_every and step % log_every == 0:
            print(f"vae step {step}/{steps} mse {float(mse):.5f}", flush=True)
    with torch.no_grad():
        for p in leaves:
            p.requires_grad_(False)
        zs = vae_lib.sample_latents(vae_lib.encode(
            params, vae_cfg, x_all[:256].float() / 127.5 - 1.0))
    scaling = float(1.0 / (zs.std(unbiased=False) + 1e-8))
    return (params, dataclasses.replace(vae_cfg, scaling_factor=scaling),
            float(mse))


def train_toy_diffusion(batch_data: Dict[str, np.ndarray], unet_cfg,
                        blobnet_cfg, steps: int = 8000, batch: int = 64,
                        lr: float = 3e-4, seed: int = 0,
                        log_every: int = 500, device="cuda"):
    """From-scratch training of BlobNet + the full UNet
    (``TrainConfig.train_unet_full``, weight decay 1e-3, no remat). The
    JAX package's trainer for a seed: with ``k_u, k_b, key =
    split(PRNGKey(seed), 3)`` it starts from ``init_unet(k_u)`` and
    ``init_blobnet(k_b)``, and step i draws t and noise from ``key`` split
    by ``_step_keys``. -> (unet_params, blobnet_params, final loss)."""
    dev = resolve_device(device)
    cfg = ts.TrainConfig(learning_rate=lr, weight_decay=1e-3,
                         train_unet_full=True, remat=False)
    k_u, k_b, key = threefry.split(threefry.key(seed), 3)
    state = ts.init_train_state(
        cfg, blobnet_lib.init_blobnet(blobnet_cfg, k_b, dev),
        unet_lib.init_unet(unet_cfg, k_u, dev))
    step_fn = ts.make_train_step(cfg, unet_cfg, blobnet_cfg)
    data = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in batch_data.items()}
    rng = np.random.RandomState(seed + 1)
    keys = _step_keys(key, steps)
    loss = None
    for step, (idx, key) in enumerate(zip(_index_chunks(
            rng, len(data["x0_latents"]), steps, batch), keys), 1):
        ix = torch.from_numpy(idx).to(dev)
        mb = {k: v[ix] for k, v in data.items()}
        t, noise = ts.draw_t_noise(key, batch, mb["x0_latents"].shape[1:],
                                   cfg.num_train_timesteps, dev)
        state, metrics = step_fn(state, None, mb, t, noise)
        loss = metrics["loss"]
        if log_every and step % log_every == 0:
            print(f"diff step {step}/{steps} loss {float(loss):.5f}",
                  flush=True)
    params = state["params"]
    return params["unet"], params["blobnet"], float(loss)


# ---------------------------------------------------------------------------
# checkpoint: one safetensors file + a JSON sidecar
# ---------------------------------------------------------------------------

def save_toy(ckpt_dir: str, unet_params, blobnet_params, vae_params,
             meta: Dict):
    """toy.safetensors (every leaf in fp16, named "unet.", "blobnet.",
    "vae." + its path) and toy.json (``meta``), as the JAX package writes
    them."""
    os.makedirs(ckpt_dir, exist_ok=True)
    sd = {}
    for prefix, tree in (("unet", unet_params), ("blobnet", blobnet_params),
                         ("vae", vae_params)):
        sd.update(export.flatten(tree, f"{prefix}."))
    export.save_safetensors(os.path.join(ckpt_dir, "toy.safetensors"), sd,
                            torch.float16)
    with open(os.path.join(ckpt_dir, "toy.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)


def load_toy(ckpt_dir: str, device="cuda", dtype=torch.float32):
    """-> (BlobNetPipeline over the trained toy weights, meta dict)."""
    from blobctrl_torch.pipeline import BlobNetPipeline

    with open(os.path.join(ckpt_dir, "toy.json")) as f:
        meta = json.load(f)
    trees: Dict[str, Dict[str, np.ndarray]] = {"unet": {}, "blobnet": {},
                                               "vae": {}}
    for k, v in fj.load_safetensors(os.path.join(ckpt_dir,
                                                 "toy.safetensors")).items():
        prefix, rest = k.split(".", 1)
        trees[prefix][rest] = np.asarray(v, np.float32)
    unet_cfg, blobnet_cfg, vae_cfg = toy_configs(
        ctx=meta["ctx"], dino_c=meta["dino_c"], size=meta.get("size", 128))
    vae_cfg = dataclasses.replace(vae_cfg,
                                  scaling_factor=meta["vae_scaling_factor"])
    params = {k: fj.from_jax(fj.unflatten(v), device, dtype)
              for k, v in trees.items()}
    pipe = BlobNetPipeline(unet_cfg=unet_cfg, unet_params=params["unet"],
                           blobnet_cfg=blobnet_cfg,
                           blobnet_params=params["blobnet"],
                           vae_cfg=vae_cfg, vae_params=params["vae"],
                           dtype=dtype, device=device)
    return pipe, meta


# ---------------------------------------------------------------------------
# evaluation (the quality gate's surface)
# ---------------------------------------------------------------------------

def edit_kwargs(scene: Dict, target_ellipse, size: int = 128,
                steps: int = 50, guidance: float = 4.0, seed: int = 3,
                ctx: int = 16, dino_c: int = 16) -> Dict:
    """Pipeline kwargs that move the object of a ``make_scene`` scene to
    ``target_ellipse``, under the session's conventions: the vacated
    region white, the target black."""
    emb = class_embeddings(ctx=ctx, dino_c=dino_c)
    img, mask, cls = scene["image"], scene["mask"], scene["cls"]
    fg_img = editor_lib.object_region_on_canvas(img, mask, canvas=size)
    bg = viz_lib.composite_mask_and_image(mask, img, (255, 255, 255))
    tmask = viz_lib.ellipse_mask(target_ellipse, size, size)
    bg = viz_lib.composite_mask_and_image(tmask, bg, (0, 0, 0))
    lh = lw = size // 8
    gs = blob_math.blob_score_from_ellipse(target_ellipse, size, size,
                                           (lh, lw)).numpy()
    return dict(
        fg_image=fg_img, bg_image=bg, gs_score=gs, height=size, width=size,
        num_inference_steps=steps, guidance_scale=guidance, seed=seed,
        prompt_embeds=emb["text"][cls][None],
        negative_prompt_embeds=np.zeros_like(emb["text"][cls])[None],
        fg_dino_feats=emb["appearance"][cls][None])


def compose_kwargs(scene: Dict, target_ellipse, size: int = 128,
                   steps: int = 50, guidance: float = 4.0, seed: int = 3,
                   ctx: int = 16, dino_c: int = 16) -> Dict:
    """Pipeline kwargs of a two-blob compose edit on a two-object scene
    (``make_scene(n_objects=2)``): the first object moves to
    ``target_ellipse`` while the second stays in place (summed score
    layers, one appearance a blob)."""
    emb = class_embeddings(ctx=ctx, dino_c=dino_c)
    objs = scene["objects"]
    if len(objs) < 2:
        raise ValueError("compose_kwargs needs a 2-object scene")
    o0, o1 = objs[0], objs[1]
    img = scene["image"]
    # each object's pixels at its score layer's place: the moved one
    # pasted at the target's centre, the kept one where it is
    fg_img = np.full((size, size, 3), 255, np.uint8)
    (sx, sy), _, _ = o0["ellipse"]
    (tx, ty), _, _ = target_ellipse
    ys, xs = np.nonzero(o0["mask"] > 127)
    ny = np.clip(ys + int(round(ty - sy)), 0, size - 1)
    nx = np.clip(xs + int(round(tx - sx)), 0, size - 1)
    fg_img[ny, nx] = img[ys, xs]
    fg_img = np.where(o1["mask"][..., None] > 127, img, fg_img)
    # white = erase (o0's vacated source), black = generate (o0's target
    # and o1's region)
    bg = viz_lib.composite_mask_and_image(o0["mask"], img, (255, 255, 255))
    tmask = viz_lib.ellipse_mask(target_ellipse, size, size)
    bg = viz_lib.composite_mask_and_image(tmask, bg, (0, 0, 0))
    bg = viz_lib.composite_mask_and_image(o1["mask"], bg, (0, 0, 0))
    lh = lw = size // 8
    gs = blob_math.blob_scores_from_ellipses(
        [target_ellipse, o1["ellipse"]], size, size, (lh, lw)).numpy()
    feats = np.stack([emb["appearance"][o0["cls"]],
                      emb["appearance"][o1["cls"]]])
    return dict(
        fg_image=fg_img, bg_image=bg, gs_score=gs, height=size, width=size,
        num_inference_steps=steps, guidance_scale=guidance, seed=seed,
        prompt_embeds=emb["text"][o0["cls"]][None],
        negative_prompt_embeds=np.zeros_like(emb["text"][o0["cls"]])[None],
        fg_dino_feats=feats)


def remove_kwargs(scene: Dict, size: int = 128, steps: int = 50,
                  seed: int = 3, ctx: int = 16, dino_c: int = 16) -> Dict:
    """Pipeline kwargs that remove the object of a scene. BlobNet stays on
    with the all-background score (the toy was trained so), where the
    reference's recipe sets the strength to 0."""
    img, mask = scene["image"], scene["mask"]
    bg = viz_lib.composite_mask_and_image(mask, img, (255, 255, 255))
    lh = lw = size // 8
    gs = np.stack([np.ones((1, lh, lw)), np.zeros((1, lh, lw))],
                  -1).astype(np.float32)
    return dict(
        fg_image=np.full((size, size, 3), 255, np.uint8), bg_image=bg,
        gs_score=gs, height=size, width=size, num_inference_steps=steps,
        guidance_scale=4.0, seed=seed,
        prompt_embeds=np.zeros((1, 7, ctx), np.float32),
        negative_prompt_embeds=np.zeros((1, 7, ctx), np.float32),
        fg_dino_feats=np.zeros((1, dino_c), np.float32))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of two images in [0, 1]."""
    mse = float(np.mean(np.square(np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32))))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def color_error_inside(image01: np.ndarray, ellipse, cls: int,
                       size: int = 128, erode_frac: float = 0.75) -> float:
    """Mean absolute error, in [0, 1] units, between the pixels inside the
    shrunken ellipse and class ``cls``'s colour: did the object appear
    where the blob says?"""
    (xc, yc), (d1, d2), ang = ellipse
    inner = ((xc, yc), (d1 * erode_frac, d2 * erode_frac), ang)
    m = viz_lib.ellipse_mask(inner, size, size) > 127
    color = np.asarray(COLORS[cls][1], np.float32) / 255.0
    return float(np.abs(image01[m] - color).mean())
