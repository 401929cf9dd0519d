"""Self-supervised BlobCtrl training, BlobNet + UNet-LoRA (counterpart of
``blobctrl_tpu/train/train_step.py``), on one device or data-parallel
over ranks.

The objective is the JAX package's: reconstruct the noise added to the
target's latents, conditioned on the fg blob splat + DINOv2 appearance
features (the BlobNet branch) and the masked background (the UNet branch),
in the double-width layout with the loss on the right half. The
trainables are fp32 masters of BlobNet and a LoRA over the frozen UNet
(``TrainConfig.train_unet_full``: BlobNet and the whole UNet); compute
runs in ``compute_dtype``. The long self-attention and the resnet 3x3
convs go through the hand kernels' autograd Functions (``ops``), whose
backward is the exact plain math.

The optimizer is optax's chain of ``clip_by_global_norm`` and ``adamw``,
restated as plain tensor functions: b1 0.9, b2 0.999, eps 1e-8 outside the
square root, decoupled weight decay on every trainable leaf, the learning
rate read at the count before the update. The state is ``{"params",
"opt_state", "step"}`` (+ ``"ema"`` with ``ema_decay``); the optimizer
updates it in place.

Data parallelism is explicit SPMD, the port's form of what GSPMD does for
the JAX step with the batch sharded over ``data``: every rank holds the
whole replicated state and differentiates the mean loss of its own rows;
``mean_over_ranks`` then averages the gradients (and the loss) over the
ranks in fp32 before the clip, so every rank runs the same clip, AdamW and
EMA on the same values and the state stays bit-equal on every rank. The
gradients travel in a few flat fp32 buckets, not one call a leaf, as XLA
combines its all-reduces.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from blobctrl_torch.models import blobnet as blobnet_lib
from blobctrl_torch.models import lora as lora_lib
from blobctrl_torch.models import unet as unet_lib
from blobctrl_torch.nn.layers import sorted_tree
from blobctrl_torch.parallel import collectives
from blobctrl_torch.schedulers import ddim as ddim_lib
from blobctrl_torch.utils import threefry

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# 256 MiB of fp32 a collective; read at each call, so a test may shrink it
GRAD_BUCKET_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    num_train_timesteps: int = 1000
    lora_scale: float = 1.0
    remat: bool = True
    compute_dtype: Any = torch.bfloat16
    # train the full base UNet instead of a LoRA adapter over frozen weights
    train_unet_full: bool = False
    # EMA of the trainables (0 disables); the shadow lives in state["ema"]
    ema_decay: float = 0.0
    # "constant" (after a linear warmup) or "cosine" (linear warmup, then a
    # cosine decay over lr_total_steps to lr_end_factor * learning_rate)
    lr_warmup_steps: int = 0
    lr_schedule: str = "constant"
    lr_total_steps: int = 0          # required (> 0) for "cosine"
    lr_end_factor: float = 0.0


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax's ``linear_schedule`` at one count, in float32."""
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1) - c / np.float32(steps)
    return float(np.float32(init - end) * frac + np.float32(end))


def _cosine(init: float, steps: int, alpha: float, count: int) -> float:
    """optax's ``cosine_decay_schedule`` at one count, in float32."""
    c = np.float32(min(count, steps))
    decay = np.float32(0.5) * (np.float32(1) + np.cos(
        np.float32(math.pi) * c / np.float32(steps)))
    return float(np.float32(init)
                 * (np.float32(1 - alpha) * decay + np.float32(alpha)))


def make_lr(cfg: TrainConfig) -> Union[float, Callable[[int], float]]:
    """The learning rate: a number, or a function of the step count
    (optax's ``linear_schedule`` for a warmup, ``warmup_cosine_decay_
    schedule`` for "cosine")."""
    lr, warm = cfg.learning_rate, cfg.lr_warmup_steps
    if cfg.lr_schedule == "cosine":
        if cfg.lr_total_steps <= 0:
            raise ValueError("lr_schedule='cosine' needs lr_total_steps > 0")
        decay = cfg.lr_total_steps - warm
        if decay <= 0:
            raise ValueError("lr_schedule='cosine' needs lr_total_steps > "
                             "lr_warmup_steps")
        end = cfg.lr_end_factor * lr
        alpha = 0.0 if lr == 0.0 else end / lr

        def cosine(step: int) -> float:
            if step < warm:
                return _linear(0.0, lr, warm, step)
            return _cosine(lr, decay, alpha, step - warm)
        return cosine
    if cfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                         "(constant | cosine)")
    if warm > 0:
        return lambda step: _linear(0.0, lr, warm, step)
    return lr


def lr_at(cfg: TrainConfig, step: int) -> float:
    """The rate of the update at ``step``, rounded to fp32 as the update
    applies it."""
    lr = make_lr(cfg)
    return float(np.float32(lr(step) if callable(lr) else lr))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in its order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def num_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# the optimizer: clip_by_global_norm, then AdamW
# ---------------------------------------------------------------------------

def init_opt_state(trainable) -> Dict[str, Any]:
    """AdamW's moments, zero, and its update count."""
    return {"count": 0, "mu": tree_map(torch.zeros_like, trainable),
            "nu": tree_map(torch.zeros_like, trainable)}


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, fp32 (optax's
    ``global_norm``)."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in grads]).sum())


@torch.no_grad()
def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                opt_state, lr: float, weight_decay: float = 0.0):
    """One Adam step on ``params`` and ``opt_state`` in place (optax's
    ``scale_by_adam``, then ``add_decayed_weights`` when weight_decay, then
    the step -lr): bias-corrected moments, eps outside the square root."""
    count = opt_state["count"] + 1
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(count))
    for p, g, m, v in zip(params, grads, tree_leaves(opt_state["mu"]),
                          tree_leaves(opt_state["nu"]), strict=True):
        m.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
        v.mul_(ADAM_B2).add_((1 - ADAM_B2) * (g * g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        if weight_decay:
            u = u + weight_decay * p
        p.add_(u * -lr)
    opt_state["count"] = count


@torch.no_grad()
def apply_optimizer(cfg: TrainConfig, trainable, opt_state,
                    grads: List[torch.Tensor]) -> torch.Tensor:
    """One clip + AdamW update of ``trainable`` and ``opt_state`` in place,
    grads in ``tree_leaves(trainable)``'s order, the learning rate at the
    count before the update. -> the gradients' global norm before the
    clip."""
    g_norm = global_norm(grads)
    keep = g_norm < cfg.max_grad_norm
    clipped = [torch.where(keep, g, g / g_norm * cfg.max_grad_norm)
               for g in grads]
    adam_update(tree_leaves(trainable), clipped, opt_state,
                lr_at(cfg, opt_state["count"]), cfg.weight_decay)
    return g_norm


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def init_train_state(cfg: TrainConfig, blobnet_params, adapter_params):
    """adapter_params: the LoRA tree, or the full UNet tree under
    ``train_unet_full``. Each leaf is copied into an fp32 master of its
    own, so the state never shares storage with the trees given. Its
    trees are key-sorted (JAX's order), as ``checkpoint.restore`` gives
    a saved one, so that states of one run reduce, clip and replicate
    their leaves alike."""
    key = "unet" if cfg.train_unet_full else "lora"
    master = (lambda t: t.detach().to(torch.float32,  # noqa: E731
                                      copy=True))
    trainable = sorted_tree({"blobnet": tree_map(master, blobnet_params),
                             key: tree_map(master, adapter_params)})
    state = {"params": trainable, "opt_state": init_opt_state(trainable),
             "step": 0}
    if cfg.ema_decay > 0:
        state["ema"] = tree_map(torch.clone, trainable)
    return state


def draw_t_noise(key, batch: int, latent_shape,
                 num_train_timesteps: int = 1000, device=None,
                 rows: Optional[range] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A step's timesteps t (B,) in [0, num_train_timesteps) and standard
    normal noise (B, *latent_shape), the JAX package's draws for ``key``
    (``utils.threefry``): ``rng_t, rng_n = split(key)``, ``t =
    randint(rng_t, (B,), 0, T)``, ``noise = normal(rng_n, (B,
    *latent_shape))``, drawn on ``device``. ``rows``:
    the rows of the batch this rank keeps (``multihost.local_rows``), drawn
    alone; data parallelism draws for the global batch, so each rank's
    rows carry the draws of the one-process step."""
    rng_t, rng_n = threefry.split(key)
    t = threefry.randint(rng_t, (batch,), 0, num_train_timesteps, rows=rows,
                         device=device)
    noise = threefry.normal(rng_n, (batch,) + tuple(latent_shape),
                            rows=rows, device=device)
    return t, noise


@torch.no_grad()
def _in_buckets(parts: List[torch.Tensor], fn):
    """``fn`` applied to the flat fp32 tensors ``parts`` laid end to end
    and cut into buckets of ``GRAD_BUCKET_BYTES`` (a part may span two),
    each bucket's result written back over the parts in place."""
    cap = GRAD_BUCKET_BYTES // 4
    total = sum(p.numel() for p in parts)
    buf = torch.empty(min(cap, total), dtype=torch.float32,
                      device=parts[0].device)
    pieces, fill = [], 0   # (part, start, end, offset in the bucket)

    def flush():
        out = fn(buf[:fill])
        for part, start, end, at in pieces:
            parts[part][start:end] = out[at:at + end - start]
        pieces.clear()

    for i, p in enumerate(parts):
        start = 0
        while start < p.numel():
            take = min(p.numel() - start, cap - fill)
            buf[fill:fill + take] = p[start:start + take]
            pieces.append((i, start, start + take, fill))
            fill, start = fill + take, start + take
            if fill == cap:
                flush()
                fill = 0
    if fill:
        flush()


@torch.no_grad()
def mean_over_ranks(grads: List[torch.Tensor], loss: torch.Tensor, group
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The gradients and the loss averaged over the ranks of ``group`` in
    fp32 (the identity for one rank): the leaves, then the loss, in flat
    buckets of ``GRAD_BUCKET_BYTES``, one all-reduce (a sum) each, divided by
    the group's size. Every rank gets the same values. The gradients are
    overwritten in place (one that shares storage with another is copied
    first)."""
    n = collectives.group_size(group)
    if n == 1:
        return grads, loss
    grads, seen = list(grads), set()
    for i, g in enumerate(grads):
        if (not g.is_contiguous() or g.dtype != torch.float32
                or g.untyped_storage().data_ptr() in seen):
            grads[i] = g.to(torch.float32, copy=True,
                            memory_format=torch.contiguous_format)
        seen.add(grads[i].untyped_storage().data_ptr())
    loss = loss.detach().to(torch.float32).reshape(1).clone()
    _in_buckets([g.view(-1) for g in grads] + [loss],
                lambda b: collectives.all_reduce(b, group) / n)
    return grads, loss.reshape(())


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) -> fp32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device, torch.float32)
            for k, v in batch.items()}


def _crop_right(r: torch.Tensor) -> torch.Tensor:
    return r[:, :, r.shape[2] - r.shape[1]:, :]


class TrainStep:
    """``step(state, frozen_unet_params, batch, t, noise) -> (state,
    metrics)``: one optimizer step on a batch (numpy or tensors, NHWC:
    x0_latents, fg_latents, bg_latents (B, h, w, 4), fg_score, bg_score
    (B, h, w, 1), fg_feats (B, h, w, Cd), text_embeds (B, T, Ct)) and the
    step's draws t (B,) and noise (B, h, w, 4). Metrics: loss, grad_norm
    (before the clip, 0-d tensors) and lr (the rate of this update).

    ``group``: the data-parallel ranks (None: this process alone). Each
    rank passes its own rows and their draws; the gradients and the loss
    are averaged over the group before the clip (``mean_over_ranks``), so
    the metrics are the global batch's and identical on every rank."""

    def __init__(self, cfg: TrainConfig, unet_cfg: unet_lib.UNetConfig,
                 blobnet_cfg: blobnet_lib.BlobNetConfig, group=None):
        self.cfg, self.unet_cfg, self.blobnet_cfg = cfg, unet_cfg, blobnet_cfg
        self.group = group
        self.tables = ddim_lib.training_tables(cfg.num_train_timesteps)

    def loss(self, trainable, frozen_unet_params, batch, t, noise
             ) -> torch.Tensor:
        cfg, dtype = self.cfg, self.cfg.compute_dtype
        x0 = batch["x0_latents"]
        sqrt_acp, sqrt_1m = (torch.from_numpy(a).to(x0.device)
                             for a in self.tables)
        x_t = ddim_lib.add_noise(sqrt_acp, sqrt_1m, t, x0, noise)
        if cfg.train_unet_full:
            unet_params = trainable["unet"]
        else:
            unet_params = lora_lib.merge_lora(frozen_unet_params,
                                              trainable["lora"],
                                              cfg.lora_scale)
        lmi = x_t.to(dtype)
        fg_score = batch["fg_score"].to(dtype)
        bg_score = batch["bg_score"].to(dtype)
        fg_feats = batch["fg_feats"].to(dtype)
        blob_in = torch.cat([
            torch.cat([batch["fg_latents"].to(dtype), fg_score, fg_feats], -1),
            torch.cat([lmi, fg_score, fg_feats], -1)], dim=2)
        tf = t.float()
        down, mid, up = blobnet_lib.blobnet_apply(
            trainable["blobnet"], self.blobnet_cfg, blob_in, tf,
            conditioning_scale=1.0, remat=cfg.remat)
        unet_in = torch.cat([
            torch.cat([batch["bg_latents"].to(dtype), bg_score], -1),
            torch.cat([lmi, bg_score], -1)], dim=2)
        noise_pred = unet_lib.unet_apply(
            unet_params, self.unet_cfg, unet_in, tf,
            batch["text_embeds"].to(dtype),
            down_block_add_samples=[_crop_right(r) for r in down],
            mid_block_add_sample=_crop_right(mid),
            up_block_add_samples=[_crop_right(r) for r in up],
            remat=cfg.remat)
        w = noise_pred.shape[2]
        pred = noise_pred[:, :, w // 2:, :].float()
        return torch.mean(torch.square(pred - noise))

    def loss_and_grads(self, state, frozen_unet_params, batch, t, noise
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The loss of this rank's rows and its gradients, in
        ``tree_leaves(state["params"])``'s order; nothing is updated and
        nothing is averaged over ranks (autograd sees detached aliases of
        the masters, which themselves never require grad)."""
        live = tree_map(lambda p: p.detach().requires_grad_(),
                        state["params"])
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss = self.loss(live, frozen_unet_params,
                             batch_to(batch, leaves[0].device), t, noise)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def __call__(self, state, frozen_unet_params, batch, t, noise):
        cfg = self.cfg
        lr = lr_at(cfg, state["step"])
        loss, grads = self.loss_and_grads(state, frozen_unet_params, batch,
                                          t, noise)
        grads, loss = mean_over_ranks(grads, loss, self.group)
        g_norm = apply_optimizer(cfg, state["params"], state["opt_state"],
                                 grads)
        del grads
        state["step"] += 1
        if cfg.ema_decay > 0:
            d = cfg.ema_decay
            with torch.no_grad():
                for e, p in zip(tree_leaves(state["ema"]),
                                tree_leaves(state["params"]), strict=True):
                    e.mul_(d).add_((1.0 - d) * p)
        return state, {"loss": loss, "grad_norm": g_norm, "lr": lr}


def make_train_step(cfg: TrainConfig, unet_cfg: unet_lib.UNetConfig,
                    blobnet_cfg: blobnet_lib.BlobNetConfig, group=None
                    ) -> TrainStep:
    return TrainStep(cfg, unet_cfg, blobnet_cfg, group)


def _layout(tree, path: str = ""):
    """One line a leaf of ``tree`` in ``tree_leaves`` order: its path and
    its shape and dtype, or its type for a leaf that is not a tensor."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _layout(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _layout(v, f"{path}/{i}")]
    if isinstance(tree, torch.Tensor):
        return [f"{path}:{tuple(tree.shape)}:{tree.dtype}"]
    return [f"{path}:{type(tree).__name__}"]


def replicate_state(state, refused: bool = False):
    """Rank 0's train state on every rank, in place. First every rank's
    layout (its leaves' paths, shapes and dtypes) is gathered with rank
    0's ``refused``, and every rank refuses alike a state whose layout
    differs from rank 0's (a checkpoint resumed under flags that build
    another tree) or that rank 0 refused (one that misfits the flags in
    what the layout does not show, as its learning-rate schedule). Then its
    tensors (fp32, as ``init_train_state`` and ``checkpoint.restore`` make
    them) are laid end to end in buckets of ``GRAD_BUCKET_BYTES``, each
    broadcast (``multihost.replicate``) and copied back, then its two
    counters, the step and the update count, as one int64 pair on the
    state's device. The identity in one process."""
    from blobctrl_torch.parallel import multihost
    if multihost.process_count() == 1:
        return state
    tensors = [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
    lines = _layout(state)
    mine = torch.tensor([len(lines), zlib.crc32("\n".join(lines).encode()),
                         int(refused)], dtype=torch.int64,
                        device=tensors[0].device)
    every = collectives.all_gather(mine, multihost.world_group(), dim=0)
    every = every.view(-1, 3).tolist()
    if every[0][2]:
        raise ValueError("replicate_state: rank 0 refused the checkpoint it "
                         "resumed, as it says: it misfits the run's flags")
    if any(x[:2] != every[0][:2] for x in every):
        raise ValueError(
            f"replicate_state: the train state's layout differs across "
            f"ranks ([leaves, digest, refused] a rank: {every}); a "
            f"checkpoint resumed on rank 0 must be made under the flags "
            f"that build the state (--lora_rank, --ema_decay, "
            f"--full_finetune)")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("replicate_state: the state's tensors must be "
                         "contiguous fp32")
    _in_buckets([t.view(-1) for t in tensors], multihost.replicate)
    step, count = multihost.replicate(torch.tensor(
        [state["step"], state["opt_state"]["count"]], dtype=torch.int64,
        device=tensors[0].device)).tolist()
    state["step"], state["opt_state"]["count"] = step, count
    return state


def training_counts(trainable, world: int, steps: int = 1,
                    replicated=None, checkpoints: int = 0
                    ) -> Dict[str, Dict]:
    """{"pipeline": {op: {"count", "bytes"}}} that data-parallel training
    logs on each of ``world`` ranks (``TrainStep`` with a group,
    ``apps/train_cli``), in the bucket layout of this module: each of
    ``steps`` steps one fp32 all-reduce a bucket of ``GRAD_BUCKET_BYTES``
    over the trainable leaves laid end to end, then the loss
    (``mean_over_ranks``); ``replicated``, the train state replicated from
    rank 0 at the start (``replicate_state``: one all-gather of the
    layouts and rank 0's verdict, its fp32 tensors in buckets, one
    broadcast each, then the step and update count as one int64 pair);
    one barrier a checkpoint. Nothing in one process."""
    if world <= 1:
        return {}
    cap = GRAD_BUCKET_BYTES // 4

    def elems(tree):
        return sum(t.numel() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))
    out = {}
    if steps:
        n = elems(trainable) + 1
        out["all_reduce"] = {"count": steps * -(-n // cap),
                             "bytes": steps * 4 * n}
    if replicated is not None:
        n = elems(replicated)
        out["all_gather"] = {"count": 1, "bytes": 24}
        out["broadcast"] = {"count": -(-n // cap) + 1, "bytes": 4 * n + 16}
    if checkpoints:
        out["barrier"] = {"count": checkpoints, "bytes": 0}
    return {"pipeline": out} if out else {}
