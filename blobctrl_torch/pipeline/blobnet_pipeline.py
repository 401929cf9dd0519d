"""The BlobCtrl edit pipeline in PyTorch (counterpart of
``blobctrl_tpu/pipeline/blobnet_pipeline.py``, ``BlobNetPipeline.__call__``).

Text comes as prompt strings (tokenizer + CLIP text, memoized by token
ids) or as embeddings; appearance as object images (DINOv2's pooled CLS,
memoized by pixel content) or as embeddings. One edit: VAE-encode the fg
and bg images in one batch (memoized by their pixels); build the
width-concat inputs; for each step run BlobNet (at the edit batch, its
residuals broadcast to both CFG rows, skipped outside the control window)
and the UNet with the right-half injections, combine under CFG and step
the scheduler (UniPC, DDIM or the DPM-Solver++ family); VAE-decode;
transport the image as uint8. ``edit_batch`` runs B distinct requests
through the same loop at once (the server's micro-batches). The loop runs eagerly; the hot convs and
attentions go through the hand-written kernels (``blobctrl_torch.ops``)
when the pipeline runs on the card.

Opt-in approximations, as in the JAX package: the encoder cache
(``encoder_cache_interval``: BlobNet and the UNet encoder run on key steps
only, the decoder every step) and guidance-interval CFG (outside
[cfg_guidance_start, cfg_guidance_end) the UNet runs the conditional rows
alone).

Sharded over ranks (``shard_to_mesh``, ``parallel/``): every rank runs the
same edit on local weight slices; ``edit_batch`` splits its requests over
the data group, and the hybrid recipe splits the CFG pair over it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.models import blobnet as blobnet_lib
from blobctrl_torch.models import clip_text as clip_lib
from blobctrl_torch.models import dinov2 as dino_lib
from blobctrl_torch.models import lora as lora_lib
from blobctrl_torch.models import safety_checker as safety_checker_lib
from blobctrl_torch.models import unet as unet_lib
from blobctrl_torch.models import vae as vae_lib
from blobctrl_torch.nn import attention, layers, transformer_2d
from blobctrl_torch.ops import conv3x3 as conv3x3_op
from blobctrl_torch.ops import flash_attention as flash_op
from blobctrl_torch.ops import winograd as winograd_op
from blobctrl_torch.parallel import collectives
from blobctrl_torch.parallel import kernel_sharding as ks
from blobctrl_torch.parallel import mesh as mesh_lib
from blobctrl_torch.parallel import multihost
from blobctrl_torch.schedulers import ddim as ddim_lib
from blobctrl_torch.schedulers import dpm as dpm_lib
from blobctrl_torch.schedulers import unipc as unipc_lib
from blobctrl_torch.utils import resample, threefry

COND_LAT_MEMO = 8   # entries of the conditioning-latent memo (FIFO)
VARIANCE_KEY_TAG = 0x5DE  # folded into a seed's key for its variance noise

# the names make_scheduler knows, as the JAX package lists them
SCHEDULER_NAMES = ("unipc", "ddim", "dpm", "dpm_karras", "dpm_sde",
                   "dpm_sde_karras", "dpm_heun")


@dataclasses.dataclass
class PipelineOutput:
    images: np.ndarray  # (B, H, W, 3) float32 in [0, 1]; the final
    # (B, h, w, 4) latents with output_type="latent"
    # (N,) bool from the safety checker; None without one
    nsfw_content_detected: Optional[np.ndarray] = None


def make_scheduler(name: str, num_steps: int, eta: float = 0.0,
                   timesteps: Optional[Sequence[int]] = None):
    """The sampler a scheduler name selects: "unipc", "ddim" (with eta) or
    "dpm" plus any of the tokens sde, karras and heun (e.g.
    "dpm_sde_karras", DPM-Solver++ 2M SDE with Karras sigmas); timesteps, a
    custom descending schedule, for any of them. Anything else raises
    ValueError, as the JAX package does."""
    if name == "unipc":
        return unipc_lib.make(num_steps, timesteps=timesteps)
    if name == "ddim":
        return ddim_lib.make(num_steps, eta=eta, timesteps=timesteps)
    if name == "dpm" or name.startswith("dpm_"):
        toks = name.split("_")[1:]
        if set(toks) - {"sde", "karras", "heun"} or "" in toks:
            raise ValueError(
                f"unknown dpm variant {name!r}; tokens after 'dpm_' must be "
                f"among sde/karras/heun")
        return dpm_lib.make(
            num_steps,
            algorithm_type="sde-dpmsolver++" if "sde" in toks
            else "dpmsolver++",
            solver_type="heun" if "heun" in toks else "midpoint",
            use_karras_sigmas="karras" in toks, timesteps=timesteps)
    raise ValueError(f"unknown scheduler {name}")


def blobnet_keep_schedule(num_steps: int, start: float,
                          end: float) -> np.ndarray:
    """Per-step gate of the BlobNet control window."""
    keeps = [1.0 - float(i / num_steps < start or (i + 1) / num_steps > end)
             for i in range(num_steps)]
    return np.asarray(keeps, np.float32)


def preprocess_image_transport(image, height: int, width: int) -> np.ndarray:
    """An image ndarray -> (1, height, width, 3) in the cheapest exact
    transport form, as the JAX package makes it. An integer (H, W, 3) image
    (RGBA loses its alpha) becomes uint8, resized with PIL's 8-bit LANCZOS
    where the size differs (the port's bit-exact copy, ``utils/resample``).
    Anything else becomes float32 in [0, 1] (divided by 255 when integer
    or when its maximum exceeds 1.5), resized with PIL's float LANCZOS
    (mode "F") channel by channel."""
    arr = np.asarray(image)
    is_int = np.issubdtype(arr.dtype, np.integer)
    if is_int and arr.ndim == 3:
        if arr.shape[2] not in (3, 4):
            raise ValueError(f"an integer image needs 3 or 4 channels, got "
                             f"{arr.shape}")
        arr = arr.astype(np.uint8)[..., :3]
        if arr.shape[:2] != (height, width):
            arr = resample.pil_resize(arr, (width, height), "lanczos")
        return arr[None]
    img = arr.astype(np.float32)
    if is_int or img.max() > 1.5:
        img = img / 255.0
    if img.shape[-3] != height or img.shape[-2] != width:
        img = np.stack([resample.pil_resize_float(im, (width, height))
                        for im in (img[None] if img.ndim == 3 else img)])
    return img[None] if img.ndim == 3 else img


def _transport_to_signal(image: np.ndarray) -> np.ndarray:
    """uint8 or unit-float transport form -> float32 in [-1, 1]."""
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    return image * 2.0 - 1.0


def _uniform_transport(images) -> list:
    """One transport dtype for the list: uint8 if every image is uint8,
    else float32 in [-1, 1] (the images are concatenated)."""
    if all(im.dtype == np.uint8 for im in images):
        return list(images)
    return [_transport_to_signal(im) if im.dtype == np.uint8
            else im * 2.0 - 1.0 for im in images]


def numeric_state() -> tuple:
    """The switches that change what the same weights compute: the int8
    conv mode and its activation amax, Winograd, the exp2-folded flash, the
    GroupNorm -> proj_in and LayerNorm -> projection fusions, the int8
    flash modes and the int8 linear path. A memoized device result keys on
    them."""
    return (conv3x3_op.conv_int8_enabled(), conv3x3_op._CONV_INT8_ACT_AMAX,
            conv3x3_op.winograd_enabled(), flash_op.exp2_fold_enabled(),
            transformer_2d.gn_proj_fuse_enabled(),
            attention.ln_matmul_fuse_mode(), attention.attention_int8_mode(),
            layers.linear_int8_enabled(), layers._LINEAR_INT8_AMAX)


def normalize_gs(gs_score, h: int, w: int) -> torch.Tensor:
    """gs_score NHWC (.., h, w, M+1) or NCHW (.., M+1, h, w), with or
    without the batch dim -> (1, h, w, M+1) fp32 NHWC."""
    gs = torch.as_tensor(np.array(gs_score, np.float32))
    if gs.dim() == 3:
        gs = gs[None]
    if gs.shape[1] == h and gs.shape[2] == w:
        return gs
    if gs.shape[2] == h and gs.shape[3] == w:
        return gs.permute(0, 2, 3, 1).contiguous()
    raise ValueError(f"gs_score shape {tuple(gs.shape)} does not match the "
                     f"latent grid ({h}, {w}) in NHWC or NCHW layout")


def _tree_to(tree, device):
    """A param tree with every tensor on ``device`` (the same objects where
    they are there already)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _overlay(local, derived):
    """``derived`` (a sliced tree with derived leaves added) with every leaf
    that ``local`` also has taken from ``local``: equal values, and no
    second copy in device memory."""
    if isinstance(derived, dict):
        return {k: _overlay(local[k], v) if k in local else v
                for k, v in derived.items()}
    if isinstance(derived, (list, tuple)):
        return type(derived)(_overlay(a, b) for a, b in zip(local, derived))
    return local


def _with_profiles(method):
    """Run a pipeline method with its kernel-sharding profiles published
    (``parallel.kernel_sharding.activate``; none before ``shard_to_mesh``)."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with ks.activate(self._kernel_profiles):
            return method(self, *args, **kwargs)
    return wrapper


class BlobNetPipeline:
    """UNet + BlobNet + VAE params on one device, and the single-edit call.

    Params are dicts with the JAX package's key names (see
    ``params.from_jax``), already on ``device``; ``dtype`` is the compute
    dtype of the nets. ``mesh`` (a ``parallel.mesh.Mesh``) is recorded for
    ``shard_to_mesh``."""

    def __init__(self, *, unet_cfg: unet_lib.UNetConfig, unet_params,
                 blobnet_cfg: blobnet_lib.BlobNetConfig, blobnet_params,
                 vae_cfg: vae_lib.VAEConfig, vae_params,
                 clip_cfg: Optional[clip_lib.CLIPTextConfig] = None,
                 clip_params=None,
                 dino_cfg: Optional[dino_lib.DINOv2Config] = None,
                 dino_params=None,
                 tokenizer: Optional[Callable[[Sequence[str]],
                                              np.ndarray]] = None,
                 dtype=torch.float32, device="cuda",
                 dino_image_size: int = 224,
                 mesh=None,
                 safety_checker: Optional[Callable[[np.ndarray],
                                                   np.ndarray]] = None,
                 blackout_nsfw: bool = False):
        self.device = resolve_device(device)
        leaf = unet_params["conv_in"]["kernel"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the pipeline "
                             f"on {self.device}")
        if self.device.type == "cuda" and dtype == torch.float32:
            # fp32 means fp32: cuDNN would otherwise run fp32 convs in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.unet_cfg, self.unet_params = unet_cfg, unet_params
        self.blobnet_cfg, self.blobnet_params = blobnet_cfg, blobnet_params
        self.vae_cfg, self.vae_params = vae_cfg, vae_params
        self.clip_cfg, self.clip_params = clip_cfg, clip_params
        self.dino_cfg, self.dino_params = dino_cfg, dino_params
        self.tokenizer = tokenizer
        self.dino_image_size = dino_image_size
        # the explicit safety policy: the reference registers a checker but
        # comments out its call; here it runs iff one is given (images ->
        # (N,) bool, e.g. functools.partial(models.safety_checker.check,
        # params, cfg)), and blackout_nsfw zeroes the flagged images
        self.safety_checker = safety_checker
        self.blackout_nsfw = blackout_nsfw
        self.dtype = dtype
        self._param_cache = {}
        # encoder memos: a prompt or object repeated across edit rounds is
        # encoded once (keys carry the param tree's version)
        self._prompt_cache = {}
        self._dino_cache = {}
        # the conditioning-latent memo: the [fg; bg] VAE latents by pixels
        self._cond_lat_cache = {}
        self._param_versions = {}
        # the LoRA adapter that params.io.load_pipeline merged, recorded so
        # set_lora_scale can rescale it
        self._lora_tree, self._lora_alpha, self._lora_scale = None, None, 1.0
        self._step_callback_warned = False
        # sharding (shard_to_mesh): the full trees stay in host memory beside
        # the local slices, since derived weights come from the full tree
        self.mesh = mesh
        self._hybrid_cfg_data = False
        self._kernel_profiles = None
        self._full_trees = {}
        self._shard_args = {}
        self._model_parallel = False

    def shard_to_mesh(self, mesh=None, model_parallel: bool = False,
                      hybrid_cfg_data: bool = False):
        """Slice the UNet, BlobNet and VAE trees for this rank
        (``parallel.mesh.shard_params``) and publish the kernel-sharding
        profiles. Every rank calls it, with the same full trees.

          * data: ``edit_batch`` splits its requests over the data group
            (when they divide it); the single edit runs whole on every
            data rank.
          * model_parallel: the Megatron slicing over the model group.
          * hybrid_cfg_data (implies model_parallel): the UNet's CFG pair
            over the data group (its weights over the model group), one
            gather of the noise predictions at the guidance combine; BlobNet
            at the edit batch, its weights over data x model.

        The encoders stay whole. Every cache that holds weights, their
        derivatives or what they computed is cleared."""
        if mesh is not None:
            self.mesh = mesh
        if self.mesh is None:
            raise ValueError("no mesh given")
        self._hybrid_cfg_data = bool(hybrid_cfg_data)
        if hybrid_cfg_data:
            model_parallel = True
        ucfg, bcfg = self.unet_cfg, self.blobnet_cfg
        blob_axes = ("data", "model") if hybrid_cfg_data else ("model",)
        self._shard_args = {
            "unet_params": (("model",), ucfg.num_heads, ucfg.norm_num_groups),
            "blobnet_params": (blob_axes, bcfg.num_heads,
                               bcfg.norm_num_groups),
            "vae_params": (("model",), 1, self.vae_cfg.norm_num_groups)}
        self._model_parallel = bool(model_parallel)
        for name in self._shard_args:
            full = self._full_trees.get(name)
            if full is None:
                full = self._full_trees[name] = _tree_to(getattr(self, name),
                                                         "cpu")
            setattr(self, name, self._shard(name, full))
            self._param_versions.pop(name, None)  # it held the full tree

        def prof(model_axes):
            return ks.KernelProfile(
                self.mesh, model=model_axes if model_parallel else ())

        self._kernel_profiles = {"unet": prof(("model",)),
                                 "blobnet": prof(blob_axes),
                                 "vae": prof(("model",))}
        for cache in (self._param_cache, self._prompt_cache,
                      self._dino_cache, self._cond_lat_cache):
            cache.clear()
        return self

    def _shard(self, name: str, tree):
        """This rank's slice of a full tree of model ``name``, on the
        pipeline's device."""
        axes, heads, groups = self._shard_args[name]
        return mesh_lib.shard_params(self.mesh, tree, self._model_parallel,
                                     axes, heads, groups, device=self.device)

    def _group(self, axes=("data",)):
        return None if self.mesh is None else self.mesh.group(axes)

    def _data_rows(self, n: int) -> Optional[range]:
        """This rank's rows of n when the data group splits them (n
        divides it), else None (every data rank runs all n)."""
        group = self._group()
        if group is None:
            return None
        size = self.mesh.shape["data"]
        if n % size:
            return None
        return multihost.local_rows(n, size, self.mesh.coords["data"])

    def _agreed_seeds(self, seeds: List[Optional[int]]) -> List[int]:
        """Seeds with each None drawn at random, rank 0's draws on every
        rank (the ranks must run the same rows). They cross on the
        pipeline's device: nccl has no CPU tensors."""
        drawn = [int.from_bytes(os.urandom(4), "little") if s is None
                 else int(s) for s in seeds]
        if self.mesh is not None and any(s is None for s in seeds):
            t = collectives.broadcast(
                torch.tensor(drawn, dtype=torch.int64, device=self.device),
                0, self._group(("data", "model")))
            drawn = [int(v) for v in t.tolist()]
        return drawn

    def _conv_params(self, name: str):
        """The param tree ``name``, with derived weights beside its hot
        kernels while a mode that reads them is on: the pre-quantized int8
        weights (``kernel_q``/``w_scale``, ``ops.conv3x3.quantize_conv_tree``)
        in the int8 conv mode or the int8 linear mode, as the JAX package
        derives them for either, and the Winograd-domain ``u``
        (``ops.winograd.transform_conv_tree``) with the Winograd switch on
        outside the int8 conv mode. Derived once per tree and mode, cached
        by identity, so a 50-step edit transforms no weight inside its loop;
        ``self.*_params`` stay as they are. With the modes off the derived
        copies are dropped, so the exact edit holds none in device
        memory. Sharded, the derived weights come from the full tree, on
        the device for the time of the derivation, and are then sliced
        (``parallel.mesh`` deviation 3); the other leaves stay the local
        slices in ``self.*_params``."""
        p = getattr(self, name)
        conv_int8 = conv3x3_op.conv_int8_enabled()
        mode = (conv_int8 or layers.linear_int8_enabled(),
                conv3x3_op.winograd_enabled() and not conv_int8)
        if not any(mode):
            self._param_cache.clear()
            return p
        ent = self._param_cache.get(name)
        if ent is None or ent[0] is not p or ent[1] != mode:
            sharded = name in self._full_trees
            tree = (_tree_to(self._full_trees[name], self.device) if sharded
                    else p)
            tree = conv3x3_op.quantize_conv_tree(tree) if mode[0] else tree
            if mode[1]:
                tree = winograd_op.transform_conv_tree(tree, self.dtype)
            if sharded:
                tree = _overlay(p, self._shard(name, tree))
            ent = self._param_cache[name] = (p, mode, tree)
        return ent[2]

    def _params_version(self, name: str) -> tuple:
        """A memo-key component for the named param tree: a version number
        that changes when the attribute is replaced (the version map holds
        the tree, so a freed tree's id cannot be reused under a live
        key)."""
        tree = getattr(self, name)
        ent = self._param_versions.get(name)
        if ent is None or ent[0] is not tree:
            ent = (tree, 0 if ent is None else ent[1] + 1)
            self._param_versions[name] = ent
        return (name, ent[1])

    def _tokens(self, texts) -> torch.Tensor:
        if self.tokenizer is None or self.clip_params is None:
            raise ValueError("text prompts need a tokenizer and CLIP params "
                             "(pass them to BlobNetPipeline), or pass "
                             "prompt_embeds and negative_prompt_embeds")
        return torch.as_tensor(np.asarray(self.tokenizer(texts)))

    def encode_prompt(self, prompt, negative_prompt,
                      num_images_per_prompt: int, do_cfg: bool,
                      clip_skip: Optional[int] = None,
                      prompt_embeds=None, negative_prompt_embeds=None
                      ) -> torch.Tensor:
        """(2B, T, C) [negative; positive] under CFG, else (B, T, C), on the
        device in the compute dtype. Strings go through CLIP (the positive
        with ``clip_skip``, the negative, "" where none is given, through
        the plain final state, as in the JAX package), memoized by token
        ids: a prompt repeated across edit rounds is not encoded again."""
        nipp = num_images_per_prompt
        dev, dtype = self.device, self.dtype

        def rep(x):
            return torch.repeat_interleave(x, nipp, dim=0)

        def host(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        if prompt_embeds is not None and (not do_cfg or
                                          negative_prompt_embeds is not None):
            pe = rep(host(prompt_embeds))
            if do_cfg:
                pe = torch.cat([rep(host(negative_prompt_embeds)), pe], 0)
            return pe.to(dtype)
        cfg, params = self.clip_cfg, self.clip_params
        if prompt_embeds is None:
            if isinstance(prompt, str):
                prompt = [prompt]
            ids = self._tokens(prompt)
            nids = None
            if do_cfg and negative_prompt_embeds is None:
                if negative_prompt is None:
                    negative_prompt = [""] * len(prompt)
                elif isinstance(negative_prompt, str):
                    negative_prompt = [negative_prompt] * len(prompt)
                nids = self._tokens(negative_prompt)
            if nids is not None or not do_cfg:
                key = (ids.numpy().tobytes(),
                       None if nids is None else nids.numpy().tobytes(),
                       nipp, clip_skip, do_cfg,
                       self._params_version("clip_params"), numeric_state())
                hit = self._prompt_cache.get(key)
                if hit is not None:
                    return hit
                pe = rep(clip_lib.encode_with_clip_skip(params, cfg, ids,
                                                        clip_skip))
                if nids is not None:
                    pe = torch.cat([rep(clip_lib.apply(params, cfg, nids)),
                                    pe], 0)
                pe = pe.to(dtype)
                if len(self._prompt_cache) >= 16:
                    self._prompt_cache.pop(next(iter(self._prompt_cache)))
                self._prompt_cache[key] = pe
                return pe
            # string positives, negatives given as embeddings
            prompt_embeds = clip_lib.encode_with_clip_skip(params, cfg, ids,
                                                           clip_skip)
        pe = prompt_embeds if torch.is_tensor(prompt_embeds) else host(
            prompt_embeds)
        bsz, pe = pe.shape[0], rep(pe)
        if not do_cfg:
            return pe.to(dtype)
        if negative_prompt_embeds is None:
            if negative_prompt is None:
                negative_prompt = [""] * bsz
            elif isinstance(negative_prompt, str):
                negative_prompt = [negative_prompt] * bsz
            npe = clip_lib.apply(params, cfg, self._tokens(negative_prompt))
        else:
            npe = host(negative_prompt_embeds)
        return torch.cat([rep(npe), pe.to(npe.dtype)], 0).to(dtype)

    @staticmethod
    def _dino_uint8_list(fg_image) -> list:
        """fg_image: one image, a list of them, or a batched (M, H, W, 3)
        ndarray -> list of uint8 HWC arrays."""
        if isinstance(fg_image, (list, tuple)):
            images = fg_image
        elif np.asarray(fg_image).ndim == 4:
            images = list(np.asarray(fg_image))
        else:
            images = [fg_image]
        return [np.asarray(im, np.uint8) for im in images]

    def _dino_key(self, images_u8) -> tuple:
        """The DINOv2 memo's key: the pixels, the crop size, the params'
        version and the numeric switches."""
        return (hashlib.blake2b(b"".join(np.ascontiguousarray(x).tobytes()
                                         for x in images_u8),
                                digest_size=16).digest(),
                tuple(x.shape for x in images_u8), self.dino_image_size,
                self._params_version("dino_params"), numeric_state())

    def _dino_remember(self, key, pooled: torch.Tensor):
        if len(self._dino_cache) >= 32:
            self._dino_cache.pop(next(iter(self._dino_cache)))
        self._dino_cache[key] = pooled

    def _dino_pooled_cached(self, images_u8) -> torch.Tensor:
        """(M, Cd) fp32 pooled DINOv2 embeddings of uint8 object images,
        memoized by pixel content: the object of a multi-round edit is
        encoded once."""
        key = self._dino_key(images_u8)
        hit = self._dino_cache.get(key)
        if hit is None:
            px = dino_lib.preprocess_u8(np.stack(images_u8),
                                        size=self.dino_image_size)
            hit = self._encode_dino(torch.as_tensor(px, device=self.device))
            self._dino_remember(key, hit)
        return hit

    def _encode_dino(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the device -> (B, Cd) fp32 pooled output:
        normalized in fp32 first, cast to the compute dtype after."""
        if self.dino_params is None:
            raise ValueError("appearance from object images needs DINOv2 "
                             "params (pass them to BlobNetPipeline), or pass "
                             "fg_dino_feats")
        px = dino_lib.normalize_pixels(pixels_u8).to(self.dtype)
        return dino_lib.apply(self.dino_params, self.dino_cfg, px)[1].float()


    def set_lora_scale(self, scale: float):
        """The runtime LoRA scale (the reference reads it from
        ``cross_attention_kwargs["scale"]``). The merge is linear in the
        scale, so a rescale adds the increment (new - current) onto the
        merged weights: exact up to one rounding to the compute dtype per
        change. It replaces ``unet_params`` with a new tree, so every cached
        derived weight (int8, Winograd) is derived anew. Needs the adapter
        that ``params.io.load_pipeline`` records."""
        if self._lora_tree is None:
            raise ValueError(
                "no LoRA adapter recorded on this pipeline: load it with "
                "params.io.load_pipeline, or merge one with "
                "models.lora.merge_lora(scale=...)")
        if scale == self._lora_scale:
            return
        full = self._full_trees.get("unet_params", self.unet_params)
        merged = lora_lib.merge_lora(
            full, self._lora_tree, scale=scale - self._lora_scale,
            alpha=self._lora_alpha)
        if "unet_params" in self._full_trees:  # sharded: host, then slices
            self._full_trees["unet_params"] = merged
            merged = self._shard("unet_params", merged)
        self.unet_params = merged
        self._lora_scale = scale

    @staticmethod
    def _seed_noise(seed, shape, device=None) -> tuple:
        """Noise for ``seed``, the JAX package's draws for it
        (``utils.threefry``), made on ``device`` (the CPU by default; every
        device draws the same bits): its initial latents ``normal(key(seed),
        shape)``, and ``draw(i, shape)``, its variance noise of step i,
        ``normal(fold_in(fold_in(key(seed), VARIANCE_KEY_TAG), i), shape)``.
        ``seed`` may be a list of R seeds (``edit_batch``): then ``shape``
        is one request's, row r of the latents (R, *shape[1:]) is seed r's
        draw at it, as JAX's ``vmap`` over the keys draws it, and
        ``draw(i, (R, ...))`` draws each row so, all R in one draw."""
        many = isinstance(seed, (list, tuple))
        k = (torch.stack([threefry.key(s) for s in seed]) if many
             else threefry.key(seed))
        vkey = threefry.fold_in(k, VARIANCE_KEY_TAG)

        def normal(k, shape) -> torch.Tensor:
            x = threefry.normal(k, shape, device=device)
            return x.reshape((-1,) + tuple(shape[1:])) if many else x

        def draw(i: int, shape) -> torch.Tensor:
            return normal(threefry.fold_in(vkey, i),
                          (1,) + tuple(shape[1:]) if many else shape)
        return normal(k, shape), draw

    def _variance_noise(self, i: int, shape) -> torch.Tensor:
        """Step i's standard-normal noise for a stochastic sampler (DDIM
        with eta > 0, sde-dpmsolver++), from the call's keys
        (``_seed_noise``): one draw at ``shape`` for a single edit, one row
        per request, each at the solo shape, for ``edit_batch``."""
        return self._noise_draw(i, shape).to(self.device)

    def _encode_images(self, images: np.ndarray, vae_params) -> torch.Tensor:
        """(N, H, W, 3) transport images (uint8, or float in [-1, 1]) ->
        (N, h, w, 4) fp32 scaled VAE latents, in one upload and one
        encode."""
        img = torch.as_tensor(images, device=self.device)
        if img.dtype == torch.uint8:
            img = img.float() / 255.0 * 2.0 - 1.0
        return vae_lib.encode_to_scaled_latents(
            vae_params, self.vae_cfg, img.to(self.dtype)).float()

    def _decode_images(self, final: torch.Tensor, vae_params,
                       gather: bool = False) -> np.ndarray:
        """Final latents -> (N, H, W, 3) float32 in [0, 1], through a uint8
        transport to the host; gather: the data group's rows joined first."""
        img = vae_lib.decode_from_scaled_latents(vae_params, self.vae_cfg,
                                                 final.to(self.dtype))
        img = torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
        u8 = torch.round(img * 255.0).to(torch.uint8)
        if gather:
            u8 = collectives.all_gather(u8, self._group(), dim=0)
        return u8.cpu().numpy().astype(np.float32) / 255.0

    def _screened(self, images: np.ndarray) -> PipelineOutput:
        """The decoded images through the safety checker, if there is one:
        its flags in ``nsfw_content_detected``, the flagged images zeroed
        under ``blackout_nsfw``."""
        has_nsfw = None
        if self.safety_checker is not None:
            has_nsfw = np.asarray(self.safety_checker(images), bool)
            if self.blackout_nsfw:
                images = safety_checker_lib.blackout(images, has_nsfw)
        return PipelineOutput(images=images, nsfw_content_detected=has_nsfw)

    def _cond_lat_key(self, fgbg: np.ndarray, height: int, width: int):
        return (hashlib.blake2b(np.ascontiguousarray(fgbg).tobytes(),
                                digest_size=16).digest(),
                fgbg.shape, str(fgbg.dtype), height, width,
                self._params_version("vae_params"), numeric_state())

    def _cond_latents(self, fgbg: np.ndarray, height: int, width: int,
                      vae_params) -> torch.Tensor:
        """(2, h, w, 4) fp32 scaled VAE latents of the [fg; bg] transport
        pair, memoized by its bytes: a repeated pair skips the upload and
        the encode (an 8-entry FIFO)."""
        key = self._cond_lat_key(fgbg, height, width)
        hit = self._cond_lat_cache.get(key)
        if hit is not None:
            return hit
        lat2 = self._encode_images(fgbg, vae_params)
        if len(self._cond_lat_cache) >= COND_LAT_MEMO:
            self._cond_lat_cache.pop(next(iter(self._cond_lat_cache)))
        self._cond_lat_cache[key] = lat2
        return lat2

    def _emit_step_callback(self, cb, i: int, t: int, latents):
        """The read-only step callback, as the JAX package runs it: returned
        tensor updates are ignored, with one warning per call."""
        ret = cb(self, i, t, {"latents": latents.cpu().numpy()})
        if ret and not self._step_callback_warned:
            self._step_callback_warned = True
            warnings.warn(
                "callback_on_step_end returned tensor updates; they are "
                "ignored: callbacks are read-only here, as in the JAX "
                "package (the torch reference would re-inject 'latents')")

    @torch.inference_mode()
    @_with_profiles
    def __call__(self, prompt=None, fg_image=None, bg_image=None,
                 gs_score=None, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 negative_prompt=None, num_images_per_prompt: int = 1,
                 seed: Optional[int] = None,
                 latents: Optional[np.ndarray] = None,
                 prompt_embeds: Optional[np.ndarray] = None,
                 negative_prompt_embeds: Optional[np.ndarray] = None,
                 blobnet_conditioning_scale: float = 1.0,
                 blobnet_control_guidance_start: float = 0.0,
                 blobnet_control_guidance_end: float = 1.0,
                 clip_skip: Optional[int] = None,
                 scheduler: str = "unipc",
                 output_type: str = "np",
                 encoder_cache_interval: int = 0,
                 encoder_cache_warmup: int = 5,
                 cfg_guidance_start: float = 0.0,
                 cfg_guidance_end: float = 1.0,
                 fg_dino_feats: Optional[np.ndarray] = None,
                 fg_vae_image=None,
                 ip_adapter_image=None,
                 ip_adapter_image_embeds=None,
                 timesteps: Optional[Sequence[int]] = None,
                 eta: float = 0.0,
                 cross_attention_kwargs: Optional[dict] = None,
                 callback_on_step_end: Optional[Callable] = None,
                 callback_on_step_end_tensor_inputs: Sequence[str] = (
                     "latents",),
                 callback_interval: int = 1,
                 return_sample: bool = False) -> PipelineOutput:
        """One element-level edit. gs_score: (1, h, w, M+1) [bg, fg_1..fg_M]
        composited score layers (see ``blob.math``), NHWC or NCHW.
        prompt / negative_prompt: strings (through the tokenizer and CLIP),
        or prompt_embeds / negative_prompt_embeds (B, T, C). fg_image: the
        object image, or a list of M of them (one per blob), embedded by
        DINOv2 unless fg_dino_feats (M, Cd) are given; the VAE sees
        fg_vae_image, else the first object image. Images are uint8 or
        float ndarrays (``preprocess_image_transport``).

        latents: (n, h, w, 4) initial noise. Without them the noise is the
        JAX package's draw for ``seed``, ``normal(PRNGKey(seed), (n, h, w,
        4))``, made on the pipeline's device (``_seed_noise``): the same
        numbers on every device. The variance noise of a stochastic sampler
        is JAX's too, step i's from ``fold_in(fold_in(PRNGKey(seed),
        0x5de), i)`` (``_variance_noise``). A seed left None is drawn from
        urandom.

        scheduler: a name ``make_scheduler`` knows; timesteps:
        a custom descending schedule for any of them; eta: DDIM's variance
        (ignored by the others). output_type="latent" returns the final
        latents. encoder_cache_interval > 1: BlobNet and the UNet encoder
        run on key steps only (the first encoder_cache_warmup steps, every
        interval-th step, the last one and the control window's edges).
        cfg_guidance_start / _end: outside that window of steps only the
        conditional UNet rows run. The two cannot be combined.
        cross_attention_kwargs: only {"scale": s}, the runtime LoRA scale
        (``set_lora_scale``). callback_on_step_end: cb(pipe, i, t,
        {"latents": ndarray}) after the sampler's step i when i %
        callback_interval == 0 and after the last step; read-only.

        Sharded (``shard_to_mesh``): every rank calls it with the same
        arguments; a seed left None is rank 0's draw. Under the hybrid
        recipe a cfg_guidance interval is refused."""
        if ip_adapter_image is not None or ip_adapter_image_embeds is not None:
            raise NotImplementedError(
                "IP-Adapter conditioning is not supported (the reference "
                "exposes these arguments but its own path is broken: it reads "
                "an undefined variable)")
        if return_sample:
            raise NotImplementedError(
                "return_sample is a dead path in the reference: it calls "
                "BlobNet output layers (conv_norm_out, conv_act, conv_out) "
                "that BlobNetModel never defines")
        if cross_attention_kwargs:
            unknown = set(cross_attention_kwargs) - {"scale"}
            if unknown:
                raise NotImplementedError(
                    f"cross_attention_kwargs keys {sorted(unknown)} are not "
                    f"supported: the reference forwards them to attention "
                    f"processors, whose only BlobCtrl use is the LoRA "
                    f"'scale'")
            if cross_attention_kwargs.get("scale") is not None:
                self.set_lora_scale(float(cross_attention_kwargs["scale"]))
        if int(callback_interval) < 1:
            raise ValueError(
                f"callback_interval must be >= 1, got {callback_interval}")
        bad = set(callback_on_step_end_tensor_inputs) - {"latents"}
        if bad:
            raise ValueError(
                f"callback_on_step_end_tensor_inputs must be within "
                f"['latents'], got {sorted(bad)}")
        custom_timesteps = None
        if timesteps is not None:
            custom_timesteps = tuple(int(t) for t in timesteps)
            num_inference_steps = len(custom_timesteps)
        sched = make_scheduler(scheduler, num_inference_steps,
                               eta=eta if scheduler == "ddim" else 0.0,
                               timesteps=custom_timesteps)
        dev = self.device
        do_cfg = guidance_scale > 1.0
        h, w = height // 8, width // 8
        # the argument checks come before the first collective (the seed
        # broadcast), so a sharded edit refused here leaves the ranks in step
        cfg_mask = blobnet_keep_schedule(num_inference_steps,
                                         cfg_guidance_start,
                                         cfg_guidance_end) > 0.0
        if do_cfg and not cfg_mask.all() and self._hybrid_cfg_data:
            raise ValueError(
                "cfg_guidance interval is incompatible with the hybrid "
                "CFG-data sharding recipe (cond-only steps drop the CFG "
                "batch dim the recipe shards over)")
        if do_cfg and not cfg_mask.all() and encoder_cache_interval > 1:
            raise ValueError(
                "cfg_guidance interval cannot be combined with "
                "encoder_cache_interval: the cached encoder state carries "
                "the CFG batch dim that cond-only steps drop")

        if prompt is not None:
            batch_size = 1 if isinstance(prompt, str) else len(prompt)
        else:
            batch_size = np.asarray(prompt_embeds).shape[0]
        pe = self.encode_prompt(prompt, negative_prompt,
                                num_images_per_prompt, do_cfg, clip_skip,
                                prompt_embeds, negative_prompt_embeds)
        cfg_batch = pe.shape[0]
        n = batch_size * num_images_per_prompt

        seed = self._agreed_seeds([seed])[0]
        drawn, self._noise_draw = self._seed_noise(seed, (n, h, w, 4), dev)
        if latents is None:
            latents = drawn
        else:
            latents = torch.as_tensor(np.asarray(latents, np.float32))
            if latents.shape[1] == 4 and latents.shape[-1] != 4:
                latents = latents.permute(0, 2, 3, 1)
        latents = latents.contiguous().to(dev)

        # conditioning: fg and bg through one batched VAE encode, memoized
        if fg_vae_image is None:
            fg_vae_image = (fg_image[0] if isinstance(fg_image, (list, tuple))
                            else fg_image)
        fg, bg = _uniform_transport([
            preprocess_image_transport(fg_vae_image, height, width),
            preprocess_image_transport(bg_image, height, width)])
        if fg.shape[0] != 1 or bg.shape[0] != 1:
            raise ValueError("fg/bg conditioning images must be single "
                             "images")
        vae_params = self._conv_params("vae_params")
        lat2 = self._cond_latents(np.concatenate([fg, bg]), height, width,
                                  vae_params)

        def tile(x):
            return x.repeat(cfg_batch, 1, 1, 1)

        gs = normalize_gs(gs_score, h, w).to(dev)
        if fg_dino_feats is None:
            pooled = self._dino_pooled_cached(self._dino_uint8_list(fg_image))
        else:
            pooled = torch.as_tensor(np.asarray(fg_dino_feats, np.float32),
                                     device=dev)
            if pooled.dim() == 3:
                pooled = pooled[:, 0]
        num_blobs = gs.shape[-1] - 1
        if pooled.shape[0] == 1 and num_blobs > 1:
            pooled = pooled.expand(num_blobs, -1)
        if pooled.shape[0] != num_blobs:
            raise ValueError(f"{pooled.shape[0]} appearance embeddings for "
                             f"{num_blobs} blobs")
        fg_lat, bg_lat = tile(lat2[:1]), tile(lat2[1:])
        bg_score = tile(gs[..., 0:1])
        fg_layers = gs[..., 1:]
        fg_score = tile(fg_layers.sum(-1, keepdim=True))
        # per-blob score layers x per-blob appearance vectors
        fg_feats = tile(torch.einsum("nhwm,mc->nhwc", fg_layers, pooled))

        cond_scales = (blobnet_keep_schedule(
            num_inference_steps, blobnet_control_guidance_start,
            blobnet_control_guidance_end) * float(blobnet_conditioning_scale))
        # encoder cache: key steps run BlobNet and the UNet encoder; the
        # warm-up, every interval-th step, the last step and the control
        # window's edges are always keys
        key_mask = np.ones(num_inference_steps, bool)
        if encoder_cache_interval > 1:
            for i in range(num_inference_steps):
                key_mask[i] = (i < encoder_cache_warmup
                               or i % encoder_cache_interval == 0
                               or i == num_inference_steps - 1
                               or cond_scales[i] != cond_scales[i - 1])
        callback = None
        if callback_on_step_end is not None:
            self._step_callback_warned = False
            every = int(callback_interval)

            def callback(i, t, lat):
                if i % every == 0 or i == num_inference_steps - 1:
                    self._emit_step_callback(callback_on_step_end, i, t, lat)

        final = self._denoise(sched, latents, pe, fg_lat, bg_lat, fg_score,
                              bg_score, fg_feats, cond_scales,
                              float(guidance_scale), do_cfg, key_mask,
                              cfg_mask if do_cfg else None, callback)
        if output_type == "latent":
            return PipelineOutput(images=final.cpu().numpy())
        return self._screened(self._decode_images(final, vae_params))

    @torch.inference_mode()
    @_with_profiles
    def edit_batch(self, requests: List[dict], height: int = 512,
                   width: int = 512, num_inference_steps: int = 50,
                   guidance_scale: float = 7.5,
                   blobnet_conditioning_scale: float = 1.0,
                   blobnet_control_guidance_start: float = 0.0,
                   blobnet_control_guidance_end: float = 1.0,
                   clip_skip: Optional[int] = None,
                   scheduler: str = "unipc",
                   output_type: str = "np") -> PipelineOutput:
        """B distinct edits in one batched run: the serving path of dynamic
        micro-batching (``apps/server.py``). Every step runs BlobNet, the
        UNet and the sampler once over all B requests' CFG rows, so the
        fixed costs (encodes, decode, per-step launches and host work) are
        paid once for the batch.

        requests: dicts with prompt (str) and negative_prompt (optional),
        or prompt_embeds and negative_prompt_embeds; fg_image, bg_image,
        gs_score, seed (optional), fg_dino_feats (optional (M, Cd)),
        fg_vae_image (optional). They share the sampler configuration (the
        keyword arguments) and carry the same blob count M.

        Each request draws its initial and variance noise from its own seed
        at the solo shape, as ``__call__`` draws them (``_seed_noise``) and
        as the JAX package's ``edit_batch`` draws them, so a batched edit,
        stochastic samplers included, is its solo edit up to the rounding
        of batched operations. The 2B images go through one VAE encode
        (the conditioning-latent memo stays off: a serving batch's images
        differ), the DINOv2 cache misses through one encode. The safety
        checker, if any, screens the B images, one flag each.

        Sharded with a data group (``shard_to_mesh``): when B divides it,
        each data rank runs its contiguous rows and the images are gathered
        (else every data rank runs all B); seeds left None are rank 0's
        draws. Every rank calls it with the same requests."""
        if not requests:
            raise ValueError("edit_batch needs at least one request")
        sched = make_scheduler(scheduler, num_inference_steps)
        seeds = self._agreed_seeds([r.get("seed") for r in requests])
        requests = [dict(r, seed=s) for r, s in zip(requests, seeds)]
        rows = None if self._hybrid_cfg_data else self._data_rows(
            len(requests))
        if rows is not None:
            requests = [requests[i] for i in rows]
        n = len(requests)
        dev = self.device
        do_cfg = guidance_scale > 1.0
        h, w = height // 8, width // 8

        if any("prompt_embeds" in r for r in requests):
            def row(r, key):
                v = r.get(key)
                if v is None:
                    raise ValueError(f"all requests must carry {key} when "
                                     "any does (mixed batches would need a "
                                     "tokenizer for the rest)")
                v = np.asarray(v, np.float32)
                return v[0] if v.ndim == 3 else v
            pe_arr = np.stack([row(r, "prompt_embeds") for r in requests])
            npe_arr = (np.stack([row(r, "negative_prompt_embeds")
                                 for r in requests]) if do_cfg else None)
            pe = self.encode_prompt(None, None, 1, do_cfg, clip_skip,
                                    pe_arr, npe_arr)
        else:
            pe = self.encode_prompt(
                [r.get("prompt") or "" for r in requests],
                [r.get("negative_prompt") or "" for r in requests],
                1, do_cfg, clip_skip)

        latents, self._noise_draw = self._seed_noise(
            [r["seed"] for r in requests], (1, h, w, 4), dev)

        fgs, bgs, gss = [], [], []
        for r in requests:
            fg_vae = r.get("fg_vae_image")
            if fg_vae is None:
                fg_vae = (r["fg_image"][0]
                          if isinstance(r["fg_image"], (list, tuple))
                          else r["fg_image"])
            fgs.append(preprocess_image_transport(fg_vae, height, width))
            bgs.append(preprocess_image_transport(r["bg_image"], height,
                                                  width))
            gss.append(normalize_gs(r["gs_score"], h, w))
        num_blobs = gss[0].shape[-1] - 1
        if any(g.shape[-1] - 1 != num_blobs for g in gss):
            raise ValueError("all requests in a batch must carry the same "
                             "blob count M")
        vae_params = self._conv_params("vae_params")
        # [all fg rows; all bg rows] in one upload and one encode
        lat2 = self._encode_images(
            np.concatenate(_uniform_transport(fgs + bgs)), vae_params)

        # appearance: the DINOv2 cache misses of the whole batch in one
        # encode, hits and given features in none
        pooled_rows = [None] * n
        misses, to_encode = [], []
        for b, r in enumerate(requests):
            feats = r.get("fg_dino_feats")
            if feats is not None:
                f = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
                if f.dim() == 3:
                    f = f[:, 0]
                pooled_rows[b] = f[None] if f.dim() == 1 else f
                continue
            imgs = self._dino_uint8_list(r["fg_image"])
            key = self._dino_key(imgs)
            pooled_rows[b] = self._dino_cache.get(key)
            if pooled_rows[b] is None:
                misses.append((b, len(imgs), key))
                to_encode.extend(imgs)
        if to_encode:
            px = dino_lib.preprocess_u8(np.stack(to_encode),
                                        size=self.dino_image_size)
            enc = self._encode_dino(torch.as_tensor(px, device=dev))
            off = 0
            for b, m, key in misses:
                pooled_rows[b] = enc[off:off + m]
                self._dino_remember(key, pooled_rows[b])
                off += m
        for b, f in enumerate(pooled_rows):
            if f.shape[0] == 1 and num_blobs > 1:
                pooled_rows[b] = f = f.expand(num_blobs, -1)
            if f.shape[0] != num_blobs:
                raise ValueError(f"request {b}: {f.shape[0]} appearance "
                                 f"embeddings for {num_blobs} blobs")
        pooled = torch.stack(pooled_rows)  # (B, M, Cd)

        def tile(x):  # the B request rows, once per CFG group
            return x.repeat(pe.shape[0] // n, 1, 1, 1)

        gs = torch.cat(gss).to(dev)
        fg_layers = gs[..., 1:]
        fg_feats = tile(torch.einsum("nhwm,nmc->nhwc", fg_layers, pooled))
        cond_scales = (blobnet_keep_schedule(
            num_inference_steps, blobnet_control_guidance_start,
            blobnet_control_guidance_end) * float(blobnet_conditioning_scale))
        final = self._denoise(
            sched, latents, pe, tile(lat2[:n]), tile(lat2[n:]),
            tile(fg_layers.sum(-1, keepdim=True)), tile(gs[..., 0:1]),
            fg_feats, cond_scales, float(guidance_scale), do_cfg,
            np.ones(num_inference_steps, bool), None, None)
        if output_type == "latent":
            if rows is not None:
                final = collectives.all_gather(final, self._group(), dim=0)
            return PipelineOutput(images=final.cpu().numpy())
        return self._screened(self._decode_images(final, vae_params,
                                                  gather=rows is not None))

    def _denoise(self, sched, latents, pe, fg_lat, bg_lat, fg_score,
                 bg_score, fg_feats, cond_scales, guidance_scale, do_cfg,
                 key_mask, cfg_mask, callback):
        """The sampling loop. key_mask (S,): steps that run BlobNet and the
        UNet encoder (all True without the encoder cache); on the others
        the last key step's (x_mid, skips, up residuals) feed the decoder.
        cfg_mask (S,) or None: steps under CFG; on the others the UNet runs
        the conditional rows alone.

        Hybrid recipe: this rank's UNet runs its data group's share of the
        CFG rows (all of them when they do not divide it), and the noise
        predictions are gathered over the group before the guidance
        combine; BlobNet runs at the edit batch on every rank."""
        dtype = self.dtype
        ucfg, bcfg = self.unet_cfg, self.blobnet_cfg
        unet_params = self._conv_params("unet_params")
        blobnet_params = self._conv_params("blobnet_params")
        n = latents.shape[0]
        blob_cond_left = torch.cat([fg_lat[:n], fg_score[:n], fg_feats[:n]],
                                   -1).to(dtype)
        blob_cond_right_extras = torch.cat([fg_score[:n], fg_feats[:n]],
                                           -1).to(dtype)
        unet_cond_left = torch.cat([bg_lat, bg_score], -1).to(dtype)
        bg_score_d = bg_score.to(dtype)

        def crop_right(r):
            return r[:, :, r.shape[2] - r.shape[1]:, :]

        cfg_rows = (self._data_rows(pe.shape[0])
                    if self._hybrid_cfg_data and do_cfg else None)

        def local(x):  # this rank's CFG rows under the hybrid recipe
            return x if cfg_rows is None else x[cfg_rows.start:cfg_rows.stop]

        def blobnet(i, t, sample_d):
            """BlobNet's cropped residuals at the edit batch, or None
            outside the control window (zeros would change nothing)."""
            if cond_scales[i] == 0.0:
                return None
            blob_in = torch.cat(
                [blob_cond_left,
                 torch.cat([sample_d, blob_cond_right_extras], -1)], dim=2)
            # the scale is rounded to the compute dtype, as the nets see it
            scale = torch.tensor(float(cond_scales[i]), dtype=dtype).item()
            res = blobnet_lib.blobnet_apply(blobnet_params, bcfg, blob_in, t,
                                            conditioning_scale=scale)
            d_res, m_res, u_res = res
            return ([crop_right(r) for r in d_res], crop_right(m_res),
                    [crop_right(r) for r in u_res])

        def encode(i, t, sample_d, rows, context):
            """-> (x_mid, skips, up residuals) of the UNet encoder; rows is
            the CFG batch the UNet runs at (BlobNet's residuals, at the
            edit batch, are repeated for each group of n rows)."""
            lmi = torch.cat([sample_d] * (rows // n), 0)
            left = unet_cond_left[-rows:]
            unet_in = torch.cat([left, torch.cat([lmi, bg_score_d[-rows:]],
                                                 -1)], dim=2)
            res = blobnet(i, t, sample_d)
            down = mid = up = None
            if res is not None:
                def rep(r):
                    return local(torch.cat([r] * (rows // n), 0)
                                 if rows > n else r)
                down = [rep(r) for r in res[0]]
                mid = rep(res[1])
                up = [rep(r) for r in res[2]]
            x_mid, skips = unet_lib.unet_encode(
                unet_params, ucfg, local(unet_in), t, local(context),
                down_block_add_samples=down, mid_block_add_sample=mid)
            return x_mid, skips, up

        def decode(t, enc, context):
            x_mid, skips, up = enc
            out = unet_lib.unet_decode(unet_params, ucfg, x_mid, skips, t,
                                       local(context),
                                       up_block_add_samples=up)
            out = out[:, :, out.shape[2] // 2:, :].float()
            if cfg_rows is not None:  # the tiny gather at the combine
                out = collectives.all_gather(out, self._group(), dim=0)
            return out

        if isinstance(sched, unipc_lib.UniPCSchedule):
            state = unipc_lib.init_state(sched, latents)
        elif isinstance(sched, dpm_lib.DPMSchedule):
            state = dpm_lib.init_state(sched, latents)
        else:
            state = (latents,)
        enc = None
        for i in range(sched.num_steps):
            t = float(sched.timesteps[i])
            sample_d = state[0].to(dtype)
            if cfg_mask is not None and not cfg_mask[i]:
                # outside the guidance interval: the conditional rows only
                noise_pred = decode(t, encode(i, t, sample_d, n, pe[n:]),
                                    pe[n:])
            else:
                if enc is None or key_mask[i]:
                    enc = encode(i, t, sample_d, pe.shape[0], pe)
                noise_pred = decode(t, enc, pe)
                if do_cfg:
                    uncond, cond = noise_pred.chunk(2, 0)
                    noise_pred = uncond + guidance_scale * (cond - uncond)
            if isinstance(sched, unipc_lib.UniPCSchedule):
                state = unipc_lib.step(sched, i, noise_pred, state)
            elif isinstance(sched, dpm_lib.DPMSchedule):
                state = dpm_lib.step(
                    sched, i, noise_pred, state,
                    noise=(self._variance_noise(i, state[0].shape)
                           if sched.stochastic else None))
            else:
                state = (ddim_lib.step(
                    sched, i, noise_pred, state[0],
                    noise=(self._variance_noise(i, state[0].shape)
                           if sched.eta > 0.0 else None)),)
            if callback is not None:
                callback(i, int(sched.timesteps[i]), state[0])
        return state[0]
