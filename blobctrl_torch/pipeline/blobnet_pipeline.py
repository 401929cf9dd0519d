"""The BlobCtrl edit pipeline in PyTorch (counterpart of
``blobctrl_tpu/pipeline/blobnet_pipeline.py``, ``BlobNetPipeline.__call__``).

Text comes as prompt strings (tokenizer + CLIP text, memoized by token
ids) or as embeddings; appearance as object images (DINOv2's pooled CLS,
memoized by pixel content) or as embeddings. One edit: VAE-encode the fg
and bg images in one batch; build the width-concat inputs; for each UniPC
step run BlobNet (at the edit batch, its residuals broadcast to both CFG
rows, skipped outside the control window) and the UNet with the
right-half injections, combine under CFG and step the scheduler;
VAE-decode; transport the image as uint8. The loop runs eagerly; the hot
convs and attentions go through the hand-written kernels
(``blobctrl_torch.ops``) when the pipeline runs on the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.models import blobnet as blobnet_lib
from blobctrl_torch.models import clip_text as clip_lib
from blobctrl_torch.models import dinov2 as dino_lib
from blobctrl_torch.models import unet as unet_lib
from blobctrl_torch.models import vae as vae_lib
from blobctrl_torch.ops import conv3x3 as conv3x3_op
from blobctrl_torch.ops import winograd as winograd_op
from blobctrl_torch.schedulers import unipc as unipc_lib
from blobctrl_torch.utils import resample


@dataclasses.dataclass
class PipelineOutput:
    images: np.ndarray  # (B, H, W, 3) float32 in [0, 1]


def blobnet_keep_schedule(num_steps: int, start: float,
                          end: float) -> np.ndarray:
    """Per-step gate of the BlobNet control window."""
    keeps = [1.0 - float(i / num_steps < start or (i + 1) / num_steps > end)
             for i in range(num_steps)]
    return np.asarray(keeps, np.float32)


def preprocess_image_transport(image, height: int, width: int) -> np.ndarray:
    """An integer (H, W, 3) or (1, H, W, 3) ndarray -> (1, height, width, 3)
    uint8, resized with PIL's LANCZOS where the size differs (the port's
    bit-exact copy, ``utils/resample``), as the JAX package resizes it.
    Float images, which the JAX package resamples in float, are not
    ported."""
    arr = np.asarray(image)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    if not np.issubdtype(arr.dtype, np.integer) or arr.ndim != 3 \
            or arr.shape[2] != 3:
        raise NotImplementedError(
            f"images must be one integer (H, W, 3) ndarray, got "
            f"{arr.dtype} {arr.shape}")
    arr = arr.astype(np.uint8)
    if arr.shape[:2] != (height, width):
        arr = resample.pil_resize(arr, (width, height), "lanczos")
    return arr[None]


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


class BlobNetPipeline:
    """UNet + BlobNet + VAE params on one device, and the single-edit call.

    Params are dicts with the JAX package's key names (see
    ``params.from_jax``), already on ``device``; ``dtype`` is the compute
    dtype of the nets."""

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
                 dino_image_size: int = 224, safety_checker=None):
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
        if safety_checker is not None:
            raise NotImplementedError("the safety checker is not ported")
        self.dtype = dtype
        self._param_cache = {}
        # encoder memos: a prompt or object repeated across edit rounds is
        # encoded once (keys carry the param tree's version)
        self._prompt_cache = {}
        self._dino_cache = {}
        self._param_versions = {}

    def _conv_params(self, name: str):
        """The param tree ``name``, with derived weights beside its hot
        kernels while a mode that reads them is on: the pre-quantized int8
        weights (``kernel_q``/``w_scale``, ``ops.conv3x3.quantize_conv_tree``)
        in the int8 conv mode, else the Winograd-domain ``u``
        (``ops.winograd.transform_conv_tree``) with the Winograd switch on.
        Derived once per tree and mode, cached by identity, so a 50-step
        edit transforms no weight inside its loop; ``self.*_params`` stay as
        they are. With the modes off the derived copies are dropped, so the
        exact edit holds none in device memory."""
        p = getattr(self, name)
        if conv3x3_op.conv_int8_enabled():
            mode = "int8"
        elif conv3x3_op.winograd_enabled():
            mode = "winograd"
        else:
            self._param_cache.clear()
            return p
        ent = self._param_cache.get(name)
        if ent is None or ent[0] is not p or ent[1] != mode:
            ent = self._param_cache[name] = (p, mode, (
                conv3x3_op.quantize_conv_tree(p) if mode == "int8"
                else winograd_op.transform_conv_tree(p, self.dtype)))
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
                       self._params_version("clip_params"))
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

    def _dino_pooled_cached(self, images_u8) -> torch.Tensor:
        """(M, Cd) fp32 pooled DINOv2 embeddings of uint8 object images,
        memoized by pixel content: the object of a multi-round edit is
        encoded once."""
        key = (hashlib.blake2b(b"".join(np.ascontiguousarray(x).tobytes()
                                        for x in images_u8),
                               digest_size=16).digest(),
               tuple(x.shape for x in images_u8), self.dino_image_size,
               self._params_version("dino_params"))
        hit = self._dino_cache.get(key)
        if hit is None:
            px = dino_lib.preprocess_u8(np.stack(images_u8),
                                        size=self.dino_image_size)
            hit = self._encode_dino(torch.as_tensor(px, device=self.device))
            if len(self._dino_cache) >= 32:
                self._dino_cache.pop(next(iter(self._dino_cache)))
            self._dino_cache[key] = hit
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

    @torch.inference_mode()
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
                 encoder_cache_interval: int = 0,
                 cfg_guidance_start: float = 0.0,
                 cfg_guidance_end: float = 1.0,
                 fg_dino_feats: Optional[np.ndarray] = None,
                 fg_vae_image=None,
                 callback_on_step_end=None) -> PipelineOutput:
        """One element-level edit. gs_score: (1, h, w, M+1) [bg, fg_1..fg_M]
        composited score layers (see ``blob.math``), NHWC or NCHW.
        prompt / negative_prompt: strings (through the tokenizer and CLIP),
        or prompt_embeds / negative_prompt_embeds (B, T, C). fg_image: the
        object image, or a list of M of them (one per blob), embedded by
        DINOv2 unless fg_dino_feats (M, Cd) are given; the VAE sees
        fg_vae_image, else the first object image.

        latents: (n, h, w, 4) initial noise. Without them the noise is drawn
        from ``torch.Generator().manual_seed(seed)`` on the CPU: the same
        numbers on every device, but by design not JAX's draw for that seed.
        """
        if scheduler != "unipc":
            raise NotImplementedError(f"scheduler {scheduler!r}: only "
                                      f"'unipc' is ported")
        if encoder_cache_interval > 1:
            raise NotImplementedError("encoder_cache_interval (the encoder "
                                      "cache) is not ported")
        if (cfg_guidance_start, cfg_guidance_end) != (0.0, 1.0):
            raise NotImplementedError("guidance-interval CFG is not ported")
        if callback_on_step_end is not None:
            raise NotImplementedError("step callbacks are not ported")
        dev, dtype = self.device, self.dtype
        do_cfg = guidance_scale > 1.0
        h, w = height // 8, width // 8

        if prompt is not None:
            batch_size = 1 if isinstance(prompt, str) else len(prompt)
        else:
            batch_size = np.asarray(prompt_embeds).shape[0]
        pe = self.encode_prompt(prompt, negative_prompt,
                                num_images_per_prompt, do_cfg, clip_skip,
                                prompt_embeds, negative_prompt_embeds)
        cfg_batch = pe.shape[0]
        n = batch_size * num_images_per_prompt

        if latents is None:
            if seed is None:
                seed = int.from_bytes(os.urandom(4), "little")
            gen = torch.Generator().manual_seed(int(seed))
            latents = torch.randn((n, h, w, 4), generator=gen)
        latents = torch.as_tensor(np.asarray(latents, np.float32))
        if latents.shape[1] == 4 and latents.shape[-1] != 4:
            latents = latents.permute(0, 2, 3, 1)
        latents = latents.contiguous().to(dev)

        # conditioning: fg and bg through one batched VAE encode
        if fg_vae_image is None:
            fg_vae_image = (fg_image[0] if isinstance(fg_image, (list, tuple))
                            else fg_image)
        fgbg = np.concatenate([
            preprocess_image_transport(fg_vae_image, height, width),
            preprocess_image_transport(bg_image, height, width)])
        img = torch.as_tensor(fgbg, device=dev).float() / 255.0 * 2.0 - 1.0
        vae_params = self._conv_params("vae_params")
        lat2 = vae_lib.encode_to_scaled_latents(
            vae_params, self.vae_cfg, img.to(dtype)).float()

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
        final = self._denoise(latents, pe, fg_lat, bg_lat, fg_score, bg_score,
                              fg_feats, cond_scales, float(guidance_scale),
                              num_inference_steps, do_cfg)
        img = vae_lib.decode_from_scaled_latents(vae_params, self.vae_cfg,
                                                 final.to(dtype))
        img = torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
        # uint8 transport to the host; the public contract is float32 [0, 1]
        u8 = torch.round(img * 255.0).to(torch.uint8).cpu().numpy()
        return PipelineOutput(images=u8.astype(np.float32) / 255.0)

    def _denoise(self, latents, pe, fg_lat, bg_lat, fg_score, bg_score,
                 fg_feats, cond_scales, guidance_scale, num_steps, do_cfg):
        dtype = self.dtype
        ucfg, bcfg = self.unet_cfg, self.blobnet_cfg
        unet_params = self._conv_params("unet_params")
        blobnet_params = self._conv_params("blobnet_params")
        n = latents.shape[0]
        sched = unipc_lib.make(num_steps)
        blob_cond_left = torch.cat([fg_lat[:n], fg_score[:n], fg_feats[:n]],
                                   -1).to(dtype)
        blob_cond_right_extras = torch.cat([fg_score[:n], fg_feats[:n]],
                                           -1).to(dtype)
        unet_cond_left = torch.cat([bg_lat, bg_score], -1).to(dtype)
        bg_score_d = bg_score.to(dtype)

        def crop_right(r):
            return r[:, :, r.shape[2] - r.shape[1]:, :]

        def bcast(r):
            # BlobNet ran at the edit batch: one copy per CFG row
            r = crop_right(r)
            return torch.cat([r, r], 0) if do_cfg else r

        state = unipc_lib.init_state(sched, latents)
        for i in range(num_steps):
            t = float(sched.timesteps[i])
            sample_d = state[0].to(dtype)
            lmi = torch.cat([sample_d] * 2, 0) if do_cfg else sample_d
            unet_in = torch.cat([unet_cond_left,
                                 torch.cat([lmi, bg_score_d], -1)], dim=2)
            down = mid = up = None
            if cond_scales[i] != 0.0:
                blob_in = torch.cat(
                    [blob_cond_left,
                     torch.cat([sample_d, blob_cond_right_extras], -1)],
                    dim=2)
                # the scale is rounded to the compute dtype, as the nets see it
                scale = torch.tensor(float(cond_scales[i]), dtype=dtype).item()
                d_res, m_res, u_res = blobnet_lib.blobnet_apply(
                    blobnet_params, bcfg, blob_in, t,
                    conditioning_scale=scale)
                down = [bcast(r) for r in d_res]
                mid = bcast(m_res)
                up = [bcast(r) for r in u_res]
            # outside the control window BlobNet is skipped: its residuals
            # would be zeros, and adding zeros changes nothing
            x_mid, skips = unet_lib.unet_encode(
                unet_params, ucfg, unet_in, t, pe,
                down_block_add_samples=down, mid_block_add_sample=mid)
            noise_pred = unet_lib.unet_decode(
                unet_params, ucfg, x_mid, skips, t, pe,
                up_block_add_samples=up)
            noise_pred = noise_pred[:, :, noise_pred.shape[2] // 2:, :].float()
            if do_cfg:
                uncond, cond = noise_pred.chunk(2, 0)
                noise_pred = uncond + guidance_scale * (cond - uncond)
            state = unipc_lib.step(sched, i, noise_pred, state)
        return state[0]
