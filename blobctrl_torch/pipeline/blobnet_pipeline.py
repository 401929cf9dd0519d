"""The BlobCtrl edit pipeline in PyTorch (counterpart of
``blobctrl_tpu/pipeline/blobnet_pipeline.py``, ``BlobNetPipeline.__call__``
on the host-embeds path).

One edit: VAE-encode the fg and bg images in one batch; build the
width-concat inputs; for each UniPC step run BlobNet (at the edit batch,
its residuals broadcast to both CFG rows, skipped outside the control
window) and the UNet with the right-half injections, combine under CFG and
step the scheduler; VAE-decode; transport the image as uint8. The loop runs
eagerly; the hot convs and attentions go through the hand-written kernels
(``blobctrl_torch.ops``) when the pipeline runs on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.models import blobnet as blobnet_lib
from blobctrl_torch.models import unet as unet_lib
from blobctrl_torch.models import vae as vae_lib
from blobctrl_torch.ops import conv3x3 as conv3x3_op
from blobctrl_torch.ops import winograd as winograd_op
from blobctrl_torch.schedulers import unipc as unipc_lib


@dataclasses.dataclass
class PipelineOutput:
    images: np.ndarray  # (B, H, W, 3) float32 in [0, 1]


def blobnet_keep_schedule(num_steps: int, start: float,
                          end: float) -> np.ndarray:
    """Per-step gate of the BlobNet control window."""
    keeps = [1.0 - float(i / num_steps < start or (i + 1) / num_steps > end)
             for i in range(num_steps)]
    return np.asarray(keeps, np.float32)


def image_transport(image, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, 3) or (1, H, W, 3) ndarray at the target size ->
    (1, H, W, 3) uint8. Resizing is not ported."""
    arr = np.asarray(image)
    if arr.ndim == 3:
        arr = arr[None]
    if not np.issubdtype(arr.dtype, np.integer) or arr.ndim != 4 \
            or arr.shape[0] != 1 or arr.shape[3] != 3:
        raise NotImplementedError(
            f"images must be one integer (H, W, 3) ndarray, got "
            f"{arr.dtype} {arr.shape}")
    if arr.shape[1:3] != (height, width):
        raise NotImplementedError(
            f"image of {arr.shape[1:3]} at target size {(height, width)}: "
            f"resizing is not ported")
    return arr.astype(np.uint8)


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
                 dtype=torch.float32, device="cuda"):
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
        self.dtype = dtype
        self._param_cache = {}

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

    @torch.inference_mode()
    def __call__(self, prompt=None, fg_image=None, bg_image=None,
                 gs_score=None, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 seed: Optional[int] = None,
                 latents: Optional[np.ndarray] = None,
                 prompt_embeds: Optional[np.ndarray] = None,
                 negative_prompt_embeds: Optional[np.ndarray] = None,
                 blobnet_conditioning_scale: float = 1.0,
                 blobnet_control_guidance_start: float = 0.0,
                 blobnet_control_guidance_end: float = 1.0,
                 scheduler: str = "unipc",
                 fg_dino_feats: Optional[np.ndarray] = None
                 ) -> PipelineOutput:
        """One element-level edit. gs_score: (1, h, w, M+1) [bg, fg_1..fg_M]
        composited score layers (see ``blob.math``), NHWC or NCHW;
        fg_dino_feats: (M, Cd) per-blob appearance embeddings;
        prompt_embeds / negative_prompt_embeds: (B, T, C) text embeddings.

        latents: (n, h, w, 4) initial noise. Without them the noise is drawn
        from ``torch.Generator().manual_seed(seed)`` on the CPU: the same
        numbers on every device, but by design not JAX's draw for that seed.
        """
        if prompt is not None or prompt_embeds is None:
            raise NotImplementedError("text prompts need CLIP, which is not "
                                      "ported: pass prompt_embeds")
        if fg_dino_feats is None:
            raise NotImplementedError("appearance needs DINOv2, which is not "
                                      "ported: pass fg_dino_feats")
        if scheduler != "unipc":
            raise NotImplementedError(f"scheduler {scheduler!r}: only "
                                      f"'unipc' is ported")
        dev, dtype = self.device, self.dtype
        do_cfg = guidance_scale > 1.0
        h, w = height // 8, width // 8

        # text embeddings, [negative; positive] under CFG
        pe = np.asarray(prompt_embeds, np.float32)
        if do_cfg:
            if negative_prompt_embeds is None:
                raise ValueError("guidance_scale > 1 needs "
                                 "negative_prompt_embeds")
            pe = np.concatenate([np.asarray(negative_prompt_embeds,
                                            np.float32), pe], axis=0)
        pe = torch.as_tensor(pe, device=dev).to(dtype)
        cfg_batch, n = pe.shape[0], pe.shape[0] // (2 if do_cfg else 1)

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
        fgbg = np.concatenate([image_transport(fg_image, height, width),
                               image_transport(bg_image, height, width)])
        img = torch.as_tensor(fgbg, device=dev).float() / 255.0 * 2.0 - 1.0
        vae_params = self._conv_params("vae_params")
        lat2 = vae_lib.encode_to_scaled_latents(
            vae_params, self.vae_cfg, img.to(dtype)).float()

        def tile(x):
            return x.repeat(cfg_batch, 1, 1, 1)

        gs = normalize_gs(gs_score, h, w).to(dev)
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
