"""BlobData-style training batches (counterpart of
``blobctrl_tpu/train/data.py``).

An (image, object mask, prompt embedding) triple becomes the conditioning
the inference path builds: the blob ellipse fitted to the mask (inflated
by 5 %), fg = the object re-centred on a white canvas, bg = the image with
the blob's region blacked (and optionally a white-out ellipse), the
splatted blob scores and the DINOv2 appearance splat; the target, fg and
bg images are VAE-encoded by the pipeline's own encoder. Every value is
returned as numpy, so no tensor made under the pipeline's inference mode
reaches autograd.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from blobctrl_torch.blob import editor as editor_lib
from blobctrl_torch.blob import math as blob_math
from blobctrl_torch.blob import viz as viz_lib
from blobctrl_torch.models import dinov2 as dino_lib
from blobctrl_torch.pipeline.blobnet_pipeline import (
    preprocess_image_transport)


@torch.no_grad()
def encode_example(pipeline, image: np.ndarray, mask: np.ndarray,
                   prompt_embeds: np.ndarray, size: int = 512,
                   inflate: float = 1.05,
                   whiteout_ellipse=None) -> Dict[str, np.ndarray]:
    """``build_example``'s example held compact: the pooled DINOv2 vector
    ("dino_pooled", (Cd,)) in place of its splat "fg_feats" (h, w, Cd),
    which ``collate`` forms: at 512^2 with DINOv2-L's 1024 channels the
    splat alone is 64 x 64 x 1024 fp32, 16 MiB an example."""
    lh = lw = size // 8
    ellipse = editor_lib.ellipse_from_mask(mask)
    ellipse, _, _ = editor_lib.resize_ellipse(ellipse, inflate, size, size, 0)
    fg_img = editor_lib.object_region_on_canvas(image, mask, canvas=size)
    # the target region blacked, as the session builds the edited
    # background at inference (start white, target black)
    bg_img = viz_lib.composite_mask_and_image(
        viz_lib.ellipse_mask(ellipse, size, size), image, (0, 0, 0))
    if whiteout_ellipse is not None:
        bg_img = viz_lib.composite_mask_and_image(
            viz_lib.ellipse_mask(whiteout_ellipse, size, size), bg_img,
            (255, 255, 255))
    gs = blob_math.blob_score_from_ellipse(ellipse, size, size,
                                           (lh, lw)).numpy()
    bg_score, fg_score = gs[..., 0:1], gs[..., 1:2]

    vae = pipeline._conv_params("vae_params")
    lat = pipeline._encode_images(np.concatenate([
        preprocess_image_transport(im, size, size)
        for im in (image, fg_img, bg_img)]), vae).cpu().numpy()
    px = dino_lib.preprocess_u8(fg_img[None], size=pipeline.dino_image_size)
    pooled = pipeline._encode_dino(torch.as_tensor(
        px, device=pipeline.device)).cpu().numpy()
    return {
        "x0_latents": lat[0], "fg_latents": lat[1], "bg_latents": lat[2],
        "fg_score": fg_score[0].astype(np.float32),
        "bg_score": bg_score[0].astype(np.float32),
        "dino_pooled": pooled[0].astype(np.float32),
        "text_embeds": np.asarray(prompt_embeds, np.float32),
    }


def build_example(pipeline, image: np.ndarray, mask: np.ndarray,
                  prompt_embeds: np.ndarray, size: int = 512,
                  inflate: float = 1.05,
                  whiteout_ellipse=None) -> Dict[str, np.ndarray]:
    """One training example from an image (uint8 (size, size, 3)) and its
    binary object mask, through the pipeline's VAE and DINOv2 encoders.

    whiteout_ellipse: an optional cv2-style ellipse whited out in the
    background conditioning (the move edit's vacated region, white at
    inference)."""
    return {k: v[0] for k, v in collate([encode_example(
        pipeline, image, mask, prompt_embeds, size, inflate,
        whiteout_ellipse)]).items()}


def collate(examples: Sequence[Dict[str, np.ndarray]]
            ) -> Dict[str, np.ndarray]:
    """The examples stacked into a batch, their "dino_pooled" vectors
    splat by "fg_score" into "fg_feats" (the float32 products
    ``build_example`` returns)."""
    out = {}
    for k in examples[0]:
        v = np.stack([e[k] for e in examples])
        if k == "dino_pooled":
            k, v = "fg_feats", out["fg_score"] * v[:, None, None, :]
        out[k] = v
    return out


class BlobDataLoader:
    """Epochs over (image, mask, prompt embedding) triples: each example
    encoded once and held compact (``encode_example``), each epoch in the
    order of a seeded ``np.random.RandomState`` permutation, the last
    incomplete batch dropped.

    rows: the rows of each batch this loader yields (a data-parallel
    rank's, ``multihost.local_rows``); every row by default. Every rank
    then holds and encodes the whole data set, which costs start-up
    seconds, not step seconds."""

    def __init__(self, pipeline, images: List[np.ndarray],
                 masks: List[np.ndarray], prompt_embeds: List[np.ndarray],
                 batch_size: int, size: int = 512, seed: int = 0,
                 rows: Optional[range] = None):
        if not len(images) == len(masks) == len(prompt_embeds):
            raise ValueError(f"{len(images)} images, {len(masks)} masks, "
                             f"{len(prompt_embeds)} prompt embeddings")
        if len(images) < batch_size:
            raise ValueError(
                f"dataset has {len(images)} examples but batch_size is "
                f"{batch_size}; the loader would yield zero batches")
        self.examples = [encode_example(pipeline, im, mk, pe, size)
                         for im, mk, pe in zip(images, masks, prompt_embeds)]
        self.batch_size = batch_size
        self.rows = range(batch_size) if rows is None else rows
        self.rng = np.random.RandomState(seed)

    def index_batches(self):
        """Each batch's example indices, this loader's rows of them: one
        permutation an epoch, as the JAX loader draws it."""
        order = self.rng.permutation(len(self.examples))
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield order[i:i + self.batch_size][self.rows.start:self.rows.stop]

    def __iter__(self):
        for idx in self.index_batches():
            yield collate([self.examples[j] for j in idx])
