"""Inference CLI of the PyTorch port (counterpart of
``blobctrl_tpu/apps/cli.py``): loads the checkpoint layout, builds the blob
score from an ellipse list, runs the pipeline, saves the results (optionally
with the ellipse drawn). Input images are PNG or JPEG, read by the port's
own decoders (``utils/image.py``); outputs are PNG.

Usage:
  python -m blobctrl_torch.apps.cli \\
      --models_root ./models \\
      --original_image scene.png --scene_prompt "a photo of ..." \\
      --object_image object_centered.png --edited_background bg.png \\
      --ellipse "300,260,120,220,35" [--remove] [--device cpu] ...
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from blobctrl_torch.pipeline.blobnet_pipeline import SCHEDULER_NAMES
from blobctrl_torch.utils import png
from blobctrl_torch.utils.image import read_image


def parse_ellipse(spec: str):
    """'xc,yc,d1,d2,angle' -> cv2-style ellipse ((xc, yc), (d1, d2), angle)
    (a parser, never ``eval`` of user text)."""
    parts = [float(x) for x in spec.replace("(", " ").replace(")", " ")
             .replace(";", ",").split(",") if x.strip()]
    if len(parts) != 5:
        raise argparse.ArgumentTypeError(
            f"ellipse must be 'xc,yc,d1,d2,angle_deg', got {spec!r}")
    return ((parts[0], parts[1]), (parts[2], parts[3]), parts[4])


def to_luma(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8, PIL's ``convert("L")`` (ITU-R
    601-2 luma in its 16-bit fixed point). A gray image decoded to RGB
    (equal channels) comes back unchanged."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="BlobCtrl element-level image editing (PyTorch port)")
    p.add_argument("--models_root", default="models",
                   help="checkpoint root (the reference's download layout)")
    p.add_argument("--original_image", required=False,
                   help="original scene image (for --remove background build)")
    p.add_argument("--object_image", required=True,
                   help="object on white 512x512 canvas (fg_image)")
    p.add_argument("--edited_background", required=False,
                   help="background with edit region masked (bg_image)")
    p.add_argument("--ellipse_mask", required=False,
                   help="mask image of the start ellipse (for --remove)")
    p.add_argument("--scene_prompt", required=True)
    p.add_argument("--negative_prompt", default=None)
    p.add_argument("--ellipse", type=parse_ellipse, action="append",
                   required=True,
                   help="'xc,yc,d1,d2,angle'; repeat for multi-round edits "
                        "(the last one is used, like the reference)")
    p.add_argument("--remove", action="store_true", help="remove-blob mode")
    p.add_argument("--blobnet_control_strength", type=float, default=1.2)
    p.add_argument("--blobnet_control_guidance_start", type=float, default=0.0)
    p.add_argument("--blobnet_control_guidance_end", type=float, default=0.9)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--seed", type=int, default=1248464818)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--scheduler", choices=SCHEDULER_NAMES, default="unipc")
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--plot_ellipse", action="store_true",
                   help="additionally save outputs with the ellipse drawn")
    p.add_argument("--mesh", default=None, metavar="data=N,model=M",
                   help="not available in the port yet (ROADMAP item 17)")
    p.add_argument("--hybrid_cfg_data", action="store_true",
                   help="not available in the port yet (ROADMAP item 17)")
    return p


def run(args) -> list:
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.blob import raster
    from blobctrl_torch.params import io as params_io

    if getattr(args, "mesh", None) or getattr(args, "hybrid_cfg_data", False):
        raise SystemExit("--mesh and --hybrid_cfg_data need the parallel "
                         "recipes, which the port does not have yet "
                         "(ROADMAP item 17)")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    pipe = params_io.load_pipeline(args.models_root, dtype=dtype,
                                   device=args.device)

    fg_image = read_image(args.object_image)
    height, width = fg_image.shape[:2]
    lh, lw = height // 8, width // 8

    if not args.remove:
        assert args.edited_background, \
            "--edited_background required unless --remove"
        bg_image = read_image(args.edited_background)
        final_ellipse = args.ellipse[-1]
        gs_score = blob_math.blob_score_from_ellipse(final_ellipse, width,
                                                     height, (lh, lw))
        strength = args.blobnet_control_strength
    else:
        assert args.original_image and args.ellipse_mask, \
            "--remove needs --original_image and --ellipse_mask"
        orig = read_image(args.original_image)
        mask = to_luma(read_image(args.ellipse_mask)) > 0
        bg_image = np.where(mask[..., None], 255, orig).astype(np.uint8)
        final_ellipse = args.ellipse[0]
        gs_score = blob_math.removal_score((lh, lw))
        strength = 0.0  # the reference forces strength 0 in remove mode

    t0 = time.perf_counter()
    out = pipe(prompt=[args.scene_prompt] * args.num_samples,
               negative_prompt=args.negative_prompt,
               fg_image=fg_image, bg_image=bg_image,
               gs_score=gs_score.numpy(), height=height, width=width,
               num_inference_steps=args.num_inference_steps,
               guidance_scale=args.guidance_scale,
               seed=args.seed,
               blobnet_conditioning_scale=strength,
               blobnet_control_guidance_start=args.blobnet_control_guidance_start,
               blobnet_control_guidance_end=args.blobnet_control_guidance_end,
               scheduler=args.scheduler)
    dt = time.perf_counter() - t0

    os.makedirs(args.output_dir, exist_ok=True)
    paths = []

    def save(arr, name):
        path = os.path.join(args.output_dir, name)
        with open(path, "wb") as f:
            f.write(png.encode_png(arr))
        paths.append(path)

    for i, img in enumerate(out.images):
        arr = (img * 255).astype(np.uint8)
        save(arr, f"edit_{i}.png")
        if args.plot_ellipse:
            box = (tuple(map(int, final_ellipse[0])),
                   tuple(map(int, final_ellipse[1])), final_ellipse[2])
            save(raster.ellipse(arr.copy(), box, (0, 255, 0), 3),
                 f"edit_{i}_ellipse.png")
    print(json.dumps({"outputs": paths, "seconds": round(dt, 3)}))
    return paths


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
