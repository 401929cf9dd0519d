"""Training entry point of the PyTorch port: BlobNet + UNet-LoRA
self-supervised fine-tuning on one device (counterpart of
``blobctrl_tpu/apps/train_cli.py``), bf16 compute over fp32 masters.

Data layout: --data_root with
  images/NAME.png   RGB images, PNG or JPEG (resized and cropped to --size)
  masks/NAME.png    binary object masks (the same file name)
  prompts.json      {"NAME": "a photo of ..."} (optional; "" if absent)

Usage:
  python -m blobctrl_torch.apps.train_cli --models_root models \\
      --data_root data --batch_size 8 --steps 1000 --ckpt_dir ckpts \\
      [--device cpu]

Multi-process and multi-device training (--coordinator, --num_processes,
--process_id, --data_parallel > 1) needs data-parallel training, which the
port does not have yet (ROADMAP item 17b): those flags are refused.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from blobctrl_torch.apps.cli import to_luma
from blobctrl_torch.utils import resample
from blobctrl_torch.utils.image import read_image
from blobctrl_torch.utils.observability import log_event


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BlobCtrl training (PyTorch port)")
    p.add_argument("--models_root", default="models")
    p.add_argument("--data_root", required=True)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--lora_rank", type=int, default=16)
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA shadow of the trainables (0 = off; typical "
                        "0.999); exports use the EMA weights when enabled")
    p.add_argument("--lr_warmup_steps", type=int, default=0,
                   help="linear LR warmup from 0 over this many steps")
    p.add_argument("--lr_schedule", choices=("constant", "cosine"),
                   default="constant",
                   help="constant (after warmup) or warmup->cosine decay "
                        "over --steps")
    p.add_argument("--full_finetune", action="store_true",
                   help="train the full base UNet instead of a LoRA adapter "
                        "(TrainConfig.train_unet_full)")
    p.add_argument("--ckpt_dir", default="ckpts")
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="one device only (0 or 1); more is ROADMAP item 17b")
    p.add_argument("--coordinator", default=None,
                   help="not available in the port yet (ROADMAP item 17b)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="not available in the port yet (ROADMAP item 17b)")
    p.add_argument("--process_id", type=int, default=None,
                   help="not available in the port yet (ROADMAP item 17b)")
    p.add_argument("--export_dir", default=None,
                   help="export trained blobnet/lora in reference formats")
    return p


def load_dataset(data_root: str, size: int):
    """-> (images (size, size, 3) uint8, masks {0, 255} uint8, prompts) of
    every image with a mask of the same file name, in name order. Images
    go through ``initialize_image``; masks are made luma (PIL's
    ``convert("L")``) and resized bicubic (PIL's default), then
    thresholded at 127."""
    from blobctrl_torch.apps.session import initialize_image
    img_dir = os.path.join(data_root, "images")
    mask_dir = os.path.join(data_root, "masks")
    prompts_path = os.path.join(data_root, "prompts.json")
    prompts = {}
    if os.path.exists(prompts_path):
        with open(prompts_path) as f:
            prompts = json.load(f)
    images, masks, names = [], [], []
    for name in sorted(os.listdir(img_dir)):
        mpath = os.path.join(mask_dir, name)
        if not os.path.exists(mpath):
            continue
        images.append(initialize_image(
            read_image(os.path.join(img_dir, name)), size))
        mask = resample.pil_resize(to_luma(read_image(mpath)), (size, size),
                                   "bicubic")
        masks.append((mask > 127).astype(np.uint8) * 255)
        names.append(os.path.splitext(name)[0])
    return images, masks, [prompts.get(n, "") for n in names]


def run(args):
    """Train as ``args`` say. -> the final train state."""
    from blobctrl_torch.models import lora as lora_lib
    from blobctrl_torch.params import io as params_io
    from blobctrl_torch.train import checkpoint as ckpt_lib
    from blobctrl_torch.train import data as data_lib
    from blobctrl_torch.train import train_step as ts

    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None or args.data_parallel > 1):
        raise SystemExit("--coordinator, --num_processes, --process_id and "
                         "--data_parallel > 1 need data-parallel training, "
                         "which the port does not have yet (ROADMAP item "
                         "17b)")
    pipe = params_io.load_pipeline(args.models_root, dtype=torch.bfloat16,
                                   device=args.device)
    dev = pipe.device
    images, masks, prompt_texts = load_dataset(args.data_root, args.size)
    log_event("dataset_loaded", examples=len(images))
    with torch.no_grad():
        pes = [pipe.encode_prompt(t, None, 1, do_cfg=False)[0].float()
               .cpu().numpy() for t in prompt_texts]
    loader = data_lib.BlobDataLoader(pipe, images, masks, pes,
                                     batch_size=args.batch_size,
                                     size=args.size)

    cfg = ts.TrainConfig(learning_rate=args.learning_rate,
                         train_unet_full=args.full_finetune,
                         ema_decay=args.ema_decay,
                         lr_warmup_steps=args.lr_warmup_steps,
                         lr_schedule=args.lr_schedule,
                         lr_total_steps=args.steps)
    if args.resume and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        state = ckpt_lib.restore(args.ckpt_dir, device=dev)
        log_event("resumed", step=state["step"])
    else:
        # fp32 masters: bf16 ones would round away ~1e-5 AdamW updates
        adapter = (pipe.unet_params if args.full_finetune else
                   lora_lib.init_lora(torch.Generator().manual_seed(0),
                                      pipe.unet_params, rank=args.lora_rank,
                                      device=dev))
        state = ts.init_train_state(cfg, pipe.blobnet_params, adapter)
    step_fn = ts.make_train_step(cfg, pipe.unet_cfg, pipe.blobnet_cfg)

    step = state["step"]
    t0 = time.perf_counter()
    while step < args.steps:
        for batch in loader:
            if step >= args.steps:
                break
            t, noise = ts.draw_t_noise(
                torch.Generator().manual_seed(step), args.batch_size,
                batch["x0_latents"].shape[1:], cfg.num_train_timesteps, dev)
            state, metrics = step_fn(state, pipe.unet_params, batch, t,
                                     noise)
            step += 1
            if step % args.log_every == 0:
                loss = float(metrics["loss"])  # waits for the step
                dt = (time.perf_counter() - t0) / args.log_every
                t0 = time.perf_counter()
                log_event("train", step=step, loss=round(loss, 5),
                          grad_norm=round(float(metrics["grad_norm"]), 4),
                          sec_per_step=round(dt, 3),
                          img_per_sec=round(args.batch_size / dt, 2))
            if step % args.ckpt_every == 0 or step == args.steps:
                ckpt_lib.save(args.ckpt_dir, state)
                log_event("checkpoint", step=step)

    if args.export_dir:
        # with EMA on, the shadow weights are what ships
        params = state.get("ema", state["params"])
        ckpt_lib.export_blobnet_safetensors(
            params["blobnet"], os.path.join(
                args.export_dir, "blobnet",
                "diffusion_pytorch_model.safetensors"))
        if args.full_finetune:
            ckpt_lib.export_blobnet_safetensors(
                params["unet"], os.path.join(
                    args.export_dir, "unet",
                    "diffusion_pytorch_model.safetensors"))
        else:
            ckpt_lib.export_lora_safetensors(
                params["lora"], os.path.join(args.export_dir, "unet_lora",
                                             "adapter_model.safetensors"))
        log_event("exported", dir=args.export_dir)
    return state


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
