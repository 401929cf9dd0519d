"""Training entry point of the PyTorch port: BlobNet + UNet-LoRA
self-supervised fine-tuning (counterpart of
``blobctrl_tpu/apps/train_cli.py``), bf16 compute over fp32 masters, on
one device or data-parallel over several.

Data layout: --data_root with
  images/NAME.png   RGB images, PNG or JPEG (resized and cropped to --size)
  masks/NAME.png    binary object masks (the same file name)
  prompts.json      {"NAME": "a photo of ..."} (optional; "" if absent)

Usage:
  python -m blobctrl_torch.apps.train_cli --models_root models \\
      --data_root data --batch_size 8 --steps 1000 --ckpt_dir ckpts \\
      [--device cpu] [--data_parallel N]

Data-parallel training: ``--data_parallel N`` (0, the default: every
visible card; 1 on the CPU) runs N ranks from this process, which is rank
0 and spawns the others: one card a rank over NCCL, or gloo with
``--device cpu``. This is JAX's one process over N devices: --batch_size
is the global batch B, which N must divide, every rank runs the same
loader (seed 0) over the whole data set and trains rows
``multihost.local_rows(B, N, r)`` of each batch, the rows JAX's
``P("data")`` puts on device r. Every rank encodes every example at
start-up (start-up seconds, not step seconds), held compact.
On several hosts run the same command on every host with
``--coordinator host:port --num_processes H --process_id h``, as in JAX's
multi-process form: a process is one host, which runs N =
--data_parallel / H ranks (0: every visible card of the host; 1 on the
CPU), local rank r on ``cuda:r`` over NCCL (gloo with ``--device cpu``).
The process is local rank 0, global rank h*N, and spawns the others; all
H*N ranks meet at the coordinator. --batch_size B is then per host: every
rank of host h runs the loader (seed 0) over the host's stride of the
data set (``images[h::H]``) and trains rows ``local_rows(B, N, r)`` of
its batch, which are rows ``multihost.host_rows(B, N, r, h)`` =
h*B + local_rows(B, N, r) of the global batch of H*B, where JAX's
``host_local_batch`` puts them. ``--device cuda:K`` is one rank a host,
on card K (as several processes on one host each name their card), in
either form.
In both forms t and noise are JAX's draws for the global batch, from
``PRNGKey(step)`` (``train_step.draw_t_noise``; the LoRA from
``PRNGKey(0)``), each rank drawing only its rows, and the gradients are
averaged over the ranks before the clip. Rank 0 narrates
(``img_per_sec`` over the global batch), writes the checkpoints (then
every rank meets at a barrier), reads them on --resume (then broadcasts
the state) and exports.

Checkpoints are the JAX package's (``train/checkpoint.py``: orbax's
layout), so ``--resume`` continues a run the JAX CLI saved, at any step,
and the JAX CLI resumes the port's. A resumed state that does not fit
the flags (--full_finetune, --ema_decay, --lora_rank, --lr_schedule and
--lr_warmup_steps) or the models root's BlobNet is refused by name
before any step.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from blobctrl_torch import resolve_device
from blobctrl_torch.apps.cli import to_luma
from blobctrl_torch.parallel import multihost
from blobctrl_torch.utils import resample, threefry
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
                   help="data-parallel ranks over every host (0 = every "
                        "visible card of every host; 1 a host on the CPU); "
                        "each host's process spawns its other ranks")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 for explicit multi-host "
                        "bring-up (run the same command on every host, "
                        "with --num_processes hosts and this host's "
                        "--process_id); omit for one host")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
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


def ranks(args):
    """-> (world, backend, spawn): the data-parallel ranks the flags ask
    for over every host, the backend of their group (None for one rank)
    and whether this process spawns its host's other ranks itself. With
    --coordinator a process is one host of --num_processes, as in JAX,
    and runs --data_parallel / --num_processes ranks (0: every visible
    card; 1 on the CPU); without it, the one host. A card named by index
    (``cuda:K``) is one rank a host, on that card. Inconsistent flags,
    and more ranks a host than visible cards, raise SystemExit before
    anything loads."""
    explicit = (args.coordinator, args.num_processes, args.process_id)
    cuda = torch.device(args.device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    dp = args.data_parallel
    if dp < 0:
        raise SystemExit(f"--data_parallel {dp} < 0")
    hosts = 1
    if any(x is not None for x in explicit):
        if any(x is None for x in explicit):
            raise SystemExit("--coordinator, --num_processes and "
                             "--process_id go together")
        hosts, i = args.num_processes, args.process_id
        if hosts < 1 or not 0 <= i < hosts:
            raise SystemExit(f"--process_id {i} is not a rank of "
                             f"--num_processes {hosts}")
        if dp % hosts:
            raise SystemExit(f"--data_parallel {dp} with --num_processes "
                             f"{hosts}: every host runs as many ranks, so "
                             f"the data axis is a multiple of {hosts} (or "
                             f"0: every card of every host)")
    if cuda and torch.device(args.device).index is not None:
        # one named card trains alone: a host's ranks go on cuda:0..N-1
        if dp > hosts:
            raise SystemExit(f"--data_parallel {dp} puts rank r of a host "
                             f"on cuda:r: name --device cuda, not "
                             f"{args.device}")
        return hosts, backend if hosts > 1 else None, False
    cards = torch.cuda.device_count() if cuda else 1
    local = dp // hosts or max(cards, 1)
    if local > 1 and cuda and local > cards:
        over = "" if hosts == 1 else f" over {hosts} hosts"
        raise SystemExit(f"--data_parallel {dp}{over} needs {local} cards, "
                         f"one a rank; {cards} are visible (--device cpu "
                         f"runs the ranks over gloo)")
    world = hosts * local
    return world, backend if world > 1 else None, local > 1


def run(args):
    """Train as ``args`` say. -> the final train state (this process's
    rank's)."""
    world, backend, spawn = ranks(args)
    per_host = args.coordinator is not None
    local = world // (args.num_processes if per_host else 1)
    first = (args.process_id or 0) * local   # this process's rank
    if not spawn:
        return run_rank(args, first, world, args.coordinator, backend,
                        args.device, per_process=per_host)
    # every host's ranks meet at the coordinator; one host alone makes
    # its own address
    address = args.coordinator or f"127.0.0.1:{multihost.free_port()}"
    followers = multihost.Followers(_follower, world, address,
                                    (args, backend),
                                    ranks=range(first + 1, first + local))
    err = None
    try:
        state = run_rank(args, first, world, address, backend, args.device,
                         per_process=per_host)
    except (Exception, SystemExit) as e:  # reported with the ranks' codes
        err = e
    finally:
        codes = followers.close()
    if err is not None or any(c != 0 for c in codes):
        raise SystemExit(f"data-parallel training failed: rank {first}: "
                         f"{'ok' if err is None else err}; ranks "
                         f"{first + 1}-{first + local - 1}: exit codes "
                         f"{codes}") from err
    return state


def _follower(rank, world, address, conn, args, backend):
    """A host's ranks after its first (the pipe stays unread)."""
    run_rank(args, rank, world, address, backend, args.device,
             per_process=args.coordinator is not None)


def check_data(examples: int, batch: int, local: int, hosts: int = 1,
               per_host: bool = False):
    """SystemExit where the data set cannot feed a batch to the ``local``
    ranks of each of ``hosts`` hosts: a batch that a host's ranks do not
    divide; without ``per_host`` (one host, --batch_size the global batch)
    a batch larger than the data set; with it (the --coordinator form,
    where each host reads its stride of the data set) a stride shorter
    than a host's batch."""
    if per_host:
        if examples // hosts < batch:
            raise SystemExit(f"{examples} examples over {hosts} hosts "
                             f"leave {examples // hosts} a host, fewer "
                             f"than --batch_size {batch}")
        if batch % local:
            raise SystemExit(f"--batch_size {batch} is each host's batch: "
                             f"its {local} ranks do not divide it")
        return
    if batch % local:
        raise SystemExit(f"--batch_size {batch} is the global batch: "
                         f"{local} ranks do not divide it")
    if examples < batch:   # the loader's own message
        raise SystemExit(f"dataset has {examples} examples but batch_size "
                         f"is {batch}; the loader would yield zero batches")


def _same_geometry(tree, like, path: str):
    """ValueError naming the first path where ``tree`` differs from
    ``like`` (a fresh tree, whose leaves are tensors or shapes) in its
    keys or shapes."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            have = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path} holds {have}, the run builds "
                             f"{sorted(like)}")
        for k, v in like.items():
            _same_geometry(tree[k], v, f"{path}.{k}")
        return
    if isinstance(like, list):
        if not isinstance(tree, list) or len(tree) != len(like):
            raise ValueError(f"{path} is not the run's list of {len(like)}")
        for i, (t, v) in enumerate(zip(tree, like)):
            _same_geometry(t, v, f"{path}.{i}")
        return
    shape = tuple(like.shape) if torch.is_tensor(like) else tuple(like)
    if not torch.is_tensor(tree) or tuple(tree.shape) != shape:
        got = tuple(tree.shape) if torch.is_tensor(tree) else type(tree)
        raise ValueError(f"{path} has shape {got}, the run builds {shape}")


def check_resumed(state, schedule, args, cfg, pipe):
    """Check a resumed train state, and ``schedule`` (whether its saved
    optimizer state holds a learning-rate schedule's count,
    ``checkpoint.saved_schedule``; None: not recorded), against the run's
    flags, TrainConfig and models root: ValueError naming the flag
    (--full_finetune, --ema_decay, --lora_rank, --lr_schedule and
    --lr_warmup_steps) or the BlobNet leaf that does not fit, before any
    step."""
    from blobctrl_torch.models import lora as lora_lib
    from blobctrl_torch.train import checkpoint as ckpt_lib
    params = state["params"]
    kind = "unet" if "unet" in params else "lora"
    if args.full_finetune != (kind == "unet"):
        trains = "the full UNet" if kind == "unet" else "a LoRA adapter"
        raise ValueError(f"the checkpoint trains {trains}; --full_finetune "
                         f"is {'on' if args.full_finetune else 'off'}")
    if (args.ema_decay > 0) != ("ema" in state):
        raise ValueError(
            f"the checkpoint {'holds' if 'ema' in state else 'has no'} an "
            f"EMA shadow; --ema_decay is {args.ema_decay}")
    if schedule is not None and schedule != ckpt_lib.has_schedule(cfg):
        raise ValueError(
            f"the checkpoint's optimizer state "
            f"{'holds' if schedule else 'has no'} a learning-rate "
            f"schedule's count; --lr_schedule {args.lr_schedule} "
            f"--lr_warmup_steps {args.lr_warmup_steps} make "
            f"{'a constant rate' if schedule else 'a schedule'}")
    if kind == "lora":
        like = {}
        for p, leaf in lora_lib._attention_paths(pipe.unet_params):
            d_in, d_out = leaf["kernel"].shape
            like["/".join(map(str, p))] = {
                "A": (d_in, args.lora_rank), "B": (args.lora_rank, d_out)}
        ranks = {tuple(ab["A"].shape)[-1] for ab in params["lora"].values()}
        if ranks != {args.lora_rank}:
            raise ValueError(f"the checkpoint's adapter has rank "
                             f"{sorted(ranks)}; --lora_rank is "
                             f"{args.lora_rank}")
    else:
        like = pipe.unet_params
    like = {"blobnet": pipe.blobnet_params, kind: like}
    trees = [("params", params), ("opt_state.mu", state["opt_state"]["mu"]),
             ("opt_state.nu", state["opt_state"]["nu"])]
    if "ema" in state:
        trees.append(("ema", state["ema"]))
    try:
        for path, tree in trees:
            _same_geometry(tree, like, path)
    except ValueError as e:
        raise ValueError(f"the checkpoint does not fit the models root's "
                         f"BlobNet and UNet ({e})") from None


def run_rank(args, rank: int, world: int, address, backend, device,
             per_process: bool = False):
    """Rank ``rank`` of ``world`` data-parallel ranks, the whole run when
    world is 1 (no group). per_process: the --coordinator form, where
    each of the --num_processes hosts runs N = world / --num_processes
    ranks (rank ``rank`` is local rank ``rank % N`` of host
    ``rank // N``), reads its stride of the data set and loads
    --batch_size rows a step; otherwise one host, whose --batch_size is
    the global batch. Either way the rank trains its rows of its host's
    batch. -> the final train state."""
    hosts = args.num_processes if per_process else 1
    local = world // hosts
    host, index = divmod(rank, local)
    if backend == "nccl":
        device = multihost.nccl_card(device, index)   # a card of its host
    resolve_device(device)   # no CUDA: refused before the data is read
    images, masks, prompt_texts = load_dataset(args.data_root, args.size)
    # every rank refuses alike, before the group: a rank that cannot fill
    # its rows would leave the others waiting in a collective
    check_data(len(images), args.batch_size, local, hosts, per_process)
    if per_process:
        images, masks, prompt_texts = (x[host::hosts] for x in (
            images, masks, prompt_texts))
    # its rows of the host's batch, and where JAX's global batch (the
    # hosts' batches in order) holds them
    rows = (multihost.local_rows(args.batch_size, local, index),
            multihost.host_rows(args.batch_size, local, index, host))
    if world == 1:
        return _train(args, 0, 1, device, images, masks, prompt_texts,
                      hosts, rows)
    device = multihost.initialize(address, world, rank, device=device,
                                  backend=backend)
    try:
        log_event("multihost", process=rank, processes=world,
                  local_examples=len(images))
        return _train(args, rank, world, device, images, masks,
                      prompt_texts, hosts, rows)
    finally:
        multihost.shutdown()


def _train(args, rank, world, device, images, masks, prompt_texts, hosts,
           rows):
    """The training of one rank of ``hosts`` hosts on its examples:
    ``rows`` are its rows of its host's batch and the same rows in the
    global batch; rank 0 narrates, writes and exports."""
    from blobctrl_torch.models import lora as lora_lib
    from blobctrl_torch.params import io as params_io
    from blobctrl_torch.train import checkpoint as ckpt_lib
    from blobctrl_torch.train import data as data_lib
    from blobctrl_torch.train import train_step as ts

    lead = rank == 0
    global_batch = args.batch_size * hosts
    pipe = params_io.load_pipeline(args.models_root, dtype=torch.bfloat16,
                                   device=device)
    dev = pipe.device
    log_event("dataset_loaded", examples=len(images))
    with torch.no_grad():
        pes = [pipe.encode_prompt(t, None, 1, do_cfg=False)[0].float()
               .cpu().numpy() for t in prompt_texts]
    loader = data_lib.BlobDataLoader(
        pipe, images, masks, pes, batch_size=args.batch_size,
        size=args.size, rows=rows[0])

    cfg = ts.TrainConfig(learning_rate=args.learning_rate,
                         train_unet_full=args.full_finetune,
                         ema_decay=args.ema_decay,
                         lr_warmup_steps=args.lr_warmup_steps,
                         lr_schedule=args.lr_schedule,
                         lr_total_steps=args.steps)
    # only rank 0's disk is sure to hold what rank 0 wrote: it reads the
    # checkpoint, the other ranks make a fresh state to receive it, and
    # every rank starts from rank 0's
    problem = None
    at = ckpt_lib.latest_step(args.ckpt_dir) if lead and args.resume \
        else None
    if at is not None:
        state = ckpt_lib.restore(args.ckpt_dir, at, device=dev)
        try:
            check_resumed(state, ckpt_lib.saved_schedule(args.ckpt_dir, at),
                          args, cfg, pipe)
        except ValueError as e:
            problem = f"--resume {args.ckpt_dir}: {e}"
            if world == 1:
                raise SystemExit(problem) from None
        log_event("resumed", step=state["step"])
    else:
        # fp32 masters: bf16 ones would round away ~1e-5 AdamW updates
        adapter = (pipe.unet_params if args.full_finetune else
                   lora_lib.init_lora(threefry.key(0), pipe.unet_params,
                                      rank=args.lora_rank, device=dev))
        state = ts.init_train_state(cfg, pipe.blobnet_params, adapter)
        del adapter
    try:
        # rank 0's verdict travels with the layouts: every rank refuses a
        # state that misfits the flags here
        state = ts.replicate_state(state, refused=problem is not None)
    except ValueError as e:
        if problem:
            raise SystemExit(problem) from e
        raise
    step_fn = ts.make_train_step(cfg, pipe.unet_cfg, pipe.blobnet_cfg,
                                 group=multihost.world_group()
                                 if world > 1 else None)

    step = state["step"]
    t0 = time.perf_counter()
    while step < args.steps:
        for batch in loader:
            if step >= args.steps:
                break
            t, noise = ts.draw_t_noise(
                threefry.key(step), global_batch,
                batch["x0_latents"].shape[1:], cfg.num_train_timesteps, dev,
                rows=rows[1])
            state, metrics = step_fn(state, pipe.unet_params, batch, t,
                                     noise)
            step += 1
            if step % args.log_every == 0 and lead:
                loss = float(metrics["loss"])  # waits for the step
                dt = (time.perf_counter() - t0) / args.log_every
                t0 = time.perf_counter()
                log_event("train", step=step, loss=round(loss, 5),
                          grad_norm=round(float(metrics["grad_norm"]), 4),
                          sec_per_step=round(dt, 3),
                          img_per_sec=round(global_batch / dt, 2))
            if step % args.ckpt_every == 0 or step == args.steps:
                if lead:
                    ckpt_lib.save(args.ckpt_dir, state, cfg,
                                  devices=world if hosts > 1 else None)
                    log_event("checkpoint", step=step)
                multihost.barrier(f"checkpoint {step}")

    if args.export_dir and lead:
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
