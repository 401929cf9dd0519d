"""Drive the PyTorch port (``blobctrl_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases, in order; any failure raises and the
script exits non-zero:

  1. Environment: the card's name and power limit, versions, and the build
     of every CUDA kernel from ``blobctrl_torch/csrc`` (nvcc, in parallel).
  2. Kernels against their plain versions on the card, at every shape a
     512^2 edit launches (recorded through the wrappers by a one-step
     full-width edit), in bf16 and fp32, flash attention in both softmax
     modes. bf16 within 2e-2 of max |plain|, fp32 (TF32 off) within 1e-4.
     Times (CUDA events, median of 10 after warm-up): the kernel, its plain
     version, and one PyTorch library call computing the same function.
  3. The trained 256^2 toy checkpoint: a move and a remove edit (20 steps,
     fp32) on the card with the kernels and on the CPU with the plain
     route; PSNR of card against CPU >= 40 dB; both kernels launched.
  4. Full width: SD-1.5 UNet (5-ch) + BlobNet (1029-ch) + VAE, random
     weights drawn on the card, bf16; three STEPS-step requests through
     ``BlobNetPipeline.__call__`` (the standard edit, a second edit with
     another ellipse and seed, a remove-mode edit). Launch counters are
     zeroed just before and read just after.
  5. One JSON line of per-kernel numbers, then ``{"ok": true, ...}`` last.

Per-kernel numbers in the JSON line: ``launches`` are phase 4's; ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are the time of all of phase
4's launches, from the per-shape medians of phase 2 weighted by phase 4's
per-shape launch counts. ``bound_ms`` is the larger of bytes (each input
read once, each output written once) over 3.35 TB/s and the products'
operations over the bf16 tensor-core peak of 989 TFLOP/s (H100 SXM data
sheet).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
STEPS = 50  # UniPC steps of each full-width request


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def rel_err(got, ref):
    diff = (got.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_case(key, dtype, gen):
    """key: (bh, sq, skv, d, dtype-name, fixed) as the wrapper logs it."""
    from blobctrl_torch.ops import flash_attention as fa
    bh, sq, skv, d, _, _ = key
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype)
               for s in (sq, skv, skv))
    scale = d ** -0.5
    itemsize = torch.tensor([], dtype=dtype).element_size()
    flops = 4.0 * bh * sq * skv * d
    nbytes = (2 * bh * sq * d + 2 * bh * skv * d) * itemsize
    return dict(
        kernel=lambda fixed=20.0: fa.flash_attention(q, k, v, scale, fixed),
        plain=lambda: fa.flash_attention_reference(q, k, v, scale),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=scale),
        flops=flops, nbytes=nbytes)


def conv_case(key, dtype, gen):
    """key: (b, h, w, c, co, dtype-name, prologue) as the wrapper logs it."""
    from blobctrl_torch.ops import conv3x3 as cv
    b, h, w, c, co, _, prologue = key

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * s
    x = rnd(b, h, w, c).to(dtype)
    k = rnd(3, 3, c, co, s=(9 * c) ** -0.5).to(dtype)
    bias = rnd(co)
    pro = (1.0 + 0.3 * rnd(b, c), rnd(b, c)) if prologue else (None, None)
    xn = x.permute(0, 3, 1, 2)
    wn = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bias_d = bias.to(dtype)
    itemsize = x.element_size()
    nbytes = ((b * h * w * c + 9 * c * co + b * h * w * co) * itemsize
              + 4 * co + (8 * b * c if prologue else 0))
    return dict(
        kernel=lambda fixed=None: cv.conv3x3(x, k, bias, *pro),
        plain=lambda: cv.conv3x3_reference(x, k, bias, *pro),
        # cuDNN's conv, without the prologue: no one library call fuses it
        library=lambda: torch.nn.functional.conv2d(xn, wn, bias_d, padding=1),
        flops=2.0 * b * h * w * co * 9 * c, nbytes=nbytes)


def shape_label(name, key) -> str:
    if name == "flash_attention":
        bh, sq, skv, d = key[:4]
        return f"flash_attention bh={bh} sq={sq} skv={skv} d={d}"
    b, h, w, c, co = key[:5]
    return (f"conv3x3 b={b} h={h} w={w} c={c} co={co}"
            f"{' +gn-silu' if key[-1] else ''}")


def check_kernels(flash_shapes, conv_shapes):
    """Every recorded shape, in bf16 and fp32 (flash in both modes), kernel
    against plain; bf16 timings. -> per-kernel {shape: numbers}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"flash_attention": {}, "conv3x3": {}}
    for name, shapes, make in (("flash_attention", flash_shapes, flash_case),
                               ("conv3x3", conv_shapes, conv_case)):
        for key in sorted(shapes):
            row = {}
            for dtype in (torch.bfloat16, torch.float32):
                case = make(key, dtype, gen)
                ref = case["plain"]()
                modes = (20.0, None) if name == "flash_attention" else (None,)
                for fixed in modes:
                    got = case["kernel"](fixed)
                    torch.cuda.synchronize()
                    abs_err, rel = rel_err(got, ref)
                    tag = f"{shape_label(name, key)} {str(dtype)[6:]}"
                    if name == "flash_attention":
                        tag += " fixed-max" if fixed else " running-max"
                    ok = rel <= TOL[dtype]
                    log(f"  {tag}: max_abs {abs_err:.3e} rel {rel:.3e} "
                        f"(tol {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{tag}: rel {rel}")
                    row["max_abs_err"] = max(row.get("max_abs_err", 0.0),
                                             abs_err)
                del ref
                if dtype == torch.bfloat16:
                    row["ms"] = time_ms(case["kernel"])
                    row["plain_ms"] = time_ms(case["plain"])
                    row["library_ms"] = time_ms(case["library"])
                    row["flops_ms"] = 1e3 * case["flops"] / PEAK_BF16_FLOPS
                    row["bytes_ms"] = 1e3 * case["nbytes"] / PEAK_BYTES
                    row["bound_ms"] = max(row["flops_ms"], row["bytes_ms"])
                    row["tflops"] = case["flops"] / row["ms"] / 1e9
                    log(f"    bf16 ms {row['ms']:.4f} plain {row['plain_ms']:.4f}"
                        f" library {row['library_ms']:.4f} bound "
                        f"{row['bound_ms']:.4f} ({row['tflops']:.1f} TFLOP/s)")
                del case
            results[name][key] = row
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3: trained toy checkpoint, card against CPU
# ---------------------------------------------------------------------------

def ellipse_mask(ellipse, size: int) -> np.ndarray:
    """Filled ellipse ((xc, yc), (d1, d2), angle_deg), 4x4 supersampled ->
    (size, size) uint8 coverage."""
    (xc, yc), (d1, d2), ang = ellipse
    ss = 4
    c = (np.arange(size * ss) + 0.5) / ss
    x, y = np.meshgrid(c - xc, c - yc)
    t = np.deg2rad(ang)
    u = x * np.cos(t) + y * np.sin(t)
    v = -x * np.sin(t) + y * np.cos(t)
    inside = (u / (d1 / 2)) ** 2 + (v / (d2 / 2)) ** 2 <= 1.0
    cover = inside.reshape(size, ss, size, ss).mean(axis=(1, 3))
    return np.round(cover * 255).astype(np.uint8)


def toy_edits(size: int, steps: int):
    """A move and a remove edit on a synthetic toy scene: a colored ellipse
    on a gradient background, with the toy's class embeddings."""
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.train import toy
    rng = np.random.RandomState(4)
    cls = 0
    emb = toy.class_embeddings()
    t = np.linspace(0.0, 1.0, size)[:, None, None]
    img = (1 - t) * np.array([120.0, 130, 140]) + t * np.array([160.0, 150,
                                                                 120])
    img = np.broadcast_to(img, (size, size, 3)).copy()
    src = ((size * 0.35, size * 0.45), (size * 0.3, size * 0.4), 20.0)
    dst = ((size * 0.65, size * 0.55), (size * 0.3, size * 0.4), 20.0)
    m = ellipse_mask(src, size)[..., None] / 255.0
    img = np.clip((1 - m) * img + m * np.array(toy.COLORS[cls][1]), 0,
                  255).astype(np.uint8)
    fg = np.where(m > 0.5, img, 255).astype(np.uint8)
    bg = np.where(m > 0, 255, img).astype(np.uint8)
    bg_move = np.where(ellipse_mask(dst, size)[..., None] > 0, 0,
                       bg).astype(np.uint8)
    lat = rng.randn(1, size // 8, size // 8, 4).astype(np.float32)
    common = dict(height=size, width=size, num_inference_steps=steps,
                  guidance_scale=4.0, latents=lat)
    move = dict(common, fg_image=fg, bg_image=bg_move,
                gs_score=blob_math.blob_score_from_ellipse(
                    dst, size, size, (size // 8, size // 8)).numpy(),
                prompt_embeds=emb["text"][cls][None],
                negative_prompt_embeds=np.zeros_like(emb["text"][cls])[None],
                fg_dino_feats=emb["appearance"][cls][None])
    lh = size // 8
    remove = dict(common, fg_image=np.full_like(img, 255), bg_image=bg,
                  gs_score=np.stack([np.ones((1, lh, lh)),
                                     np.zeros((1, lh, lh))], -1).astype(
                                         np.float32),
                  prompt_embeds=np.zeros((1, 7, 16), np.float32),
                  negative_prompt_embeds=np.zeros((1, 7, 16), np.float32),
                  fg_dino_feats=np.zeros((1, 16), np.float32))
    return {"move": move, "remove": remove}


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def toy_phase():
    from blobctrl_torch import ops
    from blobctrl_torch.ops import conv3x3, flash_attention
    from blobctrl_torch.train import toy
    ckpt = os.path.join(ROOT, "assets", "toy_ckpt_256")
    card, _ = toy.load_toy(ckpt, device="cuda", dtype=torch.float32)
    cpu, _ = toy.load_toy(ckpt, device="cpu", dtype=torch.float32)
    for name, kw in toy_edits(256, 20).items():
        ops.reset_counts()
        t0 = time.perf_counter()
        got = card(**kw).images
        t_card = time.perf_counter() - t0
        counts = (flash_attention.launches, conv3x3.launches)
        t0 = time.perf_counter()
        want = cpu(**kw).images
        t_cpu = time.perf_counter() - t0
        p = psnr(got, want)
        log(f"  toy 256^2 {name}: card {t_card:.2f} s, cpu {t_cpu:.2f} s, "
            f"PSNR card vs cpu {p:.2f} dB, launches flash {counts[0]} "
            f"conv3x3 {counts[1]}")
        if not (p >= 40.0 and min(counts) > 0 and np.isfinite(got).all()):
            raise AssertionError(f"toy {name}: PSNR {p}, launches {counts}")


# ---------------------------------------------------------------------------
# phase 4: full width
# ---------------------------------------------------------------------------

def full_width_requests(steps: int):
    from blobctrl_torch.utils import benchkit
    size = 512
    move2 = benchkit.standard_edit_kwargs(
        size, steps, seed=1, ellipse=((size * 0.35, size * 0.6),
                                      (size * 0.3, size * 0.45), 75.0))
    remove = benchkit.standard_edit_kwargs(size, steps, seed=2)
    lh = size // 8
    remove.update(blobnet_conditioning_scale=0.0,
                  gs_score=np.stack([np.ones((1, lh, lh)),
                                     np.zeros((1, lh, lh))], -1).astype(
                                         np.float32))
    return [("edit", benchkit.standard_edit_kwargs(size, steps)),
            ("edit2", move2), ("remove", remove)]


def run_request(pipe, kw):
    from blobctrl_torch.ops import conv3x3, flash_attention
    f0, c0 = flash_attention.launches, conv3x3.launches
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe(**kw).images
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if out.shape != (1, 512, 512, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape}")
    return out, secs, (flash_attention.launches - f0,
                       conv3x3.launches - c0), \
        torch.cuda.max_memory_allocated() / 2 ** 30


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from blobctrl_torch import ops
    from blobctrl_torch.ops import _build, conv3x3, flash_attention
    from blobctrl_torch.utils import benchkit

    # -- phase 1 ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}"
        f", cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  kernel build {time.perf_counter() - t0:.2f} s")
    torch.backends.cudnn.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 2 ------------------------------------------------------------
    log("phase 2: kernels against their plain versions at the 512^2 shapes")
    pipe = benchkit.make_flagship_pipe(seed=0, device="cuda",
                                       dtype=torch.bfloat16)
    ops.reset_counts()
    # one step, inside the control window, so BlobNet runs too
    pipe(**dict(benchkit.standard_edit_kwargs(512, 1),
                blobnet_control_guidance_end=1.0))
    torch.cuda.synchronize()
    flash_shapes = set(flash_attention.launch_shapes)
    conv_shapes = set(conv3x3.launch_shapes)
    log(f"  recorded {len(flash_shapes)} flash and {len(conv_shapes)} conv "
        f"shapes from a one-step edit")
    results = check_kernels(flash_shapes, conv_shapes)

    # -- phase 3 ------------------------------------------------------------
    log("phase 3: trained toy checkpoint, card against CPU")
    toy_phase()

    # -- phase 4 ------------------------------------------------------------
    log(f"phase 4: full width, bf16, {STEPS} steps per request")
    requests = full_width_requests(STEPS)
    ops.reset_counts()
    for name, kw in requests:
        _, secs, (nf, nc), mem = run_request(pipe, kw)
        log(f"  {name}: {secs:.3f} s, launches flash {nf} conv3x3 {nc}, "
            f"peak memory {mem:.2f} GiB")
    counts = {"flash_attention": dict(flash_attention.launch_shapes),
              "conv3x3": dict(conv3x3.launch_shapes)}
    for name, per_shape in counts.items():
        for key, n in sorted(per_shape.items()):
            log(f"  launches {shape_label(name, key)}: {n}")
    totals = {"flash_attention": flash_attention.launches,
              "conv3x3": conv3x3.launches}
    if min(totals.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: {totals}")

    # -- phase 5 ------------------------------------------------------------
    meta = {"flash_attention": ("blobctrl_torch/csrc/flash_attention.cu",
                                "blobctrl_tpu/ops/flash_attention.py:80"),
            "conv3x3": ("blobctrl_torch/csrc/conv3x3.cu",
                        "blobctrl_tpu/ops/conv3x3.py:176")}
    kernels = []
    for name, (source, replaces) in meta.items():
        missing = set(counts[name]) - set(results[name])
        if missing:
            raise AssertionError(f"{name}: shapes not checked {missing}")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": totals[name],
                 "max_abs_err": max(r["max_abs_err"]
                                    for r in results[name].values())}
        for field in ("ms", "plain_ms", "bound_ms", "library_ms"):
            entry[field] = sum(results[name][k][field] * n
                               for k, n in counts[name].items())
        entry["bound_by"] = _bound_by(name, results, counts)
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _bound_by(name, results, counts) -> str:
    """Whichever of bytes or operations sets the summed bound."""
    ops_ms = sum(results[name][k]["flops_ms"] * n
                 for k, n in counts[name].items())
    bytes_ms = sum(results[name][k]["bytes_ms"] * n
                   for k, n in counts[name].items())
    return "operations" if ops_ms >= bytes_ms else "bytes"


if __name__ == "__main__":
    sys.exit(main())
