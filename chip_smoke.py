"""Drive the PyTorch port (``blobctrl_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases, in order; any failure raises and the
script exits non-zero:

  1. Environment: the card's name and power limit, versions, and the build
     of every CUDA kernel from ``blobctrl_torch/csrc`` (nvcc, in parallel).
     Then the JPEG decoder on the card's host, which has no PIL: every
     fixture of ``tests/data/jpeg`` (gray, 4:4:4, 4:2:2, 4:2:0,
     progressive, restart intervals, a 512^2 photo-like 4:2:0 file)
     decoded by ``utils/jpeg.decode_jpeg`` bit-equal to PIL's decode
     committed beside it as a PNG; the decode seconds of the 512^2 file
     and of ``assets/jpeg_timing``'s 4032x3024 4:2:0 file (textured,
     quality 90, 2.5 bits a pixel, as a phone photo), with the host CPU's
     model.
  2. Kernels against their plain versions on the card, at every shape a
     512^2 edit launches (recorded through the wrappers by a one-step
     full-width edit, once exact, once in the int8-everything mode and once
     as the fused-kernel edit), in bf16 and fp32, flash attention in both
     softmax modes, int8 flash attention in both k-scale modes, the
     GroupNorm -> projection GEMM in its plain and residual modes. bf16
     within 2e-2 of max |plain|, fp32 (TF32 off) within 1e-4; the int8
     conv without a prologue bit-equal to its plain version in both dtypes
     (its integer sums are exact; with the prologue, the number of outputs
     that differ is logged). The int8 flash kernel's plain-torch pre-pass
     (``int8_operands`` and the row padding) is timed alone and its share
     logged, and, for information only, cuBLASLt's int8 product
     ``torch._int_mm`` at each int8 conv's (M, 9C, Co) where its shape rules
     allow it: a yardstick of the product rate, not a library time of the
     function. The blob
     splat (fp32 only) from the raw blob inputs at (1, 512, 512, M=1) and
     at M = 3, 11 and a 1024^2 grid, within 1e-5 absolute, the rows its
     prologue computes bit-equal to ``splat_params``; its view mode (image
     0 coloured, uint8) at 512^2 and 1024^2 bit-equal to its plain
     version; each by wall time (events around the host call), and by
     device time (``torch.profiler``) after phase 5. Times (CUDA
     events, median of 10 after warm-up), in bf16, of each mode: the
     kernel, its plain version, and one PyTorch library call computing the
     same function where there is one (none computes either int8 function;
     the fused GEMMs and the Winograd conv are set against the library's
     product or conv without their prologue).
  3. The trained 256^2 toy checkpoint: a move and a remove edit (20 steps,
     fp32), exact, in the int8-everything mode and as the fused-kernel
     edit, on the card with the kernels and on the CPU with the plain
     route; PSNR of card against CPU >= 40 dB; the mode's kernels launched,
     every int8 conv launch on the tensor cores (both dtypes run there).
     Then this slice's samplers and options on the exact path, fp32, at
     the same bar: DDIM with eta 0.5 and DPM-Solver++ 2M SDE Karras (their
     variance noise drawn on the CPU generator, so both sides see the same
     numbers) and the encoder cache (interval 3).
     Then the bf16 pass, which runs the bf16 tensor-core kernels on trained
     weights (fp32 keeps the SIMT flash, direct-conv, GEMM and Winograd
     kernels): the move edit, exact, fused and int8, loaded in bf16 on the
     card and on the CPU. Its floor f is PSNR(CPU
     bf16, CPU fp32), what bf16 rounding alone costs, measured in the same
     run; the bar is PSNR(card bf16, CPU fp32) >= f - BF16_MARGIN_DB, so
     the kernels may add little beyond it. PSNR(card bf16, CPU bf16) is
     logged beside it, and every bf16 launch of the mode's kernels must
     have run on its tensor-core kernel.
  4. Full width: SD-1.5 UNet (5-ch) + BlobNet (1029-ch) + VAE, random
     weights drawn on the card, bf16; three exact STEPS-step requests
     through ``BlobNetPipeline.__call__`` (the standard edit, a second edit
     with another ellipse and seed, a remove-mode edit), then the standard
     edit in the int8-everything mode and as the fused-kernel edit (the
     PSNR of each against the exact one is printed for information).
     Launch counters are zeroed just before each of the three paths and
     read just after it; the pipeline's derived weights (int8, Winograd)
     are dropped before each path, so each peak holds only its own. Every
     bf16 launch of the exact and fused paths' kernels (flash, exp2-folded
     flash, conv3x3, the two normalize GEMMs, Winograd: ``ops.
     TENSOR_CORE``), and of the int8 path's int8 flash and int8 conv, must
     have run on its tensor-core kernel, as the C entry point reports it.
     The int8 edit also logs its K-major int8 weight copies and its largest
     int32 split workspace.
  5. The interactive session at full width, bf16: CLIP ViT-L/14 text and
     DINOv2-large added to phase 4's pipeline (random weights drawn on the
     card, a byte-level vocabulary built in code), ``BlobCtrlSession``:
     a seeded 640x480 image (resized), a mask from the port's raster, the
     blob fitted and moved, resized and rotated with the blob view after
     each step (one splat launch per view, and no plain splat or colour
     pass), the view against the same call on the
     CPU (<= 1 uint8 level), then three STEPS-step runs from a text prompt
     and the object image: an edit, another after a move (the prompt and
     DINOv2 memos hit), and a remove. Counters zeroed before, read after;
     every flash and conv3x3 launch on its tensor-core kernel.
     Then the demo's editing flow in a new session with a stand-in
     predictor (the port's raster ellipse around the clicks):
     ``set_image`` from the 512^2 JPEG fixture through ``decode_image``,
     two ``click``s, ``generate_blob``, the tracking points (a first click
     outside the blob, refused with the blob view within one level of the
     CPU's; one inside; two moves; an undo; a move), each overlay's ms
     logged (the overlays are host float64 numpy, no device op: the last
     one equal to a CPU session's is logged as host determinism), and
     one STEPS-step run from the tracked state (counters zeroed before,
     read after: K1 and K6, all on the tensor cores). The move (with its
     tracking points and editable-blob golden) and a remove state are
     saved for the checkpoint day. The stand-in serves that flow only
     because random weights give no ellipse-like mask.
     Then SAM: a seeded random ViT-H (the full geometry, fp32) written as
     phase 6's ``sam/sam_vit_h_4b8939.pth`` in the original
     segment_anything layout (``params/export.save_sam``), loaded with
     ``params.io.load_sam`` (every leaf bit-equal; bytes, seconds, peak
     memory printed) and wrapped in ``models.sam.SamPredictor`` for a
     session: ``set_image`` from the JPEG photo (ViT-H at 1024^2), two
     clicks and their masks, the warm medians of ``set_image`` and
     ``predict``, the full-depth embedding finite and bit-equal across two
     calls, and no hand kernel launched; the card against the CPU at a
     cut depth (8 blocks, the global one at 7, width 1280, 1024^2, TF32
     switched on before the predictor, which must switch it off):
     embedding and mask logits within 1e-4 of max |CPU|. Then the safety
     checker (CLIP ViT-L/14 vision, random, through diffusers' state-dict
     layout and back): 20-step edits without a checker, with one that
     never flags (bit-equal images) and one that always flags under
     ``blackout_nsfw`` (all zeros), the same through ``edit_batch`` at B =
     2 with row 1 flagged; K1 and K6 in each, on the tensor cores; the
     checker's ms and, card against CPU, its pooled embedding and scores
     within 1e-4.
  6. A reference-layout checkpoint at full geometry: the SD-1.5 UNet (at
     4 input channels, so the loader widens it), BlobNet, the VAE, CLIP
     ViT-L/14 text and DINOv2-large drawn on the card in fp16 from a seed,
     with a rank-16 PEFT LoRA over the UNet's attention projections, are
     written as fp16 safetensors with their config.json files, the
     DINOv2 preprocessor config and a tokenizer directory
     (``params/export.write_models_root``, numpy and json only) into a
     temporary directory, then loaded with ``params.io.load_pipeline(root,
     dtype=torch.bfloat16)``: every leaf bit-equal to the drawn one cast to
     bf16, each LoRA target bit-equal to the plain formula (fp32 merge on
     the card, then the cast). Then REQUESTS at 512^2 from a text prompt
     and the object image under the standard edit's kwargs: DPM++ 2M
     Karras, a repeat of it (the conditioning memo hits: no VAE encode,
     the same image), DPM++ 2M SDE Karras twice with one seed (bit-equal),
     DDIM with eta 0.5, UniPC on 20 trailing timesteps, LoRA scale 0.5 and
     back to 1.0 (the UNet's targets back within one bf16 rounding), the
     encoder cache, guidance-interval CFG, and a callback every 10 steps
     with the latents as output. Counters zeroed before
     each request and read after it: flash and conv3x3 launch in each, all
     on the tensor cores, and no other kernel; seconds, launches, VAE
     encodes and peak memory are printed for each.
  7. Serving, on phase 6's loaded pipeline: ``edit_batch`` of 1, 2 and 4
     distinct 512^2 requests (text prompts, own images, ellipses and
     seeds; STEPS steps), warm, with seconds a batch and an image, peak
     memory and every K1 and K6 launch on the tensor cores, each row of
     the batch of four against its solo ``__call__`` (PSNR, for
     information); the toy 256^2 checkpoint in fp32, three batched rows
     against their solo edits, >= 40 dB; ``apps.server.serve`` with
     ``max_batch=4`` and ``preview_every=10``, warmed at STEPS steps (the
     seconds until ``/healthz`` is 200), then a solo request from PNG
     images, four concurrent requests that must come back as one batch
     of 4, the solo request from the 512^2 JPEG fixture's bytes against
     the one from its PNG (the same image back; K1 and K6 only, on the
     tensor cores, counted as differences, so the phase's tally keeps
     every request) and a truncated JPEG (400), then the decode repair
     (request images decode in the server's worker processes: during a
     STEPS-step edit the 12 MP JPEG request's handler thread spends < 0.1
     s of CPU; the edit's step times alone and during the decode, and
     the workers' start-up in the warmup, printed), a remove request, a
     preview request with ``/v1/progress`` seen mid-edit and a 400 for a
     cold shape; one traced 20-step edit
     (``utils/observability.profile_op_breakdown``: the top kernels, the
     hand-written kernels' share of device time, the device's busy share
     of the untraced edit's wall time, the device time by kind); the
     int8-everything edit without and with the int8 linear path
     (``matmul_i8`` on the card bit-equal to the CPU's first). Phase 2
     checks every K1 and K6 shape of the batches (one-step batches at B
     = 2 and 4 record them). Counters zeroed at the start of the phase
     and read at its end; K1, K6, K5 and K8 must each have run.
     After phase 7, the checkpoint day (``apps/checkpoint_day``) on phase
     6's models root, bf16, over phase 5's two states at CKPT_DAY_STEPS
     steps and one sample: every stage ``ok`` (download skipped, load, UI
     goldens all bit-exact, exact, int8, cfg_window, encoder_cache,
     int8_cache), each stage's seconds and PSNR drop logged; counters
     zeroed before each scoring stage and read after it: K5 and K8 in the
     int8 stages, K1 and K6 in the others, all on the tensor cores.
  8. One JSON line of per-kernel numbers, then ``{"ok": true, ...}`` last.
     Before it, the direct conv (K6) against Winograd (K12) at the fused
     edit's Winograd launches, both from phase 2's medians at those shapes.

Per-kernel numbers in the JSON line: ``launches`` are phase 4's (the exact
kernels' from the exact requests, the int8 kernels' from the int8 one, the
fused-kernel edit's four from the fused one), ``served_launches`` phase
7's;
the splat's from phase 5 (its views), with ``device_ms`` beside its wall
``ms``;
``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` are the time of all of
those launches, from the per-shape medians of phase 2 weighted by phase 4's
per-shape launch counts. ``bound_ms`` is the largest of bytes (each input
read once, each output written once) over 3.35 TB/s, the operations
over the card's peak for their type: 989 TFLOP/s for bf16 products,
1979 TOP/s for int8 products (H100 SXM data sheet), and, for the flash
kernels, one exponential per score over the special-function units' rate:
16 a clock per SM (CUDA programming guide, compute capability 9.0) x the
SMs x ``nvidia-smi --query-gpu=clocks.max.sm``; ``bound_ops`` says
whether the exponentials ("exp") or the products ("tensor") bind. The
Winograd conv's operations are its own multiply count, 4*C*Co MACs per
output pixel (the direct conv's 9*C*Co is logged beside it). The splat's
operations are fp32 arithmetic (about 20 per pixel and blob, and in the
view mode 6 per pixel and channel for the colours) at 67 TFLOP/s; its
bytes, the raw blob inputs read and the N*H*W*(M+1) fp32 output (the
view: H*W*3 uint8) written, bound it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores (SAM and CLIP vision)
PEAK_BYTES = 3.35e12
EXP_PER_SM_CLOCK = 16  # MUFU.EX2 per clock per SM (compute capability 9.0)
EXP_RATE = None        # exponentials per second: SMs x 16 x the max SM clock (main)
SPLAT_TOL = 1e-5  # absolute: the splat's outputs lie in [0, 1]
SPLAT_SHAPES = ((1, 512, 512, 1), (1, 512, 512, 3), (2, 512, 512, 11),
                (1, 1024, 1024, 4))  # (n, h, w, m)
VIEW_SIZES = (512, 1024)  # the view mode's canvases (M = 1), 512 the session's
PROMPT = "a red ball on a table"
SESSION_SIZE = 512  # the session's canvas (the pipeline's height and width)
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# phase 3's bf16 pass: PSNR(card bf16, CPU fp32) >= PSNR(CPU bf16, CPU fp32)
# less this margin
BF16_MARGIN_DB = 3.0
STEPS = 50  # UniPC steps of each full-width request
LORA_RANK, LORA_ALPHA = 16, 8.0  # phase 6's PEFT adapter


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

def _rnd(gen, *shape, s=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * s


def _flash_inputs(key, dtype, gen):
    bh, sq, skv, d = key[:4]
    q, k, v = (_rnd(gen, bh, n, d).to(dtype) for n in (sq, skv, skv))
    itemsize = q.element_size()
    # one product's operations; bytes: q, k, v read once, o written once
    prod = 2.0 * bh * sq * skv * d
    nbytes = (2 * bh * sq * d + 2 * bh * skv * d) * itemsize
    return q, k, v, d ** -0.5, prod, nbytes


def _exp_ms(key) -> float:
    """The time of one exponential per score on the special-function units."""
    bh, sq, skv = key[:3]
    return 1e3 * bh * sq * skv / EXP_RATE


def flash_case(key, dtype, gen):
    """key: (bh, sq, skv, d, dtype-name, fixed) as the wrapper logs it;
    modes: the fixed-max shift (main path), the running max."""
    from blobctrl_torch.ops import flash_attention as fa
    q, k, v, scale, prod, nbytes = _flash_inputs(key, dtype, gen)
    return dict(
        modes=(20.0, None), labels=("fixed-max", "running-max"),
        kernel=lambda fixed: fa.flash_attention(q, k, v, scale, fixed),
        plain=lambda fixed: fa.flash_attention_reference(q, k, v, scale),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=scale),
        ops_ms=1e3 * 2 * prod / PEAK_BF16_FLOPS, exp_ms=_exp_ms(key),
        nbytes=nbytes)


def flash_int8_case(key, dtype, gen):
    """key: (bh, sq, skv, d, dtype-name, global_k); modes: one global k
    scale (main path), per-row k scales. The q.k^T product is int8, P.V
    bf16; no PyTorch call computes the function, so no library time."""
    from blobctrl_torch.ops import flash_attention as fa
    q, k, v, scale, prod, nbytes = _flash_inputs(key, dtype, gen)
    return dict(
        modes=(True, False), labels=("global-k", "per-row-k"),
        kernel=lambda gk: fa.flash_attention_int8(q, k, v, scale,
                                                  global_k=gk),
        plain=lambda gk: fa.flash_attention_int8_reference(q, k, v, scale,
                                                           global_k=gk),
        library=None, prepass=lambda: _int8_prepass(q, k, scale),
        ops_ms=1e3 * (prod / PEAK_INT8_OPS + prod / PEAK_BF16_FLOPS),
        exp_ms=_exp_ms(key), nbytes=nbytes)


def _int8_prepass(q, k, scale):
    """The int8 flash wrapper's plain-torch pre-pass in global-k mode: the
    quantize and the row padding."""
    from blobctrl_torch.ops import flash_attention as fa
    q8, rq, k8, _ = fa.int8_operands(q, k, scale, True)
    return fa.int8_rows(q8), rq, fa.int8_rows(k8)


def _conv_inputs(key, dtype, gen):
    b, h, w, c, co = key[:5]
    prologue = key[6]
    x = _rnd(gen, b, h, w, c).to(dtype)
    k = _rnd(gen, 3, 3, c, co, s=(9 * c) ** -0.5).to(dtype)
    bias = _rnd(gen, co)
    pro = ((1.0 + 0.3 * _rnd(gen, b, c), _rnd(gen, b, c)) if prologue
           else (None, None))
    # bytes of everything but the weights: x, bias, scale/shift, y
    nbytes = ((b * h * w * c + b * h * w * co) * x.element_size() + 4 * co
              + (8 * b * c if prologue else 0))
    return x, k, bias, pro, 2.0 * b * h * w * co * 9 * c, nbytes


def conv_case(key, dtype, gen):
    """key: (b, h, w, c, co, dtype-name, prologue) as the wrapper logs it."""
    from blobctrl_torch.ops import conv3x3 as cv
    x, k, bias, pro, ops, nbytes = _conv_inputs(key, dtype, gen)
    xn = x.permute(0, 3, 1, 2)
    wn = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bias_d = bias.to(dtype)
    return dict(
        modes=(None,), labels=("",),
        kernel=lambda _: cv.conv3x3(x, k, bias, *pro),
        plain=lambda _: cv.conv3x3_reference(x, k, bias, *pro),
        # cuDNN's conv, without the prologue: no one library call fuses it
        library=lambda: torch.nn.functional.conv2d(xn, wn, bias_d, padding=1),
        ops_ms=1e3 * ops / PEAK_BF16_FLOPS,
        nbytes=nbytes + k.numel() * k.element_size())


def conv_int8_case(key, dtype, gen):
    """key: (b, h, w, c, co, dtype-name, prologue, act_amax): int8 weights
    with per-output-channel scales, as ``quantize_conv_tree`` makes them;
    no PyTorch call computes the function, so no library time."""
    from blobctrl_torch.ops import conv3x3 as cv
    x, k, bias, pro, ops, nbytes = _conv_inputs(key, dtype, gen)
    kq, ws = cv.quantize_kernel_i8(k)
    amax = key[7]
    b, h, w, c, co = key[:5]
    return dict(
        modes=(None,), labels=("",),
        kernel=lambda _: cv.conv3x3_int8(x, kq, ws, bias, *pro,
                                         act_amax=amax),
        plain=lambda _: cv.conv3x3_int8_reference(x, kq, ws, bias, *pro,
                                                  act_amax=amax),
        library=None, exact=not key[6], count_differ=True,
        int_mm=lambda: int_mm_ms(b * h * w, 9 * c, co),
        ops_ms=1e3 * ops / PEAK_INT8_OPS,
        nbytes=nbytes + kq.numel() + 4 * ws.numel())


def int_mm_ms(m, k, n):
    """cuBLASLt's int8 product (m, k) @ (k, n) -> int32 (``torch._int_mm``),
    or None where its shape rules refuse it (m > 16, k and n multiples of
    8). For information: the rate of the int8 product alone."""
    if m <= 16 or k % 8 or n % 8:
        return None
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda")
    bt = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda")
    return time_ms(lambda: torch._int_mm(a, bt.t()))


def flash_exp2_case(key, dtype, gen):
    """key: (bh, sq, skv, d, dtype-name): the exp2-folded fixed-max kernel
    (the fused-kernel edit's flash attention)."""
    from blobctrl_torch.ops import flash_attention as fa
    q, k, v, scale, prod, nbytes = _flash_inputs(key, dtype, gen)
    return dict(
        modes=(None,), labels=("",),
        kernel=lambda _: fa.flash_attention_exp2(q, k, v, scale),
        plain=lambda _: fa.flash_attention_exp2_reference(q, k, v, scale),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=scale),
        ops_ms=1e3 * 2 * prod / PEAK_BF16_FLOPS, exp_ms=_exp_ms(key),
        nbytes=nbytes)


def _gemm_case(x2d, w, kernel, plain, modes, labels, extra_bytes):
    """A normalize-prologue GEMM (M, C) @ (C, N); the library call is the
    same product without the prologue (no one PyTorch call fuses it)."""
    m, c = x2d.shape
    n = w.shape[1]
    nbytes = (m * c + c * n + m * n) * x2d.element_size() + 4 * n
    return dict(modes=modes, labels=labels, kernel=kernel, plain=plain,
                library=lambda: torch.matmul(x2d, w),
                ops_ms=1e3 * 2.0 * m * c * n / PEAK_BF16_FLOPS,
                nbytes=nbytes + extra_bytes)


def affine_matmul_case(key, dtype, gen):
    """key: (b, hw, c, n, dtype-name, affine) as the wrapper logs it; modes:
    the plain epilogue (gn_proj, the main path), the residual epilogue
    (gn_proj with a residual) and the residual epilogue without the affine
    (matmul_residual); bytes are the main mode's."""
    from blobctrl_torch.ops import gn_matmul as gm
    b, hw, c, n = key[:4]
    x = _rnd(gen, b, hw, 1, c).to(dtype)
    w = _rnd(gen, c, n, s=c ** -0.5).to(dtype)
    bias = _rnd(gen, n)
    s, t = 1.0 + 0.3 * _rnd(gen, b, c), _rnd(gen, b, c)
    res = _rnd(gen, b, hw, 1, n).to(dtype)
    args = {"plain": (s, t, None), "residual": (s, t, res),
            "residual, no affine": (None, None, res)}
    return _gemm_case(
        x.reshape(b * hw, c), w,
        kernel=lambda mode: gm.affine_matmul(x, w, bias, *args[mode]),
        plain=lambda mode: gm.affine_matmul_reference(x, w, bias,
                                                      *args[mode]),
        modes=tuple(args), labels=tuple(args), extra_bytes=8 * b * c)


def ln_matmul_case(key, dtype, gen):
    """key: (m, c, n, dtype-name)."""
    from blobctrl_torch.ops import ln_matmul as lm
    m, c, n = key[:3]
    x = _rnd(gen, m, c).to(dtype)
    gamma, beta = 1.0 + 0.3 * _rnd(gen, c), 0.1 * _rnd(gen, c)
    w = _rnd(gen, c, n, s=c ** -0.5).to(dtype)
    bias = _rnd(gen, n)
    return _gemm_case(
        x, w, kernel=lambda _: lm.ln_matmul(x, gamma, beta, w, bias),
        plain=lambda _: lm.ln_matmul_reference(x, gamma, beta, w, bias),
        modes=(None,), labels=("",), extra_bytes=8 * c)


def winograd_case(key, dtype, gen):
    """key: (b, h, w, c, co, dtype-name, prologue): the weights go in
    pre-transformed, as ``BlobNetPipeline._conv_params`` keeps them."""
    from blobctrl_torch.ops import winograd as wg
    x, k, bias, pro, ops, nbytes = _conv_inputs(key, dtype, gen)
    u = wg.transform_weights(k).to(dtype)
    xn = x.permute(0, 3, 1, 2)
    wn = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bias_d = bias.to(dtype)
    return dict(
        modes=(None,), labels=("",),
        kernel=lambda _: wg.conv3x3_winograd(x, k, bias, *pro, u=u),
        plain=lambda _: wg.conv3x3_winograd_reference(x, u, bias, *pro),
        # cuDNN's conv, without the prologue: no one library call fuses it
        library=lambda: torch.nn.functional.conv2d(xn, wn, bias_d, padding=1),
        ops_ms=1e3 * ops * 4 / 9 / PEAK_BF16_FLOPS,
        direct_ops_ms=1e3 * ops / PEAK_BF16_FLOPS,
        nbytes=nbytes + u.numel() * u.element_size())


CASES = {"flash_attention": flash_case, "conv3x3": conv_case,
         "flash_attention_int8": flash_int8_case,
         "conv3x3_int8": conv_int8_case,
         "flash_attention_exp2": flash_exp2_case,
         "affine_matmul": affine_matmul_case, "ln_matmul": ln_matmul_case,
         "winograd": winograd_case}


def shape_label(name, key) -> str:
    if name == "blob_splat":
        n, h, w, m, mode = key
        return f"{name} n={n} h={h} w={w} m={m} {mode}"
    if name.startswith("flash_attention"):
        bh, sq, skv, d = key[:4]
        return f"{name} bh={bh} sq={sq} skv={skv} d={d}"
    from blobctrl_torch.ops import conv3x3, gn_matmul, winograd
    if name == "affine_matmul":  # labels end in the bf16 kernel's split of C
        b, hw, c, n = key[:4]
        return (f"{name} b={b} hw={hw} c={c} n={n} "
                f"splits={gn_matmul.launch_config(b * hw, c, n)['splits']}")
    if name == "ln_matmul":
        m, c, n = key[:3]
        return (f"{name} m={m} c={c} n={n} "
                f"splits={gn_matmul.launch_config(m, c, n)['splits']}")
    b, h, w, c, co = key[:5]
    label = (f"{name} b={b} h={h} w={w} c={c} co={co}"
             f"{' +gn-silu' if key[6] else ''}")
    config = {"winograd": winograd.launch_config,
              "conv3x3": conv3x3.launch_config}.get(name)
    if config is not None:
        label += f" splits={config(b, h, w, c, co)['splits']}"
    return label + (f" amax={key[7]}" if name == "conv3x3_int8" else "")


def check_kernels(shapes, timing: bool = True):
    """shapes: {kernel name: recorded keys}. Every key in bf16 and fp32, in
    every mode, kernel against plain; with ``timing``, bf16 timings of each
    mode (the first mode is the main path's; ``<label>:ms`` and
    ``<label>:plain_ms`` the others'). -> per-kernel {key: numbers}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: {} for name in shapes}
    for name, keys in shapes.items():
        for key in sorted(keys, key=repr):
            row = {"max_abs_err": 0.0}
            for dtype in (torch.bfloat16, torch.float32):
                case = CASES[name](key, dtype, gen)
                for i, mode in enumerate(case["modes"]):
                    ref = case["plain"](mode)
                    got = case["kernel"](mode)
                    torch.cuda.synchronize()
                    abs_err, rel = rel_err(got, ref)
                    differ = (f", {int((got != ref).sum())} of "
                              f"{got.numel()} outputs differ"
                              if case.get("count_differ") else "")
                    del ref, got
                    tag = (f"{shape_label(name, key)} {str(dtype)[6:]} "
                           f"{case['labels'][i]}").rstrip()
                    if case.get("exact"):
                        ok = abs_err == 0.0
                        bar = "bit-equal"
                    else:
                        ok = rel <= TOL[dtype]
                        bar = f"tol {TOL[dtype]:.0e}"
                    log(f"  {tag}: max_abs {abs_err:.3e} rel {rel:.3e} "
                        f"({bar}{differ}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{tag}: rel {rel}")
                    row["max_abs_err"] = max(row["max_abs_err"], abs_err)
                    if dtype == torch.bfloat16 and timing:
                        pre = f"{case['labels'][i]}:" if i else ""
                        row[pre + "ms"] = time_ms(
                            lambda: case["kernel"](mode))
                        row[pre + "plain_ms"] = time_ms(
                            lambda: case["plain"](mode))
                if dtype == torch.bfloat16 and timing:
                    row["library_ms"] = (time_ms(case["library"])
                                         if case["library"] else None)
                    row["ops_ms"] = case["ops_ms"]
                    row["exp_ms"] = case.get("exp_ms", 0.0)
                    row["bytes_ms"] = 1e3 * case["nbytes"] / PEAK_BYTES
                    row["bound_ms"] = max(row["ops_ms"], row["exp_ms"],
                                          row["bytes_ms"])
                    if "direct_ops_ms" in case:
                        row["direct_bound_ms"] = max(case["direct_ops_ms"],
                                                     row["bytes_ms"])
                    if "prepass" in case:
                        row["prepass_ms"] = time_ms(case["prepass"])
                        log(f"    pre-pass (plain torch) {row['prepass_ms']:.4f}"
                            f" ms of the wrapper's {row['ms']:.4f} "
                            f"({100 * row['prepass_ms'] / row['ms']:.1f} %)")
                    if "int_mm" in case:
                        row["int_mm_ms"] = case["int_mm"]()
                        log("    torch._int_mm (M, 9C, Co), for information: "
                            + ("refused by its shape rules"
                               if row["int_mm_ms"] is None
                               else f"{row['int_mm_ms']:.4f} ms"))
                    lib = row["library_ms"]
                    others = "".join(
                        f" ({label} {row[label + ':ms']:.4f}, plain "
                        f"{row[label + ':plain_ms']:.4f})"
                        for label in case["labels"][1:])
                    log(f"    bf16 ms {row['ms']:.4f} plain "
                        f"{row['plain_ms']:.4f}{others}"
                        f" library {'none' if lib is None else f'{lib:.4f}'}"
                        f" bound {row['bound_ms']:.4f}"
                        + (f" (exp {row['exp_ms']:.4f}, tensor "
                           f"{row['ops_ms']:.4f})" if row["exp_ms"] else "")
                        + (f" (direct conv's count: "
                           f"{row['direct_bound_ms']:.4f})"
                           if "direct_bound_ms" in row else ""))
                del case
            results[name][key] = row
            torch.cuda.empty_cache()
    return results


def device_ms(fn, reps: int = 20):
    """Mean device time of one call (the sum of every kernel it runs), from
    ``torch.profiler``, so the host's launch overhead is left out; None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(ev, "device_time_total", None)
                   or getattr(ev, "cuda_time_total", 0)
                   for ev in prof.key_averages())
    return total_us / reps / 1e3 if total_us > 0 else None


def _blob_inputs(rng, n, m):
    """Blobs on the card: centres, covariances, sizes (a gated blob where
    m >= 3)."""
    xs, ys = (rng.uniform(0.1, 0.9, (n, m)) for _ in range(2))
    a, b = rng.uniform(0.002, 0.05, (2, n, m))
    rho = rng.uniform(-0.8, 0.8, (n, m)) * np.sqrt(a * b)
    covs = np.stack([np.stack([a, rho], -1), np.stack([rho, b], -1)], -2)
    sizes = np.ones((n, m))
    if m >= 3:
        sizes[0, 1] = 0.0
    return [torch.tensor(v, dtype=torch.float32, device="cuda")
            for v in (xs, ys, covs, sizes)]


def _splat_plain(args, h, w):
    """The scores' plain version from the raw inputs: rows, then scores."""
    from blobctrl_torch.ops import blob_splat as bs
    return bs.splat_scores_plain(bs.splat_params(*args, (h, w)), h, w)


def check_splat():
    """The blob splat (fp32) on the card: at SPLAT_SHAPES the raw-input
    kernel against its plain version (the rows of its prologue bit-equal to
    ``splat_params``, the scores within SPLAT_TOL), at VIEW_SIZES the view
    mode bit-equal to its plain version; each timed by wall time (events
    around the host call) beside its bound. -> ({(n, h, w, m, mode):
    numbers}, {key: the kernel's call}) for ``splat_device_times``."""
    from blobctrl_torch.blob import viz
    from blobctrl_torch.ops import blob_splat as bs
    rng = np.random.RandomState(0)
    keys = ([(n, h, w, m, "scores") for n, h, w, m in SPLAT_SHAPES]
            + [(1, s, s, 1, "view") for s in VIEW_SIZES])
    results, calls = {}, {}
    for key in keys:
        n, h, w, m, mode = key
        args = _blob_inputs(rng, n, m)
        params = bs.splat_params(*args, (h, w))
        rows_equal = torch.equal(bs.splat_rows(*args, (h, w)), params)
        # bound now: ``splat_device_times`` calls them after the loop
        if mode == "scores":
            kernel = functools.partial(bs.splat_scores, *args, (h, w))
            plain = functools.partial(_splat_plain, args, h, w)
            # output written, the raw inputs (7 floats a blob) read
            nbytes = 4 * n * h * w * (m + 1) + 28 * n * m
            flops = 20.0 * n * h * w * m
            tol = SPLAT_TOL
        else:
            colors = torch.tensor(viz.default_palette()[:m + 1],
                                  device="cuda")
            kernel = functools.partial(bs.blob_view, *args, (h, w), colors)
            plain = functools.partial(bs.blob_view_plain, *args, (h, w),
                                      colors)
            # 3 bytes a pixel written, image 0's inputs and the colours read
            nbytes = 3 * h * w + 28 * m + 12 * (m + 1)
            flops = (20.0 * m + 6.0 * (m + 1)) * h * w
            tol = 0.0
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ok = (rows_equal and err <= tol
              and bool(torch.isfinite(got.float()).all()))
        label = shape_label("blob_splat", key)
        out = "fp32" if mode == "scores" else "uint8"
        same = "bit-equal" if err == 0 else "differ"
        log(f"  {label} {out}: rows "
            f"{'bit-equal' if rows_equal else 'DIFFER'}, max_abs {err:.3e} "
            f"({same}; tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rows equal {rows_equal}, {err}")
        del got, ref
        row = {"max_abs_err": err, "ms": time_ms(kernel),
               "plain_ms": time_ms(plain), "library_ms": None, "exp_ms": 0.0,
               "ops_ms": 1e3 * flops / PEAK_FP32_FLOPS,
               "bytes_ms": 1e3 * nbytes / PEAK_BYTES}
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        log(f"    wall {1e3 * row['ms']:.2f} us, plain "
            f"{1e3 * row['plain_ms']:.2f} us, library none, bound "
            f"{1e3 * row['bound_ms']:.3f} us (bytes "
            f"{1e3 * row['bytes_ms']:.3f}, fp32 "
            f"{1e3 * row['ops_ms']:.3f})")
        results[key], calls[key] = row, kernel
    return results, calls


def splat_device_times(results, calls):
    """The splat's device time at each phase-2 key, into ``results``. Run
    after phase 5, so that every wall time of the script, the blob views'
    included, is taken before any profiler session."""
    for key, kernel in calls.items():
        row = results[key]
        row["device_ms"] = dev = device_ms(kernel)
        log(f"  {shape_label('blob_splat', key)}: device "
            f"{'not measured' if dev is None else f'{1e3 * dev:.2f} us'} "
            f"(wall {1e3 * row['ms']:.2f} us, bound "
            f"{1e3 * row['bound_ms']:.3f} us)")


@contextlib.contextmanager
def no_plain_view():
    """Inside the block, any plain splat or plain colour pass raises: the
    card's blob view must run on its kernel alone."""
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.ops import blob_splat as bs
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (bs, "blob_view_plain"), (bs, "splat_scores_plain"),
        (bs, "splat_params"), (blob_math, "splat_scores"),
        (blob_math, "splat_features_from_scores"))]

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"the blob view ran the plain {name}")
        return fn
    for mod, name, _ in saved:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# phase 1: the JPEG decoder on the card's host
# ---------------------------------------------------------------------------

JPEG_FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
JPEG_TIMING = os.path.join(ROOT, "assets", "jpeg_timing",
                           "photo_4032x3024_420.jpg")
JPEG_PHOTO = "photo_512_420"  # the session's and the server's JPEG


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo describes it: model name (which a
    virtual machine may hide), vendor, family/model/stepping, clock and
    vector extensions, and the count of logical CPUs."""
    fields = {}
    count = 0
    with open("/proc/cpuinfo") as f:
        for ln in f:
            key, _, val = ln.partition(":")
            key = key.strip()
            count += key == "processor"
            fields.setdefault(key, val.strip())
    flags = set(fields.get("flags", "").split())
    vec = ",".join(x for x in ("avx2", "avx512f", "avx512_bf16", "amx_tile")
                   if x in flags)
    return (f"{fields.get('model name', '?')}, {fields.get('vendor_id', '?')}"
            f" family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')} stepping "
            f"{fields.get('stepping', '?')}, {fields.get('cpu MHz', '?')} "
            f"MHz, {vec or 'no avx2'}, {count} logical CPUs")


def jpeg_phase():
    """Every committed JPEG fixture decoded by ``utils/jpeg.decode_jpeg``
    bit-equal to PIL's decode of it (the committed PNG beside it, read by
    the port's PNG decoder: this host has no PIL); the decode seconds of
    the 512^2 and the 4032x3024 4:2:0 files (best of 3)."""
    from blobctrl_torch.utils import image, jpeg, png
    log(f"  host CPU: {host_cpu()}")
    names = sorted(n[:-4] for n in os.listdir(JPEG_FIXTURES)
                   if n.endswith(".jpg"))
    for name in names:
        with open(os.path.join(JPEG_FIXTURES, name + ".jpg"), "rb") as f:
            data = f.read()
        with open(os.path.join(JPEG_FIXTURES, name + ".png"), "rb") as f:
            want = png.decode_png(f.read())
        got = jpeg.decode_jpeg(data)
        if got.shape != want.shape or not np.array_equal(got, want) or \
                not np.array_equal(image.decode_image(data), want):
            raise AssertionError(f"JPEG fixture {name}: not PIL's decode")
        log(f"  {name}.jpg {want.shape[1]}x{want.shape[0]}: bit-equal to "
            f"PIL's decode")
    for path in (os.path.join(JPEG_FIXTURES, JPEG_PHOTO + ".jpg"),
                 JPEG_TIMING):
        with open(path, "rb") as f:
            data = f.read()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            img = jpeg.decode_jpeg(data)
            best = min(best, time.perf_counter() - t0)
        log(f"  decode {os.path.basename(path)} ({len(data)} bytes, "
            f"{img.shape[1]}x{img.shape[0]}): {best:.3f} s (best of 3)")
        if not np.isfinite(img.astype(np.float32)).all() or img.ndim != 3:
            raise AssertionError(f"{path}: bad decode {img.shape}")
    if len(names) < 7:
        raise AssertionError(f"JPEG fixtures missing: {names}")


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


def launch_counts():
    """-> {kernel name: launches since the last ``ops.reset_counts()``} of
    every path's kernels."""
    from blobctrl_torch.ops import KERNELS
    return {name: getattr(KERNELS[name][0], KERNELS[name][1])
            for name in ALL_KERNELS}


def tensor_core_counts():
    """-> {kernel name: launches the C entry point ran on the tensor-core
    kernel since the last ``ops.reset_counts()``}."""
    from blobctrl_torch.ops import TENSOR_CORE
    return {name: getattr(mod, count)
            for name, (mod, count) in TENSOR_CORE.items()}


def check_tensor_cores(what, totals, names, tc=None):
    """Every bf16 launch of ``names`` (all of ``totals``) ran on the
    tensor-core kernel; ``tc`` the tensor-core counts over the same span
    as ``totals`` (by default those since the last reset)."""
    tc = tensor_core_counts() if tc is None else tc
    log(f"  {what}: tensor-core launches " + ", ".join(
        f"{k} {tc[k]} of {totals[k]}" for k in names if k in tc))
    wrong = {k: (tc[k], totals[k]) for k in names
             if k in tc and tc[k] != totals[k]}
    if wrong:
        raise AssertionError(f"{what}: bf16 launches off the tensor-core "
                             f"kernel: {wrong}")


def launch_shapes():
    """-> {kernel name: {shape key: launches}} since the last reset."""
    from blobctrl_torch.ops import KERNELS
    return {name: dict(getattr(KERNELS[name][0], KERNELS[name][2]))
            for name in ALL_KERNELS}


EXACT = ("flash_attention", "conv3x3")
INT8 = ("flash_attention_int8", "conv3x3_int8")
FUSED = ("flash_attention_exp2", "affine_matmul", "ln_matmul", "winograd")
MODES = {"exact": EXACT, "int8": INT8, "fused": FUSED}
SESSION = ("blob_splat",)  # the session's own kernel; its edits run EXACT
ALL_KERNELS = EXACT + INT8 + FUSED + SESSION
# the other modes of a kernel, checked and timed in phase 2 only:
# {kernel: [(phase-2 label, description)]}
OTHER_MODE = {"flash_attention": [("running-max", "running-max mode (K2)")],
              "flash_attention_int8": [("per-row-k", "per-row-k mode (K4)")],
              "affine_matmul": [
                  ("residual", "residual mode (K10, `:85`)"),
                  ("residual, no affine",
                   "residual mode without the affine (K10, `:85`, "
                   "matmul_residual)")]}


def mode_context(mode):
    """The switches of a path around a block."""
    from blobctrl_torch.utils import benchkit
    return {"exact": contextlib.nullcontext, "int8": benchkit.int8_everything,
            "fused": benchkit.fused_kernels}[mode]()


def toy_phase():
    from blobctrl_torch import ops
    from blobctrl_torch.train import toy
    ckpt = os.path.join(ROOT, "assets", "toy_ckpt_256")
    card, _ = toy.load_toy(ckpt, device="cuda", dtype=torch.float32)
    cpu, _ = toy.load_toy(ckpt, device="cpu", dtype=torch.float32)
    edits = toy_edits(256, 20)
    cpu_fp32 = {}
    for mode, kernels in MODES.items():
        for name, kw in edits.items():
            with mode_context(mode):
                ops.reset_counts()
                t0 = time.perf_counter()
                got = card(**kw).images
                t_card = time.perf_counter() - t0
                counts = launch_counts()
                t0 = time.perf_counter()
                want = cpu_fp32[mode, name] = cpu(**kw).images
                t_cpu = time.perf_counter() - t0
            p = psnr(got, want)
            ran = {k: counts[k] for k in kernels}
            log(f"  toy 256^2 {mode} {name}: card {t_card:.2f} s, cpu "
                f"{t_cpu:.2f} s, PSNR card vs cpu {p:.2f} dB, launches {ran}")
            if not (p >= 40.0 and min(ran.values()) > 0
                    and np.isfinite(got).all()):
                raise AssertionError(f"toy {mode} {name}: PSNR {p}, "
                                     f"launches {counts}")
            if mode == "int8":  # the int8 conv: tensor cores in fp32 too
                check_tensor_cores(f"toy 256^2 fp32 int8 {name}", counts,
                                   ("conv3x3_int8",))
    # this slice's samplers and options; the stochastic ones draw their
    # variance noise from the CPU generator on both sides
    for name, extra in (("ddim eta 0.5", dict(scheduler="ddim", eta=0.5,
                                                seed=5)),
                        ("dpm_sde_karras", dict(scheduler="dpm_sde_karras",
                                                seed=6)),
                        ("encoder cache 3", dict(encoder_cache_interval=3))):
        kw = dict(edits["move"], **extra)
        ops.reset_counts()
        got = card(**kw).images
        counts = launch_counts()
        want = cpu(**kw).images
        p = psnr(got, want)
        ran = {k: counts[k] for k in EXACT}
        log(f"  toy 256^2 exact move, {name}: PSNR card vs cpu {p:.2f} dB, "
            f"launches {ran}")
        if not (p >= 40.0 and min(ran.values()) > 0
                and np.isfinite(got).all()):
            raise AssertionError(f"toy {name}: PSNR {p}, launches {counts}")
    del card
    card, _ = toy.load_toy(ckpt, device="cuda", dtype=torch.bfloat16)
    cpu, _ = toy.load_toy(ckpt, device="cpu", dtype=torch.bfloat16)
    for mode in ("exact", "fused", "int8"):
        with mode_context(mode):
            ops.reset_counts()
            got = card(**edits["move"]).images
            counts = launch_counts()
            check_tensor_cores(f"toy 256^2 bf16 {mode} move", counts,
                               MODES[mode])
            want = cpu(**edits["move"]).images
        want32 = cpu_fp32[mode, "move"]
        floor, p32, p16 = (psnr(want, want32), psnr(got, want32),
                           psnr(got, want))
        ran = {k: counts[k] for k in MODES[mode]}
        log(f"  toy 256^2 bf16 {mode} move: PSNR card bf16 vs cpu fp32 "
            f"{p32:.2f} dB (bar: floor {floor:.2f} - {BF16_MARGIN_DB:.0f} = "
            f"{floor - BF16_MARGIN_DB:.2f}; floor = cpu bf16 vs cpu fp32), "
            f"card bf16 vs cpu bf16 {p16:.2f} dB, launches {ran}")
        if not (p32 >= floor - BF16_MARGIN_DB and min(ran.values()) > 0
                and np.isfinite(got).all()):
            raise AssertionError(f"toy bf16 {mode} move: PSNR {p32} against "
                                 f"the floor {floor}, launches {counts}")


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


def int8_workspace_mib(shapes) -> float:
    """The largest int32 split workspace of the int8 conv's launches."""
    from blobctrl_torch.ops import conv3x3
    most = 0
    for b, h, w, c, co, *_ in shapes["conv3x3_int8"]:
        splits = conv3x3.launch_config_int8(b, h, w, c, co)["splits"]
        if splits > 1:
            most = max(most, 4 * splits * b * h * w * co)
    return most / 2 ** 20


def run_request(pipe, kw):
    # each request encodes its images, as before the conditioning memo, so
    # its numbers stay comparable across runs
    pipe._cond_lat_cache.clear()
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe(**kw).images
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if out.shape != (1, 512, 512, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape}")
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    return out, secs, launches, torch.cuda.max_memory_allocated() / 2 ** 30


# ---------------------------------------------------------------------------
# phase 5: the interactive session
# ---------------------------------------------------------------------------

def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def encoder_times(pipe):
    """CLIP on [prompt, ""] and DINOv2 on one 512^2 object, each timed on
    its first call and again warm, outside the pipeline's memos."""
    from blobctrl_torch.models import clip_text, dinov2
    ids = torch.as_tensor(np.asarray(pipe.tokenizer([PROMPT, ""])))
    obj = np.random.RandomState(5).randint(
        0, 256, (1, SESSION_SIZE, SESSION_SIZE, 3)).astype(np.uint8)
    out = {}
    for name, fn in (
            ("clip", lambda: clip_text.apply(pipe.clip_params, pipe.clip_cfg,
                                             ids)),
            ("dinov2", lambda: pipe._encode_dino(torch.as_tensor(
                dinov2.preprocess_u8(obj), device=pipe.device)))):
        y, first = timed(fn)
        _, warm = timed(fn)
        if not torch.isfinite(y).all():
            raise AssertionError(f"{name}: non-finite output")
        out[name] = (1e3 * first, 1e3 * warm, tuple(y.shape))
    return out


def session_phase(pipe, steps: int):
    """The interactive session at full width; -> (per-shape splat
    launches, launch totals)."""
    from blobctrl_torch import ops
    from blobctrl_torch.apps import session
    from blobctrl_torch.blob import viz
    from blobctrl_torch.ops import blob_splat
    for name, (first, warm, shape) in encoder_times(pipe).items():
        log(f"  {name}: first call {first:.1f} ms, warm {warm:.1f} ms, "
            f"output {shape}")
    size = SESSION_SIZE
    sess = session.BlobCtrlSession(pipe, size=size)
    rng = np.random.RandomState(6)
    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    views = []
    _, secs = timed(lambda: sess.set_image(
        rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)))
    log(f"  set_image 640x480 -> {size}^2: {secs:.3f} s")
    k = size / 512
    sess.set_mask(viz.ellipse_mask(((260.0 * k, 250.0 * k),
                                    (150.0 * k, 220.0 * k), 25.0),
                                   size, size))
    for label, step in (("generate_blob", sess.generate_blob),
                        ("move(60, -20)", lambda: sess.move(60, -20)),
                        ("resize(1.2)", lambda: sess.resize(1.2)),
                        ("rotate(20)", lambda: sess.rotate(20))):
        _, secs = timed(step)
        before = blob_splat.launches
        with no_plain_view():
            view, vsecs = timed(sess.blob_visualization)
        views.append(view)
        ran = blob_splat.launches - before
        log(f"  {label}: {secs:.3f} s, blob view {1e3 * vsecs:.3f} ms "
            f"({ran} splat launch)")
        if ran != 1:
            raise AssertionError(f"blob view: {ran} splat launches, not 1")
    want = viz.blob_vis_from_ellipse(sess.editor.current, size, size,
                                     device="cpu")
    diff = int(np.abs(views[-1].astype(int) - want.astype(int)).max())
    log(f"  blob view card against CPU: max {diff} uint8 level(s)")
    if diff > 1 or views[-1].shape != (size, size, 3):
        raise AssertionError(f"blob view differs from the CPU by {diff}")
    runs = (("run", {}), ("run after move(-30, 10)", {}),
            ("run, remove", {"remove": True}))
    for label, kw in runs:
        if label.startswith("run after"):
            sess.move(-30, 10)
        if kw.get("remove"):
            sess.set_remove_mode(True)
        before = launch_counts()
        res, secs = timed(lambda: sess.run(PROMPT, num_inference_steps=steps,
                                           **kw))
        launches = {k: n - before[k] for k, n in launch_counts().items()
                    if n - before[k]}
        if res.images.shape != (1, size, size, 3) or not np.isfinite(
                res.images).all():
            raise AssertionError(f"session {label}: bad output "
                                 f"{res.images.shape}")
        log(f"  {label}: {secs:.3f} s, launches {launches}, memos: "
            f"{len(pipe._prompt_cache)} prompt, {len(pipe._dino_cache)} "
            f"object")
    if len(pipe._prompt_cache) != 1 or len(pipe._dino_cache) != 1:
        raise AssertionError("the prompt and object memos did not hit")
    totals = launch_counts()
    log(f"  session launches {totals}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    others = {k: n for k, n in totals.items()
              if n and k not in SESSION + EXACT}
    if totals["blob_splat"] == 0 or min(totals[k] for k in EXACT) == 0 \
            or others:
        raise AssertionError(f"session launches {totals}")
    check_tensor_cores("session", totals, EXACT)
    splat_shapes = launch_shapes()["blob_splat"]
    log("  the blob view's parts, a call (mean of 20, host clock, each "
        "ending in a device sync):")
    for part, us in view_parts(sess).items():
        log(f"    {part}: {us:.1f} us")
    return splat_shapes, totals["blob_splat"]


class EllipsePredictor:
    """A stand-in for SAM: the mask is the port's raster ellipse around the
    mean of the positive clicks."""

    def set_image(self, img):
        self.hw = img.shape[:2]

    def predict(self, points, labels, multimask_output=False):
        from blobctrl_torch.blob import viz
        pos = np.asarray(points, np.float64)[np.asarray(labels) > 0]
        cx, cy = pos.mean(0) if len(pos) else (self.hw[1] / 2,
                                               self.hw[0] / 2)
        h, w = self.hw
        m = viz.ellipse_mask(((float(cx), float(cy)), (0.3 * w, 0.45 * h),
                              20.0), h, w) > 0
        return m[None], np.ones(1, np.float32), m[None].astype(np.float32)


def tracking_phase(pipe, steps: int, demo_root: str):
    """The demo's editing flow at full width: ``set_image`` from the 512^2
    JPEG fixture through ``decode_image``, two clicks through the stand-in
    predictor, ``generate_blob``, then the tracking points (a first click
    outside the blob, one inside, two moves, an undo, a move), each
    overlay timed; the refused click's K9 view held within one level of
    the CPU's view. The overlays themselves are host float64 numpy with
    no device op (the renderer is bit-equal to the JAX one in the CPU
    tests), so the last one against a CPU session's is a host-determinism
    log, not a card result. One ``steps``-step run from the tracked state
    with every K1 and K6 launch on the tensor cores. Writes two demo states into
    ``demo_root`` (the move with its tracking points and editable-blob
    golden, and a remove), each with a results gallery, for the
    checkpoint-day run."""
    from blobctrl_torch import ops
    from blobctrl_torch.apps import session
    from blobctrl_torch.utils import image, png
    size = SESSION_SIZE
    with open(os.path.join(JPEG_FIXTURES, JPEG_PHOTO + ".jpg"), "rb") as f:
        photo = image.decode_image(f.read())
    sess = session.BlobCtrlSession(pipe, sam_predictor=EllipsePredictor(),
                                   size=size)
    ops.reset_counts()
    _, secs = timed(lambda: sess.set_image(photo))
    log(f"  set_image from the {photo.shape[1]}x{photo.shape[0]} JPEG: "
        f"{secs:.3f} s")
    for x, y in ((240, 250), (280, 270)):
        m, secs = timed(lambda: sess.click(x, y))
        log(f"  click({x}, {y}): {secs:.3f} s, mask {int((m > 0).sum())} px")
    ellipse, secs = timed(sess.generate_blob)
    log(f"  generate_blob: {secs:.3f} s, ellipse {ellipse}")
    cx, cy = (int(v) for v in sess.editor.initial[0])
    steps_ = (("add_tracking_point outside the blob", lambda: sess.
               add_tracking_point(5, 5)),
              ("add_tracking_point inside (selects)", lambda: sess.
               add_tracking_point(cx + 3, cy - 2)),
              ("move to (+60, -25)", lambda: sess.add_tracking_point(
                  cx + 60, cy - 25)),
              ("move to (+90, +40)", lambda: sess.add_tracking_point(
                  cx + 90, cy + 40)),
              ("undo_tracking_point", sess.undo_tracking_point),
              ("move to (-40, +55)", lambda: sess.add_tracking_point(
                  cx - 40, cy + 55)))
    for label, step in steps_:
        out, secs = timed(step)
        overlay, warning = out if isinstance(out, tuple) else (out, None)
        log(f"  {label}: {1e3 * secs:.1f} ms"
            + (f", warning {warning!r}" if warning else ""))
        if label.endswith("outside the blob"):
            if warning is None or sess.tracking_points:
                raise AssertionError("the first click outside the blob was "
                                     "not refused")
            want = session.BlobCtrlSession(None, size=size, device="cpu")
            want.editor.entries = list(sess.editor.entries)
            view = want.blob_visualization()
            diff = int(np.abs(overlay.astype(int) - view.astype(int)).max())
            log(f"  the refused click's view (K9 on the card) against the "
                f"CPU's: max {diff} uint8 level(s)")
            if diff > 1:
                raise AssertionError(f"warning view: {diff} levels off")
        elif warning is not None or overlay.shape != (size, size, 3):
            raise AssertionError(f"{label}: {warning} {overlay.shape}")
    cpu = session.BlobCtrlSession(None, size=size, device="cpu")
    cpu.editor.entries = list(sess.editor.entries)
    cpu.tracking_points = [list(p) for p in sess.tracking_points]
    if not np.array_equal(cpu.tracking_overlay(), overlay):
        raise AssertionError("tracking overlay differs from the CPU's")
    log(f"  tracking points {sess.tracking_points}; the overlay (host "
        f"float64, no device op) equals a CPU session's: host determinism "
        f"only")
    before = launch_counts()
    res, secs = timed(lambda: sess.run(PROMPT, num_inference_steps=steps))
    totals = {k: n - before[k] for k, n in launch_counts().items()}
    log(f"  run from the tracked state: {secs:.3f} s, launches "
        f"{ {k: n for k, n in totals.items() if n} }")
    if res.images.shape != (1, size, size, 3) or \
            not np.isfinite(res.images).all():
        raise AssertionError(f"tracked run: bad output {res.images.shape}")
    if min(totals[k] for k in EXACT) == 0 or any(
            n for k, n in totals.items() if k not in EXACT + SESSION):
        raise AssertionError(f"tracked run launches {totals}")
    check_tensor_cores("tracked run", launch_counts(), EXACT)

    def gallery(d, arr):
        os.makedirs(os.path.join(d, "results_gallery"), exist_ok=True)
        with open(os.path.join(d, "results_gallery", "result_0.png"),
                  "wb") as f:
            f.write(png.encode_png(arr))
    d = os.path.join(demo_root, DEMO_STATES[0])
    sess.save_state(d, prompt=PROMPT, num_inference_steps=steps, seed=7)
    os.makedirs(os.path.join(d, "editable_blob"))
    with open(os.path.join(d, "editable_blob", "editable_blob.png"),
              "wb") as f:
        f.write(png.encode_png(overlay))
    gallery(d, (res.images[0] * 255).astype(np.uint8))
    sess.set_remove_mode(True)
    d = os.path.join(demo_root, DEMO_STATES[1])
    sess.save_state(d, prompt=PROMPT, remove=True, seed=8)
    gallery(d, sess.original_image)


def view_parts(sess, reps: int = 20):
    """-> {part: microseconds a call} of the session's blob view: the
    host's ellipse -> Gaussian math, the one upload of the inputs and
    colours, the view op's wrapper and kernel, the copy of the uint8 view
    back, and the whole call."""
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.blob import viz
    from blobctrl_torch.ops import blob_splat as bs
    size, ellipse = sess.size, sess.editor.current

    def host_math():
        return blob_math.normalize_gaussian(
            *blob_math.gaussian_from_ellipse(ellipse), size, size)
    mean, cov = host_math()
    buf = np.concatenate([mean, np.ravel(cov), [1.0],
                          viz.default_palette()[:2].ravel()]).astype(
                              np.float32)

    def upload():
        return torch.from_numpy(buf).to("cuda")
    d = upload()
    args = (d[0:1].view(1, 1), d[1:2].view(1, 1), d[2:6].view(1, 1, 2, 2),
            d[6:7].view(1, 1), (size, size), d[7:13].view(2, 3))
    img = bs.blob_view(*args)
    out = {}
    for part, fn in (("ellipse -> Gaussian (host)", host_math),
                     ("upload", upload),
                     ("wrapper and kernel", lambda: bs.blob_view(*args)),
                     ("copy back (0.75 MB uint8)", lambda: img.cpu().numpy()),
                     ("whole view", sess.blob_visualization)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        out[part] = 1e6 * (time.perf_counter() - t0) / reps
    return out


# ---------------------------------------------------------------------------
# phase 5, continued: SAM (ViT-H) and the safety checker (CLIP ViT-L/14)
# ---------------------------------------------------------------------------

SAM_SEED = 11
SAM_CLICKS = ((240, 250, 1), (280, 270, 1))
SAM_CUT_LAYERS = 8       # the card-against-CPU check's depth (global at 7)
SAFETY_STEPS = 20


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def sam_encoder_flops(cfg) -> float:
    """Floating-point operations of one ViT image (``vision_encoder``):
    the products (2 a multiply-add) of the patch conv, every block's
    linears (the windowed blocks on the padded grid), attention products
    with their relative-position einsums, and the neck."""
    c, m, g, heads = (cfg.hidden_size, cfg.mlp_dim, cfg.embed_grid,
                      cfg.num_heads)
    d = c // heads
    win = cfg.window_size
    padded = -(-g // win) * win
    flops = 2.0 * g * g * cfg.patch_size ** 2 * 3 * c
    for i in range(cfg.num_layers):
        tokens = g * g if i in cfg.global_attn_indexes else padded ** 2
        span = g if i in cfg.global_attn_indexes else win
        seqs = tokens // span ** 2            # attention groups
        flops += 2.0 * tokens * c * 4 * c     # qkv and proj
        flops += 2.0 * g * g * c * m * 2      # the MLP
        flops += seqs * heads * (2.0 * 2 * span ** 4 * d     # q.k, p.v
                                 + 2.0 * 2 * span ** 3 * d)  # rel h, w
    oc = cfg.output_channels
    return flops + 2.0 * g * g * (c * oc + 9 * oc * oc)


def sam_checkpoint(models_root: str, device="cuda", cfg=None):
    """The ViT-H SAM of phase 6's models root: a seeded random tree at
    full geometry written as ``sam/sam_vit_h_4b8939.pth`` in the original
    segment_anything key layout (fp32), loaded with ``params.io.load_sam``
    and held leaf for leaf, bit-equal, to the drawn tree; -> the loaded
    tree. ``device`` and ``cfg`` (ViT-H by default) let it be rehearsed on
    the CPU at a small size."""
    from blobctrl_torch.models import sam
    from blobctrl_torch.params import export, io
    drawn = sam.init(cfg or sam.SAMConfig.vit_h(), seed=SAM_SEED,
                     device=device)
    os.makedirs(os.path.join(models_root, "sam"), exist_ok=True)
    path = os.path.join(models_root, "sam", "sam_vit_h_4b8939.pth")
    t0 = time.perf_counter()
    nbytes = export.save_sam(path, drawn)
    secs = time.perf_counter() - t0
    n_params = sum(t.numel() for t in export.flatten(drawn).values())
    log(f"  wrote sam/sam_vit_h_4b8939.pth: {nbytes} bytes ({n_params} fp32 "
        f"parameters) in {secs:.2f} s")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    loaded, secs = timed(lambda: io.load_sam(path, device=device))
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device != "cpu" else float("nan"))
    got, want = export.flatten(loaded), export.flatten(drawn)
    wrong = [k for k, w in want.items()
             if k not in got or got[k].dtype != torch.float32
             or not torch.equal(got[k], w)]
    log(f"  load_sam: {secs:.2f} s ({nbytes / 2 ** 30 / secs:.2f} GiB/s of "
        f"file), peak device memory {peak:.2f} GiB (the drawn tree and the "
        f"phase's pipeline included); {len(want) - len(wrong)} of "
        f"{len(want)} leaves bit-equal to the drawn ones")
    if wrong or set(got) != set(want):
        raise AssertionError(f"load_sam: leaves differ: {wrong[:5]}")
    return loaded


def sam_session_phase(pipe, sam_tree, device="cuda", cfg=None):
    """The demo's click -> mask flow through the real predictor: a session
    on the phase's pipeline with ``SamPredictor(load_sam(...))``, the 512^2
    JPEG photo (``set_image``: ViT-H at 1024^2), two clicks and their
    masks; warm medians of ``set_image`` and ``predict``; the full-depth
    embedding finite and bit-equal across two calls. Then the card against
    the CPU at a cut depth (SAM_CUT_LAYERS blocks, full width, 1024^2,
    TF32 switched on before the predictor runs, which must switch it off
    for its calls and restore it):
    the embedding and the mask logits (each normalized by its max) within
    1e-4. Random weights give no ellipse-like mask, so the ellipse fit and
    the tracking flow keep the stand-in predictor (``tracking_phase``).
    SAM reaches no hand-written kernel: the counters stay at zero.
    ``device`` and ``cfg`` (ViT-H by default) as in ``sam_checkpoint``."""
    from blobctrl_torch import ops
    from blobctrl_torch.apps import session
    from blobctrl_torch.models import sam
    from blobctrl_torch.nn import layers
    from blobctrl_torch.utils import image
    with open(os.path.join(JPEG_FIXTURES, JPEG_PHOTO + ".jpg"), "rb") as f:
        photo = image.decode_image(f.read())
    cfg = cfg or sam.SAMConfig.vit_h()
    pred = sam.SamPredictor(sam_tree, cfg, device=device)
    sess = session.BlobCtrlSession(pipe, sam_predictor=pred,
                                   size=SESSION_SIZE)
    ops.reset_counts()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    _, secs = timed(lambda: sess.set_image(photo))
    log(f"  set_image ({cfg.num_layers} blocks of width {cfg.hidden_size} at "
        f"{cfg.image_size}^2, fp32), first call: {secs:.3f} s")
    for x, y, lb in SAM_CLICKS:
        m, secs = timed(lambda: sess.click(x, y, lb))
        log(f"  click({x}, {y}): {1e3 * secs:.1f} ms, mask {m.shape} "
            f"{m.dtype}, {int((m > 0).sum())} px")
        if m.shape != (SESSION_SIZE, SESSION_SIZE) or m.dtype != np.uint8:
            raise AssertionError(f"click: mask {m.shape} {m.dtype}")
    img = sess.original_image
    embeds, set_ms = [], []
    for _ in range(4):
        _, secs = timed(lambda: pred.set_image(img))
        set_ms.append(1e3 * secs)
        embeds.append(pred._embedding.clone())
    pts = np.asarray([p[:2] for p in sess.selected_points], np.float32)
    lbs = np.asarray([p[2] for p in sess.selected_points], np.int32)
    pred_ms = [1e3 * timed(lambda: pred.predict(pts, lbs))[1]
               for _ in range(6)]
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device != "cpu" else float("nan"))
    log(f"  set_image warm: median {statistics.median(set_ms[1:]):.1f} ms "
        f"(calls {', '.join(f'{t:.1f}' for t in set_ms)}), predict warm: "
        f"median {statistics.median(pred_ms[1:]):.2f} ms; peak device "
        f"memory {peak:.2f} GiB")
    emb = embeds[-1]
    # where set_image's time goes: the host's resize and normalization,
    # then the encoder on the device (its kernels by device time)
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        px, _, _ = sam.preprocess_image(img, cfg)
        host_ms.append(1e3 * (time.perf_counter() - t0))
    px = torch.from_numpy(px).to(device)
    if device != "cpu":
        with layers.strict_fp32(device):  # as set_image runs it
            enc_ms = time_ms(lambda: sam.vision_encoder(
                sam_tree["vision"], cfg, px), reps=3, warmup=1)
        flops = sam_encoder_flops(cfg)
        log(f"  set_image's parts: host preprocess median "
            f"{statistics.median(host_ms):.1f} ms; the encoder on the card "
            f"{enc_ms:.1f} ms (CUDA events, median of 3): "
            f"{flops / 1e12:.2f} TFLOP, {flops / enc_ms / 1e9:.1f} TFLOP/s, "
            f"{100 * flops / enc_ms / 1e9 / (PEAK_FP32_FLOPS / 1e12):.1f} % "
            f"of the fp32 peak ({PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s, TF32 "
            f"off)")
        from blobctrl_torch.utils import observability
        with torch.inference_mode(), layers.strict_fp32(device):
            ops_ms = observability.profile_op_breakdown(
                lambda: sam.vision_encoder(sam_tree["vision"], cfg, px),
                repeats=1, top_k=100000)
        total = sum(ops_ms.values())
        log(f"  the encoder traced: {total:.1f} ms of device time over "
            f"{len(ops_ms)} kernels; the top eight:")
        for name, ms in list(ops_ms.items())[:8]:
            log(f"    {ms:9.2f} ms  {name[:100]}")
    g = cfg.embed_grid
    if (tuple(emb.shape) != (1, g, g, cfg.output_channels)
            or not torch.isfinite(emb).all()
            or not torch.equal(embeds[-2], emb)):
        raise AssertionError("full-depth embedding: not finite, wrong "
                             "shape, or differs between two calls")
    log(f"  full-depth embedding {tuple(emb.shape)} finite, two calls "
        f"bit-equal; launches of the hand kernels: "
        f"{ {k: n for k, n in launch_counts().items() if n} }")
    if any(launch_counts().values()):
        raise AssertionError("SAM launched a hand-written kernel")
    # the card against the CPU at a cut depth
    cut = dataclasses.replace(cfg, num_layers=SAM_CUT_LAYERS,
                              global_attn_indexes=(SAM_CUT_LAYERS - 1,))
    tree = dict(sam_tree, vision=dict(
        sam_tree["vision"], layers=sam_tree["vision"]["layers"][:SAM_CUT_LAYERS]))
    out = {}
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True   # the predictor must turn these
    torch.backends.cuda.matmul.allow_tf32 = True  # off for its calls only
    for dev in (device, "cpu"):
        p = sam.SamPredictor(_tree_to(tree, dev), cut, device=dev)
        t0 = time.perf_counter()
        p.set_image(img)
        _, _, logits = p.predict(pts, lbs)
        if dev != "cpu":
            torch.cuda.synchronize()
        out[dev] = (p._embedding.float().cpu(), torch.from_numpy(logits),
                    time.perf_counter() - t0)
    if not (torch.backends.cudnn.allow_tf32
            and torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the predictor did not restore the TF32 "
                             "switches")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
    (ce, cl, csec), (he, hl, hsec) = out[device], out["cpu"]
    e_err = rel_err(ce, he)[1]
    l_err = rel_err(cl, hl)[1]
    log(f"  cut depth ({SAM_CUT_LAYERS} blocks, global at "
        f"{SAM_CUT_LAYERS - 1}, width {cfg.hidden_size}, "
        f"{cfg.image_size}^2), card against CPU: "
        f"embedding {e_err:.2e}, mask logits {l_err:.2e} of max |CPU| "
        f"(bar 1e-4); card {csec:.2f} s, CPU {hsec:.2f} s (first calls)")
    if not (e_err <= 1e-4 and l_err <= 1e-4):
        raise AssertionError(f"SAM card against CPU: {e_err}, {l_err}")


def safety_phase(pipe, device="cuda", steps: int = SAFETY_STEPS,
                 size: int = SESSION_SIZE, cfg=None):
    """The safety checker on the edit: CLIP ViT-L/14 vision (24 layers,
    width 1024, 224^2, patch 14) with a 768-wide projection, 17 concept
    and 3 special-care embeddings, random, round-tripped through
    ``export.safety_checker_state_dict`` and the port's converter (leaves
    bit-equal). A ``steps``-step edit without a checker, with one that can
    never flag (thresholds +2: flags all False, images bit-equal to the
    unchecked edit's) and with one that always flags (-2) under
    ``blackout_nsfw`` (flags all True, every pixel 0); then ``edit_batch``
    at B = 2 unchecked and checked by a callable that runs the never-flag
    checker on row 0 and the always-flag one on row 1. K1 and K6 launch in
    every edit, all on the tensor cores; the checker alone launches no
    hand kernel. The checker's ms, and its pooled embedding and scores
    card against CPU (within 1e-4 of max |CPU|). ``device``, ``size``
    and ``cfg`` (ViT-L/14 by default) let it be rehearsed on the CPU."""
    from blobctrl_torch import ops
    from blobctrl_torch.models import clip_vision, safety_checker as sc
    from blobctrl_torch.params import export, io
    cfg = cfg or clip_vision.CLIPVisionConfig()
    drawn = sc.init(cfg, seed=13, device=device)
    params = sc.convert_safety_checker(export.safety_checker_state_dict(
        drawn), leaf=io._device_leaf(device, torch.float32))
    got, want = export.flatten(params), export.flatten(drawn)
    if set(got) != set(want) or not all(torch.equal(got[k], w)
                                        for k, w in want.items()):
        raise AssertionError("safety checker: the state-dict round trip "
                             "changed a leaf")
    log(f"  checker: {sum(t.numel() for t in want.values())} fp32 "
        f"parameters, {len(want)} leaves bit-equal after the diffusers "
        f"state-dict round trip")

    def thresholds(t):
        return dict(params, concept_embeds_weights=torch.full_like(
            params["concept_embeds_weights"], t),
            special_care_embeds_weights=torch.full_like(
                params["special_care_embeds_weights"], t))
    never = functools.partial(sc.check, thresholds(2.0), cfg, device=device)
    always = functools.partial(sc.check, thresholds(-2.0), cfg,
                               device=device)
    kw = text_edit_kwargs(size, steps)

    def edit(label, checker, fn):
        pipe.safety_checker, pipe.blackout_nsfw = checker, True
        try:
            ops.reset_counts()
            res, secs = timed(fn)
        finally:
            pipe.safety_checker, pipe.blackout_nsfw = None, False
        counts = launch_counts()
        ran = {k: n for k, n in counts.items() if n}
        if set(ran) != set(EXACT):
            raise AssertionError(f"{label}: launches {ran}")
        check_tensor_cores(label, counts, EXACT)
        return res, secs, ran
    outs = {}
    for label, checker in (("no checker", None), ("never flags", never),
                           ("always flags, blackout_nsfw", always)):
        res, secs, ran = edit(label, checker, lambda: pipe(**kw))
        outs[label] = res
        log(f"  {steps}-step edit, {label}: {secs:.3f} s, flags "
            f"{None if res.nsfw_content_detected is None else res.nsfw_content_detected.tolist()}, "
            f"launches {ran}")
    base = outs["no checker"]
    ok = (base.nsfw_content_detected is None
          and outs["never flags"].nsfw_content_detected.tolist() == [False]
          and np.array_equal(outs["never flags"].images, base.images)
          and outs["always flags, blackout_nsfw"].nsfw_content_detected
          .tolist() == [True]
          and not outs["always flags, blackout_nsfw"].images.any()
          and base.images.any())
    log(f"  never-flag edit bit-equal to the unchecked one, always-flag "
        f"edit all zeros: {ok}")
    if not ok:
        raise AssertionError("the checked single edits are wrong")
    reqs = serving_requests(size, 2)
    shared = dict(SERVE_SHARED, height=size, width=size,
                  num_inference_steps=steps)

    def rows(images):
        return np.concatenate([never(images[:1]), always(images[1:])])
    batches = {}
    for label, checker in (("unchecked", None), ("row 1 flagged", rows)):
        res, secs, ran = edit(f"edit_batch, {label}", checker,
                              lambda: pipe.edit_batch(reqs, **shared))
        batches[label] = res
        log(f"  edit_batch B=2, {label}: {secs:.3f} s, flags "
            f"{None if res.nsfw_content_detected is None else res.nsfw_content_detected.tolist()}, "
            f"launches {ran}")
    b0, b1 = batches["unchecked"], batches["row 1 flagged"]
    ok = (b1.nsfw_content_detected.tolist() == [False, True]
          and np.array_equal(b1.images[0], b0.images[0])
          and not b1.images[1].any() and b0.images[1].any())
    log(f"  batched: row 0 bit-equal to the unchecked batch's, row 1 all "
        f"zeros: {ok}")
    if not ok:
        raise AssertionError("the checked batch is wrong")
    ops.reset_counts()
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        px = clip_vision.preprocess(base.images, cfg.image_size)
        host_ms.append(1e3 * (time.perf_counter() - t0))
    if device != "cpu":
        dev_ms = time_ms(lambda: clip_vision.apply(params["vision"], cfg, px,
                                                   device=device), reps=5)
        log(f"  check()'s parts for one image: host preprocess median "
            f"{statistics.median(host_ms):.1f} ms, CLIP ViT-L/14 on the card "
            f"{dev_ms:.2f} ms (CUDA events, median of 5)")
    ms = [1e3 * timed(lambda: never(base.images))[1] for _ in range(6)]
    ms2 = [1e3 * timed(lambda: never(b0.images))[1] for _ in range(6)]
    if any(launch_counts().values()):
        raise AssertionError("the checker launched a hand-written kernel")
    log(f"  check() warm median: {statistics.median(ms[1:]):.1f} ms for one "
        f"{size}^2 image, {statistics.median(ms2[1:]):.1f} ms for two (host "
        f"preprocess included; first call {ms[0]:.1f} ms); no hand kernel")
    images = np.concatenate([base.images, b0.images])
    card = sc.scores(params, cfg, images, device=device)
    cpu = sc.scores(_tree_to(params, "cpu"), cfg, images, device="cpu")
    errs = [rel_err(c.float().cpu(), h)[1] for c, h in zip(card, cpu)]
    log(f"  full geometry, card against CPU on {len(images)} images: pooled "
        f"{errs[0]:.2e}, special-care scores {errs[1]:.2e}, concept scores "
        f"{errs[2]:.2e} of max |CPU| (bar 1e-4)")
    if max(errs) > 1e-4:
        raise AssertionError(f"checker card against CPU: {errs}")


# ---------------------------------------------------------------------------
# phase 6: a reference-layout checkpoint at full geometry
# ---------------------------------------------------------------------------

def reference_configs():
    """The nets as the downloaded checkpoints hold them: SD-1.5's UNet at 4
    input channels (the loader widens it to 5), BlobNet, the VAE, CLIP
    ViT-L/14 text and DINOv2-large."""
    from blobctrl_torch.apps import flagship
    return dict(unet=dataclasses.replace(flagship.sd15_unet_config(),
                                         in_channels=4),
                blobnet=flagship.blobctrl_blobnet_config(),
                vae=flagship.sd15_vae_config(),
                clip=flagship.clip_vit_l_config(),
                dino=flagship.dinov2_large_config())


def draw_reference_trees(cfgs, seed: int, device):
    """The five trees drawn on ``device`` in fp16, the checkpoint's dtype
    (the JAX init bounds), and a rank-16 LoRA over the UNet's attention
    projections: A ~ N(0, 1/in), B ~ N(0, 0.02^2), stored in fp16."""
    from blobctrl_torch.models import blobnet, clip_text, dinov2, unet, vae
    from blobctrl_torch.params import export
    f16 = torch.float16
    trees = dict(
        unet=unet.init_unet(cfgs["unet"], seed, device, f16),
        blobnet=blobnet.init_blobnet(cfgs["blobnet"], seed + 1, device, f16,
                                     zero_taps=False),
        vae=vae.init_vae(cfgs["vae"], seed + 2, device, f16),
        clip=clip_text.init(cfgs["clip"], seed + 3, device, f16),
        dino=dinov2.init(cfgs["dino"], seed + 4, device, f16))
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    lora = {}
    for path, k in export.flatten(trees["unet"]).items():
        parts = path.split(".")
        if parts[-1] == "kernel" and parts[-2] in ("to_q", "to_k", "to_v",
                                                    "to_out"):
            d_in, d_out = k.shape
            a = torch.randn(d_in, LORA_RANK, generator=gen, device=device)
            b = torch.randn(LORA_RANK, d_out, generator=gen, device=device)
            lora["/".join(parts[:-1])] = {"A": (a / d_in ** 0.5).to(f16),
                                          "B": (b * 0.02).to(f16)}
    return trees, lora


def check_loaded(pipe, trees, lora):
    """Every loaded leaf bit-equal to the drawn one cast to bf16: conv_in
    widened with a zero channel, each LoRA target equal to the plain
    formula, the fp32 merge on the card, then the cast. -> merged count."""
    from blobctrl_torch.params import export
    bf16 = torch.bfloat16
    eff = 1.0 * LORA_ALPHA / LORA_RANK
    wrong, merged, leaves = [], 0, 0
    for net in ("unet", "blobnet", "vae", "clip", "dino"):
        got = export.flatten(getattr(pipe, net + "_params"))
        want = export.flatten(trees[net])
        if set(got) != set(want):
            raise AssertionError(f"{net}: loaded keys differ: "
                                 f"{sorted(set(got) ^ set(want))[:5]}")
        for k, w in want.items():
            g, leaves = got[k], leaves + 1
            target = k.rsplit(".", 1)[0].replace(".", "/")
            if net == "unet" and k == "conv_in.kernel":
                ok = (g.shape[2] == w.shape[2] + 1
                      and torch.equal(g[:, :, :-1], w.to(bf16))
                      and not g[:, :, -1].any())
            elif net == "unet" and k.endswith(".kernel") and target in lora:
                ab = lora[target]
                plain = (w.float() + (ab["A"].float() @ ab["B"].float())
                         * eff).to(bf16)
                ok, merged = torch.equal(g, plain), merged + 1
            else:
                ok = g.dtype == bf16 and torch.equal(g, w.to(bf16))
            if not ok:
                wrong.append(f"{net}:{k}")
    if wrong or merged != len(lora):
        raise AssertionError(f"loaded leaves differ from the drawn ones: "
                             f"{wrong[:5]} ({len(wrong)}), {merged} of "
                             f"{len(lora)} LoRA targets merged")
    return leaves, merged


def text_edit_kwargs(size: int, steps: int):
    """The standard edit's kwargs from a text prompt and the object image
    (CLIP and DINOv2 run) instead of given embeddings."""
    from blobctrl_torch.utils import benchkit
    kw = benchkit.standard_edit_kwargs(size, steps)
    for k in ("prompt_embeds", "negative_prompt_embeds", "fg_dino_feats"):
        del kw[k]
    kw["prompt"] = PROMPT
    return kw


def checkpoint_requests(size: int):
    """The standard edit's kwargs from a text prompt and the object image,
    under each sampler and option of this slice."""
    from blobctrl_torch.schedulers import common
    base = text_edit_kwargs(size, STEPS)
    first = dict(base, scheduler="dpm_karras", num_inference_steps=25)
    sde = dict(base, scheduler="dpm_sde_karras", num_inference_steps=25,
               seed=11)
    trailing = [int(t) for t in common.make_timesteps(20,
                                                      spacing="trailing")]
    # the repeat comes before the LoRA rescale, which moves the UNet's
    # weights by a bf16 rounding
    return [("dpm_karras, 25 steps", first),
            ("dpm_karras repeat (conditioning memo)", dict(first)),
            ("dpm_sde_karras, 25 steps, seed 11", sde),
            ("dpm_sde_karras again, seed 11", dict(sde)),
            ("ddim, eta 0.5, 50 steps", dict(base, scheduler="ddim", eta=0.5,
                                             seed=12)),
            ("unipc, 20 trailing timesteps", dict(base, timesteps=trailing)),
            ("unipc 20 steps, LoRA scale 0.5", dict(
                base, num_inference_steps=20,
                cross_attention_kwargs={"scale": 0.5})),
            ("unipc 20 steps, LoRA scale back to 1.0", dict(
                base, num_inference_steps=20,
                cross_attention_kwargs={"scale": 1.0})),
            ("unipc, encoder cache interval 3", dict(
                base, encoder_cache_interval=3)),
            ("unipc, guidance interval (0.0, 0.6)", dict(
                base, cfg_guidance_start=0.0, cfg_guidance_end=0.6)),
            ("unipc, callback every 10 steps, latents out", dict(
                base, callback_interval=10, output_type="latent"))]


def lora_reverted(loaded, half, now, lora) -> float:
    """The UNet's LoRA targets after 1 -> 0.5 -> 1.0 against the loaded
    ones, in bf16 ulps (2^-7 of the largest magnitude the leaf took on the
    way): each rescale adds the rounded increment, and W - d + d rounds
    twice, so the round trip lands within one ulp; -> the largest ratio.
    Every other leaf must be the loaded tensor itself."""
    from blobctrl_torch.params import export
    trees = [export.flatten(t) for t in (loaded, half, now)]
    worst = 0.0
    for k, w in trees[0].items():
        target = k.rsplit(".", 1)[0].replace(".", "/")
        if not (k.endswith(".kernel") and target in lora):
            if trees[2][k] is not w:
                raise AssertionError(f"{k}: a non-target leaf was replaced")
            continue
        w, w1, g = (t[k].float() for t in trees)
        ulp = torch.clamp(torch.maximum(torch.maximum(w.abs(), w1.abs()),
                                        g.abs()), min=1e-30) * 2.0 ** -7
        worst = max(worst, float(((g - w).abs() / ulp).max()))
    return worst


def checkpoint_phase(root: str, device="cuda", size: int = 512):
    """Phase 6 (``device`` and ``size`` let it be rehearsed on the CPU at a
    small size); -> (per-request records, the loaded pipeline). The models
    root is written into the directory ``root``, which the caller owns."""
    from blobctrl_torch import ops
    from blobctrl_torch.models import vae
    from blobctrl_torch.params import export, io
    from blobctrl_torch.utils import benchkit
    cfgs = reference_configs()
    trees, lora = draw_reference_trees(cfgs, 7, device)
    t0 = time.perf_counter()
    nbytes = export.write_models_root(
        root, unet=trees["unet"], unet_cfg=cfgs["unet"],
        blobnet=trees["blobnet"], blobnet_cfg=cfgs["blobnet"],
        vae=trees["vae"], vae_cfg=cfgs["vae"], clip=trees["clip"],
        clip_cfg=cfgs["clip"], dino=trees["dino"], dino_cfg=cfgs["dino"],
        lora=lora, lora_alpha=LORA_ALPHA,
        tokenizer=benchkit.byte_level_tokenizer(),
        float_dtype=torch.float16)
    secs = time.perf_counter() - t0
    gib = nbytes / 2 ** 30
    log(f"  wrote {nbytes} bytes of fp16 safetensors ({gib:.2f} GiB) in "
        f"{secs:.2f} s ({gib / secs:.2f} GiB/s)")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    pipe, secs = timed(lambda: io.load_pipeline(
        root, dtype=torch.bfloat16, device=device))
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device != "cpu" else float("nan"))
    log(f"  load_pipeline(bf16): {secs:.2f} s ({gib / secs:.2f} GiB/s of "
        f"file), peak device memory {peak:.2f} GiB "
        f"(the drawn fp16 trees included)")
    leaves, merged = check_loaded(pipe, trees, lora)
    log(f"  {leaves} leaves bit-equal to the drawn ones in bf16, {merged} "
        f"LoRA targets bit-equal to the fp32 merge then the cast; conv_in "
        f"widened 4 -> 5")
    del trees
    if device != "cpu":
        torch.cuda.empty_cache()
    loaded_unet = pipe.unet_params
    encodes = []
    real_encode = vae.encode_to_scaled_latents

    def counting_encode(*args, **kwargs):
        encodes.append(1)
        return real_encode(*args, **kwargs)
    vae.encode_to_scaled_latents = counting_encode
    records, outputs = [], {}
    try:
        for label, kw in checkpoint_requests(size):
            fired = []
            if kw.get("output_type") == "latent":
                kw = dict(kw, callback_on_step_end=lambda p, i, t, x:
                          fired.append((i, t, x["latents"].shape)))
            before = len(encodes)
            ops.reset_counts()
            if device != "cpu":
                torch.cuda.reset_peak_memory_stats()
            res, secs = timed(lambda: pipe(**kw))
            counts, tc = launch_counts(), tensor_core_counts()
            peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                    if device != "cpu" else float("nan"))
            out = res.images
            outputs[label] = out
            ran = {k: n for k, n in counts.items() if n}
            rec = dict(label=label, secs=secs, flash=counts["flash_attention"],
                       conv3x3=counts["conv3x3"],
                       tc=(tc["flash_attention"], tc["conv3x3"]),
                       encodes=len(encodes) - before, peak=peak)
            records.append(rec)
            log(f"  {label}: {secs:.3f} s, flash {rec['flash']} and conv3x3 "
                f"{rec['conv3x3']} launches ({rec['tc'][0]} and {rec['tc'][1]}"
                f" on the tensor cores), VAE encodes {rec['encodes']}, peak "
                f"memory {peak:.2f} GiB" + (f", callbacks at steps "
                                            f"{[i for i, _, _ in fired]}"
                                            if fired else ""))
            want_shape = ((1, size // 8, size // 8, 4) if fired
                          else (1, size, size, 3))
            if out.shape != want_shape or not np.isfinite(out).all():
                raise AssertionError(f"{label}: bad output {out.shape}")
            if (min(rec["flash"], rec["conv3x3"]) == 0
                    or rec["tc"] != (rec["flash"], rec["conv3x3"])
                    or set(ran) - set(EXACT)):
                raise AssertionError(f"{label}: launches {ran}, tensor-core "
                                     f"{rec['tc']}")
            if rec["encodes"] != (1 if not records[:-1] else 0):
                raise AssertionError(f"{label}: {rec['encodes']} VAE encodes")
            if fired and ([i for i, _, _ in fired] != [0, 10, 20, 30, 40, 49]
                          or fired[0][2] != want_shape):
                raise AssertionError(f"{label}: callbacks {fired}")
            if label.endswith("LoRA scale 0.5"):
                half_unet = pipe.unet_params
            if label.endswith("back to 1.0"):
                worst = lora_reverted(loaded_unet, half_unet,
                                      pipe.unet_params, lora)
                log(f"  the UNet's LoRA targets after 1 -> 0.5 -> 1.0: "
                    f"within {worst:.3f} bf16 ulp of the loaded ones")
                if worst > 1.0:
                    raise AssertionError(f"LoRA scale round trip: {worst} "
                                         f"ulp")
    finally:
        vae.encode_to_scaled_latents = real_encode
    labels = [r["label"] for r in records]
    same = {"repeat": np.array_equal(outputs[labels[0]], outputs[labels[1]]),
            "sde": np.array_equal(outputs[labels[2]], outputs[labels[3]])}
    log(f"  dpm_sde_karras twice with one seed bit-equal: {same['sde']}; the "
        f"repeat's image equals the first's: {same['repeat']}")
    if not all(same.values()):
        raise AssertionError(f"not reproducible: {same}")
    return records, pipe


# ---------------------------------------------------------------------------
# phase 7: serving (edit_batch, the HTTP server), a traced edit, int8 linears
# ---------------------------------------------------------------------------

SERVE_PROMPTS = ("a red ball on a table", "a blue cup on a desk",
                 "a green hat on a chair", "a yellow lamp by a window")
SERVE_SHARED = dict(guidance_scale=7.5, blobnet_conditioning_scale=1.6,
                    blobnet_control_guidance_end=0.9)
BATCH_SIZES = (1, 2, 4)
TRACE_STEPS = 20
# the traced edit's kernels by kind: (kind, regex on the kernel's name; None:
# the hand-written kernels), first match wins
TRACE_KINDS = (("hand-written", None),
               ("reductions (norm statistics)", r"reduce_kernel"),
               ("cuDNN convs", r"fprop|onvolve|cudnn|nhwc"),
               ("cuBLAS GEMMs", r"nvjet|gemm|Kernel2<cutlass"),
               ("copies and casts", r"copy|Memcpy|Memset|CatArray"),
               ("elementwise", r"elementwise"))


def serving_requests(size: int, n: int, text: bool = True):
    """n distinct edit_batch requests: own images, ellipse and seed, and a
    text prompt (phase 7's loaded pipeline has CLIP and DINOv2) or the
    embeddings (phase 2's pipeline has neither)."""
    from blobctrl_torch.utils import benchkit
    keep = ("fg_image", "bg_image", "gs_score") + (
        () if text else ("prompt_embeds", "negative_prompt_embeds",
                         "fg_dino_feats"))
    reqs = []
    for b in range(n):
        kw = benchkit.make_edit_inputs(size, seed=20 + b, ellipse=(
            (size * (0.4 + 0.06 * b), size * 0.5),
            (size * 0.25, size * 0.38), 25.0 * b))
        req = {k: kw[k] for k in keep}
        if text:
            req["prompt"] = SERVE_PROMPTS[b % len(SERVE_PROMPTS)]
        req["seed"] = 20 + b
        reqs.append(req)
    return reqs


def record_batch_shapes(pipe):
    """Phase 2's part of phase 7: one-step edit_batch runs at B = 2 and 4
    (exact), so that phase 2 checks every kernel shape phase 7 launches."""
    for n in BATCH_SIZES[1:]:
        pipe.edit_batch(serving_requests(512, n, text=False), height=512,
                        width=512, num_inference_steps=1,
                        **dict(SERVE_SHARED, blobnet_control_guidance_end=1.0))


def hand_kernel_names():
    """The __global__ functions of blobctrl_torch/csrc, as the profiler
    names the hand-written kernels."""
    import glob
    import re
    names = set()
    for path in glob.glob(os.path.join(ROOT, "blobctrl_torch", "csrc",
                                       "*.cu*")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", f.read()))
    return names


def batch_scaling(pipe, size, steps, tally):
    """edit_batch at each B of BATCH_SIZES (distinct requests), warm; ->
    ({B: images}, [solo images]). ``tally`` banks the counters and zeroes
    them."""
    reqs = serving_requests(size, max(BATCH_SIZES))
    shared = dict(SERVE_SHARED, height=size, width=size)
    for n in BATCH_SIZES:  # warm: allocator, library heuristics, memos
        pipe.edit_batch(reqs[:n], num_inference_steps=2, **shared)
    out = {}
    for n in BATCH_SIZES:
        tally()
        torch.cuda.reset_peak_memory_stats()
        res, secs = timed(lambda: pipe.edit_batch(
            reqs[:n], num_inference_steps=steps, **shared))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  edit_batch B={n}, {steps} steps: {secs:.3f} s a batch, "
            f"{secs / n:.3f} s an image, peak memory {peak:.2f} GiB, "
            f"flash {counts['flash_attention']} and conv3x3 "
            f"{counts['conv3x3']} launches")
        check_tensor_cores(f"edit_batch B={n}", counts, EXACT)
        ran = {k: v for k, v in counts.items() if v}
        if (set(ran) != set(EXACT) or res.images.shape != (n, size, size, 3)
                or not np.isfinite(res.images).all()
                or res.nsfw_content_detected is not None):
            raise AssertionError(f"edit_batch B={n}: launches {ran}, "
                                 f"output {res.images.shape}")
        out[n] = res.images
    solo = []
    for b, req in enumerate(reqs):
        res, secs = timed(lambda: pipe(**req, num_inference_steps=steps,
                                       **shared))
        solo.append(res.images)
        log(f"  solo __call__ of request {b}: {secs:.3f} s; PSNR of its "
            f"row in the B={max(BATCH_SIZES)} batch against it "
            f"{psnr(out[max(BATCH_SIZES)][b:b + 1], res.images):.2f} dB "
            f"(bf16, for information)")
    return out, solo


def toy_batch_against_solo():
    """The trained toy 256^2 checkpoint in fp32 on the card: three
    requests batched, each row against its solo edit, >= 40 dB."""
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.train import toy
    card, _ = toy.load_toy(os.path.join(ROOT, "assets", "toy_ckpt_256"),
                           device="cuda", dtype=torch.float32)
    move = toy_edits(256, 20)["move"]
    shared = {k: move[k] for k in ("height", "width", "num_inference_steps",
                                   "guidance_scale")}
    reqs = []
    for b in range(3):
        dst = ((256 * (0.55 + 0.05 * b), 256 * 0.55), (77.0, 102.0),
               20.0 + 30 * b)
        reqs.append(dict(
            {k: move[k] for k in ("fg_image", "bg_image", "prompt_embeds",
                                  "negative_prompt_embeds",
                                  "fg_dino_feats")},
            gs_score=blob_math.blob_score_from_ellipse(
                dst, 256, 256, (32, 32)).numpy(), seed=30 + b))
    batch = card.edit_batch(reqs, **shared).images
    for b, req in enumerate(reqs):
        p = psnr(batch[b:b + 1], card(**req, **shared).images)
        log(f"  toy 256^2 fp32 edit_batch row {b} against its solo edit: "
            f"{p:.2f} dB")
        if not p >= 40.0:
            raise AssertionError(f"toy batched row {b}: {p} dB")
    del card


def _http(url, payload=None, timeout=900):
    """-> (status, body bytes) of a GET, or of a POST of ``payload``."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data, {"Content-Type":
                                             "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def server_phase(pipe, size, steps, batched):
    """``apps.server.serve`` on the card (max_batch=4, preview_every=10,
    warmup at ``steps``): warmup seconds until /healthz is 200, a solo
    request from a text prompt, an ellipse and PNG images, four concurrent
    requests (one batch of 4), a remove request, a preview request with
    /v1/progress seen mid-edit, a 400 for a cold shape."""
    import base64
    from blobctrl_torch.apps import server
    from blobctrl_torch.utils import png
    reqs = serving_requests(size, 4)

    def payload(b, **extra):
        r = reqs[b]
        (cx, cy), (d1, d2), ang = ((size * (0.4 + 0.06 * b), size * 0.5),
                                   (size * 0.25, size * 0.38), 25.0 * b)
        return dict({"prompt": r["prompt"], "seed": r["seed"], "size": size,
                     "num_inference_steps": steps,
                     "guidance_scale": SERVE_SHARED["guidance_scale"],
                     "blobnet_conditioning_scale":
                         SERVE_SHARED["blobnet_conditioning_scale"],
                     "blobnet_control_guidance_end":
                         SERVE_SHARED["blobnet_control_guidance_end"],
                     "ellipse": [cx, cy, d1, d2, ang],
                     "fg_image": base64.b64encode(png.encode_png(
                         r["fg_image"])).decode(),
                     "bg_image": base64.b64encode(png.encode_png(
                         r["bg_image"])).decode()}, **extra)

    def images(body):
        resp = json.loads(body)
        return resp, np.stack([png.decode_png(base64.b64decode(b)).astype(
            np.float32) / 255.0 for b in resp["images"]])

    service, httpd = server.serve(pipe, host="127.0.0.1", port=0, size=size,
                                  warmup_steps=steps, max_batch=4,
                                  batch_window_ms=1500.0, preview_every=10)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    from blobctrl_torch.utils import observability
    http_log = observability.logger
    level = http_log.level
    http_log.setLevel(logging.WARNING)  # a line per request otherwise
    try:
        t0 = time.perf_counter()
        while _http(base + "/healthz")[0] != 200:
            if time.perf_counter() - t0 > 600:
                raise AssertionError("warmup did not finish in 600 s")
            time.sleep(0.25)
        log(f"  server warmup ({steps} steps: standard, preview, remove, "
            f"batches of 2 and 4): {time.perf_counter() - t0:.2f} s until "
            f"/healthz is 200")
        code, body = _http(base + "/v1/info")
        info = json.loads(body)
        log(f"  /v1/info: device {info['device']}, warm_steps "
            f"{info['warm_steps']}, max_batch {info['max_batch']}")
        if code != 200 or info["device"] != torch.cuda.get_device_name():
            raise AssertionError(f"info {code} {info}")
        t0 = time.perf_counter()
        code, body = _http(base + "/v1/edit", payload(0))
        wall = time.perf_counter() - t0
        resp, img = images(body)
        log(f"  solo request (text prompt, ellipse, PNG images): {code}, "
            f"server {resp['seconds']:.3f} s (batch of "
            f"{resp.get('batch_size')}), client {wall:.3f} s with the "
            f"1.5 s batch window")
        if code != 200 or img.shape != (1, size, size, 3):
            raise AssertionError(f"solo request {code}")
        results = [None] * 4

        def worker(b):
            t = time.perf_counter()
            c, bd = _http(base + "/v1/edit", payload(b))
            results[b] = (c, bd, time.perf_counter() - t)
        threads = [threading.Thread(target=worker, args=(b,))
                   for b in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for b, (c, bd, wall) in enumerate(results):
            resp, img = images(bd) if c == 200 else (json.loads(bd), None)
            if c != 200 or resp.get("batch_size") != 4:
                raise AssertionError(f"concurrent request {b}: {c} {resp}")
            log(f"  concurrent request {b}: batch of {resp['batch_size']}, "
                f"server {resp['seconds']:.3f} s, client {wall:.3f} s, "
                f"PSNR against edit_batch B=4 in this phase "
                f"{psnr(img, batched[b:b + 1]):.2f} dB")
        if service.batches_run != 2:   # the solo request's, and this one
            raise AssertionError(f"batches run {service.batches_run}")
        jpeg_requests(base, payload, images, size)
        decode_repair(pipe, base, service, size, steps)
        rm = payload(1, remove=True)
        del rm["ellipse"]
        code, body = _http(base + "/v1/edit", rm)
        resp, img = images(body)
        log(f"  remove request: {code}, {resp['seconds']:.3f} s")
        if code != 200 or "batch_size" in resp or not np.isfinite(img).all():
            raise AssertionError(f"remove request {code}")
        seen, done = [], threading.Event()

        def poll():
            while not done.is_set():
                prog = json.loads(_http(base + "/v1/progress")[1])
                if prog["active"] and prog["step"]:
                    seen.append(prog["step"])
                time.sleep(0.05)
        poller = threading.Thread(target=poll)
        poller.start()
        try:
            code, body = _http(base + "/v1/edit", payload(2, preview=True))
        finally:
            done.set()
            poller.join()
        resp, img = images(body)
        log(f"  preview request: {code}, {resp['seconds']:.3f} s, previews "
            f"at steps {resp['preview_steps']}, /v1/progress saw steps "
            f"{sorted(set(seen))}")
        every = [i for i in range(steps) if i % 10 == 0 or i == steps - 1]
        if code != 200 or resp["preview_steps"] != every or not seen:
            raise AssertionError(f"preview request {code} {seen}")
        code, body = _http(base + "/v1/edit", payload(3, size=size // 2))
        log(f"  cold shape (size {size // 2}): {code} "
            f"{json.loads(body)['error'][:60]!r}")
        if code != 400:
            raise AssertionError(f"cold shape answered {code}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        http_log.setLevel(level)


def jpeg_requests(base, payload, images, size):
    """A solo request whose fg_image and bg_image are the 512^2 JPEG
    fixture's bytes against the same request with the PNG of the same
    pixels (PIL's decode, committed beside it): the same image back; a
    truncated JPEG: 400. Each request's launches are the counters'
    differences around it (no reset: phase 7's tally and its "server"
    check keep them): K1 and K6 only, on the tensor cores."""
    import base64
    if size != 512:
        return
    with open(os.path.join(JPEG_FIXTURES, JPEG_PHOTO + ".jpg"), "rb") as f:
        jpg = f.read()
    with open(os.path.join(JPEG_FIXTURES, JPEG_PHOTO + ".png"), "rb") as f:
        pngb = f.read()
    out = {}
    for kind, data in (("JPEG", jpg), ("PNG", pngb)):
        b64 = base64.b64encode(data).decode()
        before, tc_before = launch_counts(), tensor_core_counts()
        t0 = time.perf_counter()
        code, body = _http(base + "/v1/edit", payload(0, fg_image=b64,
                                                      bg_image=b64))
        wall = time.perf_counter() - t0
        totals = {k: n - before[k] for k, n in launch_counts().items()}
        tc = {k: n - tc_before[k] for k, n in tensor_core_counts().items()}
        resp, out[kind] = images(body) if code == 200 else (
            json.loads(body), None)
        log(f"  solo request from the {kind} fixture ({len(data)} bytes): "
            f"{code}, server {resp.get('seconds', 0):.3f} s, client "
            f"{wall:.3f} s, launches "
            f"{ {k: n for k, n in totals.items() if n} }")
        if code != 200 or min(totals[k] for k in EXACT) == 0 or any(
                n for k, n in totals.items() if k not in EXACT):
            raise AssertionError(f"{kind} request {code} {totals}")
        check_tensor_cores(f"{kind} request", totals, EXACT, tc)
    if not np.array_equal(out["JPEG"], out["PNG"]):
        raise AssertionError("the JPEG request's edit differs from the "
                             "PNG request's")
    log("  the JPEG request's image equals the PNG request's")
    bad = base64.b64encode(jpg[:len(jpg) // 2]).decode()
    code, body = _http(base + "/v1/edit", payload(0, fg_image=bad))
    log(f"  truncated JPEG: {code} {json.loads(body)['error'][:70]!r}")
    if code != 400:
        raise AssertionError(f"truncated JPEG answered {code}")


def decode_repair(pipe, base, service, size, steps):
    """Request images decode outside the handler thread: a
    ``steps``-step edit alone, then the same edit with, from its fifth
    step on, a request whose fg_image and bg_image are both the 12 MP
    textured JPEG (no blob, so the server answers 400 after decoding and
    runs no edit). The handler thread's CPU seconds for the decode
    (``EditService.last_decode``, ``time.thread_time``) must stay below
    0.1 s; the edit's per-step times (``callback_on_step_end`` stamps)
    alone and during the decode are printed for information."""
    import base64
    with open(JPEG_TIMING, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    req = {"fg_image": b64, "bg_image": b64, "size": size,
           "num_inference_steps": steps}
    kw = text_edit_kwargs(size, steps)

    def edit(stamps, go=None):
        def cb(_p, i, _t, _x):
            stamps.append(time.perf_counter())
            if go is not None and i == 4:
                go.set()
        pipe(**kw, callback_on_step_end=cb)
    alone = []
    edit(alone)
    during, go = [], threading.Event()
    th = threading.Thread(target=edit, args=(during, go))
    th.start()
    if not go.wait(600):
        raise AssertionError("the edit did not reach its fifth step")
    service.last_decode = None
    t0 = time.perf_counter()
    code, body = _http(base + "/v1/edit", req)
    t1 = time.perf_counter()
    th.join(600)
    if th.is_alive() or len(during) != steps or len(alone) != steps:
        raise AssertionError("the timed edits did not finish")
    error = json.loads(body).get("error", "")
    if code != 400 or "ellipse" not in error or service.last_decode is None:
        raise AssertionError(f"the 12 MP request was not decoded: {code} "
                             f"{error[:80]!r}")
    cpu_s, wall_s = service.last_decode
    step_alone = np.diff(alone) * 1e3
    step_during = np.asarray([1e3 * (b - a) for a, b in zip(during, during[1:])
                              if a >= t0 and b <= t1])
    log(f"  12 MP JPEG request (fg and bg, {len(b64)} base64 bytes each) "
        f"during a {steps}-step edit: {code} {error[:50]!r} after "
        f"{t1 - t0:.3f} s; decode "
        f"{wall_s:.3f} s wall in the worker processes, the handler "
        f"thread's CPU {cpu_s:.4f} s (bar 0.1 s)")
    log(f"  the edit's step: alone median {np.median(step_alone):.2f} ms "
        f"(min {step_alone.min():.2f}, max {step_alone.max():.2f}); during "
        f"the decode median "
        + (f"{np.median(step_during):.2f} ms over {len(step_during)} steps "
           f"(max {step_during.max():.2f})" if len(step_during) else
           "(no whole step inside the decode)")
        + f"; decoder start-up in the warmup {service.decoder_start_s:.2f} s")
    if cpu_s >= 0.1:
        raise AssertionError(f"decode repair: the handler thread's CPU "
                             f"{cpu_s} s")


# ---------------------------------------------------------------------------
# after phase 7: the checkpoint-day dry run on phase 6's models root
# ---------------------------------------------------------------------------

CKPT_DAY_STEPS = 10
DEMO_STATES = ["move_tracked", "remove_tracked"]  # written by phase 5


def checkpoint_day_phase(models_root: str, demo_root: str):
    """``apps/checkpoint_day.run_checkpoint_day`` at full width, bf16, on
    phase 6's models root over the demo states phase 5 wrote, at
    CKPT_DAY_STEPS steps and one sample: every stage ``ok``; counters
    zeroed before each scoring stage and read after it: the int8 stages
    launch K5 and K8, the others K1 and K6, every launch on the tensor
    cores."""
    from blobctrl_torch import ops
    from blobctrl_torch.apps import checkpoint_day, replay
    from blobctrl_torch.ops import conv3x3
    real = replay.score_all
    per_stage = []

    def counted(*args, **kwargs):
        ops.reset_counts()
        rows = real(*args, **kwargs)
        torch.cuda.synchronize()
        per_stage.append((conv3x3.conv_int8_enabled(), launch_counts(),
                          tensor_core_counts()))
        return rows
    replay.score_all = counted
    try:
        report = checkpoint_day.run_checkpoint_day(
            models_root=models_root, demo_root=demo_root,
            steps=CKPT_DAY_STEPS, num_samples=1, names=DEMO_STATES)
    finally:
        replay.score_all = real
    for row in report["stages"]:
        p, d = row.get("mean_psnr_db"), row.get("psnr_drop_db")
        log(f"  {row['stage']}: ok {row['ok']}, {row['seconds']:.2f} s"
            + (f", mean PSNR {p:.2f} dB" if p is not None else "")
            + (f", drop {d:+.2f} dB" if d is not None else "")
            + (f", {row['total_params']} parameters"
               if "total_params" in row else "")
            + (f", {row['bit_exact']} of {row['artifacts']} UI artifacts "
               f"bit-exact" if "artifacts" in row else "")
            + (f", error {row['error']}" if "error" in row else ""))
    log(f"  gates (random weights; for information): {report['gates']}")
    names = [r["stage"] for r in report["stages"]]
    want = ["download", "load", "ui_goldens", "exact",
            *checkpoint_day.FAST_MODES]
    if names != want or not all(r["ok"] for r in report["stages"]):
        raise AssertionError(f"checkpoint day: stages {names}, not all ok")
    ui = report["stages"][2]
    if ui["artifacts"] < 2 or ui["bit_exact"] != ui["artifacts"]:
        raise AssertionError(f"checkpoint day UI goldens: {ui}")
    if len(per_stage) != 5:
        raise AssertionError(f"{len(per_stage)} scoring stages counted")
    for row in report["stages"][3:]:
        if [r["name"] for r in row["rows"]] != DEMO_STATES or not all(
                np.isfinite(r["psnr_db"]) for r in row["rows"]):
            raise AssertionError(f"checkpoint day {row['stage']}: rows "
                                 f"{row['rows']}")
    for stage, (int8, totals, tc) in zip(want[3:], per_stage):
        names = INT8 if stage.startswith("int8") else EXACT
        log(f"  {stage}: launches {({k: n for k, n in totals.items() if n})}"
            f", tensor-core {({k: tc[k] for k in names if k in tc})}")
        if int8 != stage.startswith("int8") or min(
                totals[k] for k in names) == 0 or any(
                n for k, n in totals.items() if k not in names) or any(
                tc[k] != totals[k] for k in names if k in tc):
            raise AssertionError(f"checkpoint day {stage}: launches "
                                 f"{totals}, tensor-core {tc}")
    json.dumps(report)


def traced_edit(pipe, size):
    """One TRACE_STEPS-step solo edit under ``torch.profiler``: the top
    device kernels, and the hand-written kernels' share of device time."""
    import re
    from blobctrl_torch.utils import observability
    kw = dict(serving_requests(size, 1)[0], height=size, width=size,
              num_inference_steps=TRACE_STEPS, **SERVE_SHARED)
    ops_ms = observability.profile_op_breakdown(lambda: pipe(**kw),
                                                repeats=1, top_k=100000)
    _, wall = timed(lambda: pipe(**kw))
    # the profiler names them e.g. "void (anonymous namespace)::
    # conv3x3_kernel_tc<true>(...)"
    pat = re.compile(r"(^|[\s:])(" + "|".join(sorted(hand_kernel_names()))
                     + r")[<(]")
    total = sum(ops_ms.values())
    hand = sum(v for k, v in ops_ms.items() if pat.search(k))
    log(f"  traced {TRACE_STEPS}-step edit: device time {total:.1f} ms over "
        f"{len(ops_ms)} kernels; the same edit untraced {1e3 * wall:.1f} ms "
        f"wall, so the device is busy {100 * total / (1e3 * wall):.1f} % of "
        f"it; hand-written kernels {hand:.1f} ms "
        f"({100 * hand / total:.1f} % of device time), plain torch "
        f"{total - hand:.1f} ms ({100 * (total - hand) / total:.1f} %)")
    for name, ms in list(ops_ms.items())[:15]:
        log(f"    {ms:9.2f} ms  {'hand ' if pat.search(name) else 'torch'} "
            f"{name[:90]}")
    kinds = collections.Counter()
    for name, ms in ops_ms.items():
        kinds[next((kind for kind, rx in TRACE_KINDS
                    if (pat if rx is None else re.compile(rx)).search(name)),
                   "other")] += ms
    log("  device time by kind: " + ", ".join(
        f"{kind} {ms:.1f} ms ({100 * ms / total:.1f} %)"
        for kind, ms in kinds.most_common()))
    if not hand > 0:
        raise AssertionError("the trace shows no hand-written kernel")


def int8_linear_edit(pipe, size, steps, exact, tally):
    """One edit in the int8-everything mode without and with the int8
    linear path; PSNR against the exact edit and between the two."""
    from blobctrl_torch.nn import layers
    from blobctrl_torch.ops import conv3x3
    from blobctrl_torch.utils import benchkit
    # the card's int32 products against the CPU's exact fp64 ones
    gen = torch.Generator().manual_seed(9)
    for m, k, n in ((8192, 320, 960), (154, 768, 320), (8, 1280, 1280)):
        x = torch.randn(m, k, generator=gen) * 4
        w = torch.randn(k, n, generator=gen) / k ** 0.5
        kq, ws = conv3x3.quantize_kernel_i8(w)
        want = layers.matmul_i8(x, kq, ws, None, torch.float32)
        got = layers.matmul_i8(x.cuda(), kq.cuda(), ws.cuda(), None,
                               torch.float32).cpu()
        route = ("torch._int_mm" if layers._int_mm_ok(m, k, n, torch.device(
            "cuda")) else "fp64 product")
        log(f"  matmul_i8 ({m}, {k}) x ({k}, {n}) on the card ({route}) "
            f"against the CPU: bit-equal {torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise AssertionError(f"matmul_i8 at {(m, k, n)} differs")
    kw = dict(serving_requests(size, 1)[0], height=size, width=size,
              num_inference_steps=steps, **SERVE_SHARED)
    outs = {}
    for label, linear in (("int8-everything", False),
                          ("int8-everything + int8 linears", True)):
        pipe._param_cache.clear()
        tally()
        with benchkit.int8_everything():
            layers.set_linear_int8(linear)
            try:
                res, secs = timed(lambda: pipe(**kw))
            finally:
                layers.set_linear_int8(False)
        counts = launch_counts()
        check_tensor_cores(label, counts, INT8)
        outs[label] = res.images
        log(f"  {label}: {secs:.3f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }, PSNR against the "
            f"exact edit {psnr(res.images, exact):.2f} dB")
        if min(counts[k] for k in INT8) == 0 or not np.isfinite(
                res.images).all():
            raise AssertionError(f"{label}: launches {counts}")
    pipe._param_cache.clear()
    log(f"  int8 + int8 linears against int8 alone: "
        f"{psnr(*outs.values()):.2f} dB")


def serving_phase(pipe, size: int = 512, steps: int = STEPS):
    """Phase 7 on phase 6's loaded pipeline; -> ({kernel: {shape:
    launches}}, {kernel: launches}) over the whole phase."""
    from blobctrl_torch import ops
    totals = collections.Counter()
    shapes = {}

    def tally():
        for name, n in launch_counts().items():
            totals[name] += n
        for name, per in launch_shapes().items():
            for key, n in per.items():
                shapes.setdefault(name, {}).setdefault(key, 0)
                shapes[name][key] += n
        ops.reset_counts()

    ops.reset_counts()
    log("  7.1 batch scaling")
    batched, solo = batch_scaling(pipe, size, steps, tally)
    tally()
    log("  7.2 batched against solo, toy 256^2 fp32 on the card")
    toy_batch_against_solo()
    # the toy's fp32 launches are off the main path: held batch against solo
    # only, not against the plain versions
    ops.reset_counts()
    log("  7.3 (phase 2 checked every kernel shape of this phase)")
    log("  7.4 the HTTP server")
    server_phase(pipe, size, steps, batched[max(BATCH_SIZES)])
    check_tensor_cores("server", launch_counts(), EXACT)
    tally()
    log("  7.5 one traced edit")
    traced_edit(pipe, size)
    tally()
    log("  7.6 the int8 linear path")
    int8_linear_edit(pipe, size, steps, solo[0], tally)
    tally()
    return shapes, dict(totals)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from blobctrl_torch import ops
    from blobctrl_torch.ops import _build, conv3x3, winograd
    from blobctrl_torch.utils import benchkit

    # -- phase 1 ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    global EXP_RATE
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_RATE = sms * EXP_PER_SM_CLOCK * clock_mhz * 1e6
    log(f"  {sms} SMs at up to {clock_mhz:.0f} MHz: {EXP_RATE:.3e} "
        f"exponentials/s")
    log(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}"
        f", cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  kernel build {time.perf_counter() - t0:.2f} s")
    jpeg_phase()
    torch.backends.cudnn.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 2 ------------------------------------------------------------
    log("phase 2: kernels against their plain versions at the 512^2 shapes")
    pipe = benchkit.make_flagship_pipe(seed=0, device="cuda",
                                       dtype=torch.bfloat16)
    # one step, inside the control window, so BlobNet runs too
    one_step = dict(benchkit.standard_edit_kwargs(512, 1),
                    blobnet_control_guidance_end=1.0)
    ops.reset_counts()
    for mode in MODES:
        with mode_context(mode):
            pipe(**one_step)
    torch.cuda.synchronize()
    pipe._param_cache.clear()  # the int8 and Winograd weight copies
    shapes = {name: set(keys) for name, keys in launch_shapes().items()}
    log("  recorded shapes from a one-step edit, exact, int8 and fused: "
        + ", ".join(f"{name} {len(keys)}" for name, keys in shapes.items()))
    ops.reset_counts()
    record_batch_shapes(pipe)
    batch_shapes = {name: set(launch_shapes()[name]) - shapes[name]
                    for name in EXACT}
    log(f"  and from one-step edit_batch runs at B = "
        f"{', '.join(map(str, BATCH_SIZES[1:]))} (phase 7's), shapes not "
        f"above: " + ", ".join(f"{name} {len(keys)}"
                               for name, keys in batch_shapes.items()))
    results = check_kernels(shapes)
    log("  phase 7's batched shapes, checked without timing:")
    for name, rows in check_kernels(batch_shapes, timing=False).items():
        results[name].update(rows)
    results["blob_splat"], splat_calls = check_splat()

    # -- phase 3 ------------------------------------------------------------
    log("phase 3: trained toy checkpoint, card against CPU")
    toy_phase()

    # -- phase 4 ------------------------------------------------------------
    log(f"phase 4: full width, bf16, {STEPS} steps per request")
    requests = full_width_requests(STEPS)
    ops.reset_counts()
    for name, kw in requests:
        out, secs, launches, mem = run_request(pipe, kw)
        if name == "edit":
            exact_edit = out
        log(f"  {name}: {secs:.3f} s, launches {launches}, peak memory "
            f"{mem:.2f} GiB")
    counts, totals = launch_shapes(), launch_counts()
    check_tensor_cores("exact requests", totals, EXACT)
    path_totals = {"exact": dict(totals)}
    for mode, derive in (("int8", lambda t: conv3x3.quantize_conv_tree(t)),
                         ("fused", lambda t: winograd.transform_conv_tree(
                             t, pipe.dtype))):
        t0 = time.perf_counter()
        for tree in (pipe.unet_params, pipe.blobnet_params, pipe.vae_params):
            derive(tree)
        torch.cuda.synchronize()
        log(f"  {mode}: deriving its weights of the UNet, BlobNet and VAE "
            f"alone takes {time.perf_counter() - t0:.3f} s (the request "
            f"below pays it once)")
        pipe._param_cache.clear()  # the peak holds this path's copies only
        ops.reset_counts()
        with mode_context(mode):
            out, secs, launches, mem = run_request(pipe, requests[0][1])
        if mode == "int8":
            kmajor = sum(w.numel() for _, w in conv3x3._KMAJOR.values())
            log(f"  edit, int8: K-major int8 weight copies "
                f"{kmajor / 2 ** 20:.1f} MiB ({len(conv3x3._KMAJOR)} convs), "
                f"largest int32 split workspace "
                f"{int8_workspace_mib(launch_shapes()):.1f} MiB")
        pipe._param_cache.clear()
        log(f"  edit, {mode}: {secs:.3f} s, launches {launches}, peak "
            f"memory {mem:.2f} GiB, PSNR against the exact edit "
            f"{psnr(out, exact_edit):.2f} dB (for information)")
        mode_counts, path_totals[mode] = launch_shapes(), launch_counts()
        check_tensor_cores(f"edit, {mode}", path_totals[mode], MODES[mode])
        for name in MODES[mode]:  # each kernel's counts from its own path
            counts[name] = mode_counts[name]
            totals[name] = path_totals[mode][name]
    for name, per_shape in counts.items():
        for key, n in sorted(per_shape.items(), key=repr):
            log(f"  launches {shape_label(name, key)}: {n}")
    strays = {mode: {k: n for k, n in path_totals[mode].items()
                     if n and k not in names}
              for mode, names in MODES.items()}
    if min(totals[k] for names in MODES.values() for k in names) == 0 \
            or any(strays.values()):
        raise AssertionError(f"a kernel never ran on its path, or a path ran "
                             f"another path's kernel: {totals}, {strays}")

    # -- phase 5 ------------------------------------------------------------
    log(f"phase 5: the interactive session at full width, bf16, {STEPS} "
        f"steps per run")
    benchkit.add_encoders(pipe, seed=3)
    counts["blob_splat"], totals["blob_splat"] = session_phase(pipe, STEPS)
    for key, n in counts["blob_splat"].items():
        log(f"  launches {shape_label('blob_splat', key)}: {n}")
    log("  the splat's device time (torch.profiler), phase 2's keys:")
    splat_device_times(results["blob_splat"], splat_calls)
    log(f"  the tracking-point flow from the JPEG fixture, one {STEPS}-step "
        f"run")
    # the demo states and phase 6's models root; removed when the script
    # exits, however it exits
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    demo_root = os.path.join(work.name, "demo")
    tracking_phase(pipe, STEPS, demo_root)
    models_root = os.path.join(work.name, "models_root")
    os.makedirs(models_root)
    log("  SAM: phase 6's ViT-H checkpoint (written here, where the session "
        "first needs it), then clicks through the loaded predictor")
    sam_tree = sam_checkpoint(models_root)
    sam_session_phase(pipe, sam_tree)
    del sam_tree
    torch.cuda.empty_cache()
    log(f"  the safety checker on {SAFETY_STEPS}-step edits")
    safety_phase(pipe)

    # -- phase 6 ------------------------------------------------------------
    log("phase 6: a reference-layout checkpoint at full geometry, loaded in "
        "bf16; requests at 512^2")
    del pipe
    torch.cuda.empty_cache()
    _, pipe = checkpoint_phase(models_root)

    # -- phase 7 ------------------------------------------------------------
    log(f"phase 7: serving on phase 6's loaded pipeline: edit_batch at B = "
        f"{', '.join(map(str, BATCH_SIZES))}, the HTTP server, a traced "
        f"edit, the int8 linear path")
    served_shapes, served = serving_phase(pipe)
    for name in EXACT + INT8:
        missing = set(served_shapes.get(name, ())) - set(results[name])
        if missing:
            raise AssertionError(f"{name}: phase 7 shapes not checked in "
                                 f"phase 2: {missing}")
    log(f"  phase 7 launches: {dict(served)}")
    if min(served.get(k, 0) for k in EXACT + INT8) == 0:
        raise AssertionError(f"a kernel of phase 7 never ran: {served}")
    del pipe
    torch.cuda.empty_cache()
    log(f"checkpoint day on phase 6's models root, bf16, over phase 5's two "
        f"states, {CKPT_DAY_STEPS} steps")
    checkpoint_day_phase(models_root, demo_root)

    # -- phase 8 ------------------------------------------------------------
    meta = {"flash_attention": ("blobctrl_torch/csrc/flash_attention.cu",
                                "blobctrl_tpu/ops/flash_attention.py:80"),
            "conv3x3": ("blobctrl_torch/csrc/conv3x3.cu",
                        "blobctrl_tpu/ops/conv3x3.py:176"),
            "flash_attention_int8": (
                "blobctrl_torch/csrc/flash_attention_int8.cu",
                "blobctrl_tpu/ops/flash_attention.py:179"),
            "conv3x3_int8": ("blobctrl_torch/csrc/conv3x3_int8.cu",
                             "blobctrl_tpu/ops/conv3x3.py:195"),
            "flash_attention_exp2": ("blobctrl_torch/csrc/flash_attention.cu",
                                     "blobctrl_tpu/ops/flash_attention.py:55"),
            "affine_matmul": ("blobctrl_torch/csrc/norm_matmul.cu",
                              "blobctrl_tpu/ops/gn_matmul.py:64"),
            "ln_matmul": ("blobctrl_torch/csrc/norm_matmul.cu",
                          "blobctrl_tpu/ops/ln_matmul.py:38"),
            "winograd": ("blobctrl_torch/csrc/winograd.cu",
                         "blobctrl_tpu/ops/winograd.py:85"),
            "blob_splat": ("blobctrl_torch/csrc/blob_splat.cu",
                           "blobctrl_tpu/ops/blob_splat.py:31")}
    kernels = []
    for name, (source, replaces) in meta.items():
        missing = set(counts[name]) - set(results[name])
        if missing:
            raise AssertionError(f"{name}: shapes not checked {missing}")

        def weighted(field):
            vals = [results[name][k][field] for k in counts[name]]
            if any(v is None for v in vals):
                return None
            return sum(results[name][k][field] * n
                       for k, n in counts[name].items())
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": totals[name],
                 "served_launches": served.get(name, 0),
                 "max_abs_err": max(r["max_abs_err"]
                                    for r in results[name].values())}
        for field in ("ms", "plain_ms", "bound_ms", "library_ms"):
            entry[field] = weighted(field)
        if name == "blob_splat":  # ms is wall time: the splat is host-bound
            entry["device_ms"] = weighted("device_ms")
        ops_ms = max(weighted("ops_ms"), weighted("exp_ms"))
        entry["bound_by"] = ("operations" if ops_ms >= weighted("bytes_ms")
                             else "bytes")
        if weighted("exp_ms"):  # which operations: exponentials or products
            entry["bound_ops"] = ("exp" if weighted("exp_ms")
                                  >= weighted("ops_ms") else "tensor")
        kernels.append(entry)
        if name == "winograd":
            log(f"  winograd bound with the direct conv's multiply count: "
                f"{weighted('direct_bound_ms'):.2f} ms (its own: "
                f"{entry['bound_ms']:.2f})")
            direct = sum(results["conv3x3"][k]["ms"] * n
                         for k, n in counts[name].items())
            log(f"  the direct conv (K6) at the fused edit's {totals[name]} "
                f"Winograd launches, phase 2's medians at the same shapes: "
                f"{direct:.1f} ms against Winograd's (K12) {entry['ms']:.1f}"
                f" ms")
        if name == "flash_attention_int8":
            pre = weighted("prepass_ms")
            log(f"  {name}: the plain-torch pre-pass takes {pre:.1f} ms of "
                f"the wrapper's {entry['ms']:.1f} "
                f"({100 * pre / entry['ms']:.1f} %), the kernel about "
                f"{entry['ms'] - pre:.1f} ms")
        if name == "conv3x3_int8":
            mm = {k: results[name][k]["int_mm_ms"] for k in counts[name]}
            done = sum(v * counts[name][k] for k, v in mm.items()
                       if v is not None)
            log(f"  {name}: torch._int_mm at the (M, 9C, Co) it takes, "
                f"weighted, for information: {done:.1f} ms (it refuses "
                f"{sum(v is None for v in mm.values())} of {len(mm)} shapes)")
        for label, what in OTHER_MODE.get(name, ()):
            lib = weighted("library_ms")
            log(f"  {name}, {what} (on no main path), weighted by the main "
                f"mode's launches: ms {weighted(label + ':ms'):.1f} plain "
                f"{weighted(label + ':plain_ms'):.1f} bound "
                f"{weighted('bound_ms'):.2f} library "
                f"{'none' if lib is None else f'{lib:.1f}'}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
