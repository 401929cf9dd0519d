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
     Then a photo's own size: one-step full-width edits at each W x H of
     PHOTO_SIZES (768x512, 512x768, 576x512, 520x512, 640x480: levels
     that are no powers of two, widths no multiple of 8, odd widths, h % 8
     != 0) in every mode, and every launch key they make that the 512^2
     and batched edits did not, checked under the same bars without
     timing; each kernel's count of such shapes and its worst relative
     error in each dtype printed, and the part's seconds. Then the large
     photos, LARGE_SIZES (1024x1024, 1024x768), the same way. A flash
     check over more than ``flash_attention.PLAIN_MAX_ROWS`` query rows or
     ``PLAIN_MAX_SCORES`` score elements (32,768 rows at 1024^2: its whole
     plain version would hold 68.7 GB of fp32 scores; the batch of four
     at 768x512, 38.7 GB) holds three tiles of rows, the first, the
     middle one and the last, each over every key, to the same rows of
     the kernel's output (``flash_attention.query_rows``; the same math,
     since a row depends on no other query row).
  3. The trained 256^2 toy checkpoint: a move and a remove edit
     (TOY_CPU_STEPS steps, fp32; the CPU reference is the phase's cost),
     exact, in the int8-everything mode and as the fused-kernel
     edit, on the card with the kernels and on the CPU with the plain
     route; PSNR of card against CPU >= 40 dB; the mode's kernels launched,
     every int8 conv launch on the tensor cores (both dtypes run there).
     Then this slice's samplers and options on the exact path, fp32, at
     the same bar: DDIM with eta 0.5 and DPM-Solver++ 2M SDE Karras (their
     variance noise drawn on the CPU generator, so both sides see the same
     numbers) and the encoder cache (interval 3). Then the move and remove
     edits at W x H 192x256 and 320x256 (TOY_PHOTO_SIZES), every mode, at
     the same bars, the outputs at the photo's size.
     Then the quality gate (``train/toy.py``'s evaluation half) on the
     card, fp32, GATE_STEPS steps, the held-out scenes and bars of
     ``tests/test_toy_quality_gate_256.py``: the move edit's colour at the
     target < 0.06 (every other class more than twice as far) and its
     source inpainted (> 0.1), a two-blob compose (< 0.08 each, source >
     0.1), a remove (> 0.1 inside, inside/outside gap < 0.08), and each
     lossy mode (encoder cache, guidance-interval CFG, int8-everything,
     int8 with the cache, fused) > 27 dB against the exact edit with the
     colour at the target < 0.06; a table of the colour errors and PSNRs.
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
     int32 split workspace. Then the standard edit at 768x512 (PHOTO, W x
     H), exact, STEPS steps: its output (1, 512, 768, 3) and finite, every
     launch on the tensor cores at a shape phase 2 checked; its seconds,
     peak memory and launches printed beside the 512^2 edit's; then the
     same at 1024^2 (LARGE_SIZES[0]), its output (1, 1024, 1024, 3).
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
     layout and back): SAFETY_STEPS-step edits without a checker, with one that
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
     DDIM with eta 0.5, UniPC on STEPS trailing timesteps, LoRA scale 0.5 and
     back to 1.0 (the UNet's targets back within one bf16 rounding), the
     encoder cache, guidance-interval CFG, and a callback every 10 steps
     with the latents as output. Counters zeroed before
     each request and read after it: flash and conv3x3 launch in each, all
     on the tensor cores, and no other kernel; seconds, launches, VAE
     encodes and peak memory are printed for each. Then ``python -m
     blobctrl_torch.apps.cli --device cuda`` as a process on the root, on
     a seeded 768x512 object image and background written as PNGs
     (CLI_PHOTO_STEPS steps): its PNG 768x512, within 1 uint8 level of
     the pipeline loaded from the root here and called with the same
     arguments.
  7. Serving, on phase 6's loaded pipeline: ``edit_batch`` of 1, 2 and 4
     distinct 512^2 requests (text prompts, own images, ellipses and
     seeds; STEPS steps), warm, with seconds a batch and an image, peak
     memory and every K1 and K6 launch on the tensor cores, the first row
     of the batch of four against its solo ``__call__`` (PSNR, for
     information); the toy 256^2 checkpoint in fp32, three batched rows
     against their solo edits, >= 40 dB, and the same at 320x256
     (TOY_PHOTO_SIZES[1], W x H); ``edit_batch`` of PHOTO_BATCH distinct
     requests at PHOTO (768x512), STEPS steps, bf16, warm: its seconds a
     batch and an image and its peak memory, every launch on the tensor
     cores, row 0 >= 40 dB from its solo edit; ``apps.server.serve`` with
     ``max_batch=4`` and ``preview_every=10``, its requests at
     CHECK_STEPS steps (they check behaviour, not speed), warmed at them (the
     seconds until ``/healthz`` is 200), then a solo request from PNG
     images, four concurrent requests that must come back as one batch
     of 4, the solo request from the 512^2 JPEG fixture's bytes against
     the one from its PNG (the same image back; K1 and K6 only, on the
     tensor cores, counted as differences, so the phase's tally keeps
     every request) and a truncated JPEG (400), then the decode repair
     (request images decode in the server's worker processes: during a
     CHECK_STEPS-step edit the 12 MP JPEG request's handler thread spends < 0.1
     s of CPU; the edit's step times alone and during the decode, and
     the workers' start-up in the warmup, printed), a remove request, a
     preview request with ``/v1/progress`` seen mid-edit and a 400 for a
     cold shape; one traced TRACE_STEPS-step edit
     (``utils/observability.profile_op_breakdown``: the top kernels, the
     hand-written kernels' share of device time, the device's busy share
     of the untraced edit's wall time, the device time by kind); the
     int8-everything edit without and with the int8 linear path at
     CHECK_STEPS steps against the exact edit at as many
     (``matmul_i8`` on the card bit-equal to the CPU's first). Phase 2
     checks every K1 and K6 shape of the batches (one-step batches at B
     = 2 and 4, at 512^2 and at PHOTO, record them). Counters zeroed at the start of the phase
     and read at its end; K1, K6, K5 and K8 must each have run.
     After phase 7, the checkpoint day (``apps/checkpoint_day``) on phase
     6's models root, bf16, over phase 5's two states at CKPT_DAY_STEPS
     steps and one sample: every stage ``ok`` (download skipped, load, UI
     goldens all bit-exact, exact, int8, cfg_window, encoder_cache,
     int8_cache), each stage's seconds and PSNR drop logged; counters
     zeroed before each scoring stage and read after it: K5 and K8 in the
     int8 stages, K1 and K6 in the others, all on the tensor cores.
  8. Training (``train/train_step.py``, the autograd Functions over K1 and
     K6 whose backward is the exact plain math), after the pipelines of
     phases 4-7 are released:
     a. the K1 and K6 shapes one full-width training step launches (8c's
        configuration, loss and gradients at B = 1 and 2, nothing
        updated), each in bf16 and fp32 (TF32 off): the Function's
        forward against the plain version and its gradients (dq, dk, dv;
        dx, dw, dbias, dscale, dshift) against torch autograd through the
        plain version, under phase 2's bars, the level-0 attention (8192
        tokens) through the chunked backward; every Function output must
        have a ``grad_fn``;
     b. the trained 256^2 toy, ``train_unet_full``, fp32, remat, one
        backward on the card and one on the CPU on the same batch, t and
        noise: loss within 1e-5 relative, gradient norm within 1e-4
        relative, each leaf within 1e-3 of its max |CPU gradient|;
        TOY_TRAIN_STEPS AdamW steps a side (losses printed); one bf16 step on the card,
        K1 and K6 on the tensor cores;
     c. full width (``scripts/bench_train_512.py``'s configuration): the
        SD-1.5 UNet frozen in bf16, a rank-16 LoRA and the full BlobNet
        as fp32 masters with AdamW, random weights from
        ``apps/flagship.production_params``, 512^2 double width, remat,
        bf16 compute, TRAIN_STEPS steps at B = 1 then at B = 2: loss and
        gradient norm finite, LoRA B off zero after step 1, every BlobNet
        leaf finite; counters zeroed before each step and read after it:
        K1 and K6 in every step, all on the tensor cores, no plain flash
        or conv in the forward pass, and remat's count: K1 twice a lone
        forward's, K6 more than once and at most twice; the trainable count, step seconds (median
        of steps 2 to TRAIN_STEPS), images per second and peak memory printed; then one
        more step at B = 1 traced (``torch.profiler``: device time by
        kind, the device's busy share, the top kernels);
     d. ``apps/train_cli`` on phase 6's models root: CLI_SCENES seeded
        512^2 scenes, CLI_STEPS[0] steps at B = 2 with a checkpoint at the
        last and the export, then ``--resume`` to CLI_STEPS[1], which must
        start there; the
        export put into a copy of the root and loaded with
        ``load_pipeline(dtype=bf16)``: the BlobNet leaves and the LoRA
        bit-equal to the trained state as the loader casts them, each
        UNet LoRA target the fp32 merge then the cast; one
        CLI_EDIT_STEPS-step edit from the copy, K1 and K6 on the tensor
        cores; each stage's seconds printed. The checkpoints are in the
        JAX package's layout (orbax's OCDBT and zarr v2): each write's
        and the resume's read seconds and bytes, and the read's peak rise
        of host resident memory, printed;
     e. the committed JAX-written checkpoint (``tests/data/orbax``):
        every leaf read on the card bit-equal to the CPU read and to the
        digests JAX recorded; the training CLI resumes it for 2 steps on
        the card and on the CPU (fp32, TF32 off) on the roots
        ``utils/benchkit.write_tiny_training_roots`` rebuilds: losses
        within 1e-5 relative of each other and of JAX's, each step's
        gradients within 1e-3 of each leaf's max (8b's bars), the final
        states within the step bound; the compiled zstd decoder bit-equal
        to ``utils/zstd.py`` on every frame of the fixture, its MB/s on
        the committed weights frame decoded to DECODE_BYTES on one host
        thread and on DECODE_THREADS, and the read of 8c's 10.18 GB state,
        written by JAX, projected from them.
  9. Parallel (``blobctrl_torch/parallel``), after phase 8: ranks spawned
     on this one card (``cuda:0``, ``spawn_ranks``), over gloo by explicit
     argument (NCCL refuses two ranks on one device; ``scripts/
     torch_nccl_mesh.py`` spawns the same ranks over nccl, a card a rank),
     a group of 2 and then one of 4;
     each rank zeroes its launch counters and collective log just before
     each run and reads them just after. The ranks share one card and
     their collectives go through host memory: the seconds are for
     information only.
     a. The trained 256^2 toy (fp32, PARALLEL_TOY_STEPS steps) against the edit
        unsharded on the card, >= 40 dB each: model=2 ``__call__`` (the
        move edit), data=2 ``edit_batch`` of 4 rows (each row against its
        unsharded batched row), hybrid 2 x 2. On every rank K1 and K6
        launched, at shapes the unsharded edit never launched (local heads
        and channels, local rows); the collective log equals
        ``collectives.expected_counts``; in the hybrid run BlobNet's
        residuals bit-equal on all four ranks at every step. The move edit
        at TOY_PHOTO_SIZES[1] (320x256, W x H) at model=2 and hybrid 2 x 2,
        at the same bars against its unsharded edit, the hybrid run's
        residuals bit-equal on all four ranks too.
     b. Full width, phase 4's configuration (bf16, random weights):
        model=2 and hybrid 2 x 2, a PARALLEL_FULL_STEPS-step exact edit
        each: every K1 and K6 launch on the tensor cores, the collective
        log equal to the derived count; each model=2 rank's peak memory
        below the unsharded edit's (the full trees stay in host memory);
        the PSNR against the unsharded edit (information), each rank's
        peak memory, the collectives a step (calls, bytes, seconds inside
        them) and the seconds an edit.
     c. Every K1/K3/K5/K6/K8/K11/K12 shape that one-step full-width edits
        at model=2 and model=4 launch in each mode, and that 9a's toy edits
        at 320x256 launch, not already checked in phase 2, checked under
        phase 2's bars in bf16 and fp32.
 10. Data-parallel training (``TrainStep`` with a group,
     ``apps/train_cli.run_rank``), after phase 9: DP_WORLD ranks spawned on
     this card over gloo, as phase 9's; each rank zeroes its counters and
     collective log just before each step or CLI run and reads them just
     after. The gradient means go card -> host -> loopback TCP, so their
     seconds are for information only.
     a. The trained 256^2 toy (``train_unet_full``, fp32, TF32 off), 2 rows
        a rank of a global batch of 4, its t and noise drawn for the
        global batch: the state replicated from rank 0, the mean over the
        ranks of the first batch's loss within 1e-6 relative and each
        gradient leaf within 1e-5 of its max of the single-process step
        on the card; DP_STEPS steps, the state bit-equal on both ranks;
        the collective log equal to ``train_step.training_counts``.
     b. 8c's configuration at one row a rank of a global batch of 2:
        against the single-process B = 2 step, loss within 1e-2 and the
        gradient norm within 2e-2 relative at each of DP_STEPS steps
        (bf16); every K1 and K6 launch on the tensor cores at a shape 8a
        checked; the all-reduce bytes a step exactly 3,392,833,024 (the
        848,208,256 fp32 trainables) plus the loss, the log equal to the
        derived count; the parameters bit-equal on both ranks; seconds
        inside the all-reduces, step seconds and each rank's peak memory
        printed.
     c. ``train_cli.run_rank``, the spawned form's rank body, on phase
        6's models root at --batch_size DP_CLI_BATCH, the global batch (1
        row a rank; every rank's loader over the whole data set):
        DP_CLI_STEPS[0] steps with a checkpoint after each (rank 0 writes
        one ``step_N`` a step), then ``--resume`` to DP_CLI_STEPS[1] with
        the export; rank 0 alone narrates, img_per_sec over the global
        batch; each rank's loader yields its one row; the collective log
        equal to the derived count; the final state bit-equal on both
        ranks and to rank 0's last checkpoint; the export reloaded as 8d
        reloads its own. Printed: each rank's bytes an example holds and
        the peak rise of its resident memory while its loader is built,
        against the same examples held as ``build_example`` returns them
        (with their DINOv2 splat).
     d. The --coordinator form (``train_cli.run_rank(..., per_process=
        True)``) over DP_HOSTS hosts of DP_HOST_RANKS ranks, all on this
        card over gloo, and meanwhile the same on the CPU, both in fp32
        (TF32 off) on the trained 256^2 toy as a models root
        (``write_hosts_roots``): DP_HOST_STEPS steps at --batch_size
        DP_HOST_BATCH a host, a checkpoint at the last. Each rank's loader
        examples (its host's stride) and global rows (``multihost.
        host_rows``) and its t equal to the CPU's rank's, its noise within
        1e-6, its losses within 1e-4 relative (the kernels' fp32 bar) and
        first gradients within 1e-3 of each leaf's max; global rank 0
        alone narrates, img_per_sec over the global batch; the collective
        log equal to the derived count; every card rank's final state
        bit-equal and equal to global rank 0's checkpoint, which lies
        within ``hosts_state_check``'s bar of the CPU run's; K1 and K6
        launched on every rank. Printed: each rank's seconds, rows,
        losses and launches, and 10d's seconds.
 11. One JSON line of per-kernel numbers, then ``{"ok": true, ...}`` last.
     Before it, the direct conv (K6) against Winograd (K12) at the fused
     edit's Winograd launches, both from phase 2's medians at those
     shapes, the photo sizes' seconds in phases 2, 3, 4 and 6, the large
     photos' and the batched and sharded photo-size edits' seconds in
     phases 2, 4, 7 and 9 (LARGE_SECONDS), and the whole run's seconds,
     with the card's name and power limit.

Per-kernel numbers in the JSON line: ``launches`` are phase 4's (the exact
kernels' from the exact requests, the int8 kernels' from the int8 one, the
fused-kernel edit's four from the fused one), ``served_launches`` phase
7's, ``train_launches`` phase 8c's (K1 and K6; their
``train_max_abs_err`` is 8a's worst forward or gradient error),
``parallel_launches`` phase 9's (9a, 9b and 9c's one-step edits in
every mode), ``dp_train_launches`` phase 10's, 10d's included (K1 and
K6; the others refuse under grad or have no training path), each summed
over the ranks;
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
view: H*W*3 uint8) written, bound it. ``photo_shapes``,
``photo_rel_bf16`` and ``photo_rel_fp32`` are phase 2's count of the
shapes only the photo sizes launched, and the worst relative error there;
``large_photo_shapes``, ``large_photo_rel_bf16`` and
``large_photo_rel_fp32`` the same for the shapes only LARGE_SIZES launched.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import logging
import math
import os
import shutil
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
STEPS = 10  # UniPC steps of each full-width request
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
        plain=lambda fixed, rows=slice(None): fa.flash_attention_reference(
            q[:, rows], k, v, scale),
        rows=fa.query_rows(*q.shape[:2], k.shape[1]),
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
        plain=lambda gk, rows=slice(None): fa.flash_attention_int8_reference(
            q[:, rows], k, v, scale, global_k=gk),
        rows=fa.query_rows(*q.shape[:2], k.shape[1]),
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
        plain=lambda _, rows=slice(None): fa.flash_attention_exp2_reference(
            q[:, rows], k, v, scale),
        rows=fa.query_rows(*q.shape[:2], k.shape[1]),
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


def kernel_and_plain(case, mode):
    """-> (kernel output, plain output) of ``case`` in ``mode``: whole, or,
    for a flash case, at its query rows (``flash_attention.query_rows``:
    tiles of the rows where the whole plain version would not fit)."""
    rows = case.get("rows")
    if rows is None:
        ref = case["plain"](mode)
        return case["kernel"](mode), ref
    ref = torch.cat([case["plain"](mode, r) for r in rows], dim=1)
    got = case["kernel"](mode)
    return torch.cat([got[:, r] for r in rows], dim=1), ref


def check_kernels(shapes, timing: bool = True):
    """shapes: {kernel name: recorded keys}. Every key in bf16 and fp32, in
    every mode, kernel against plain; with ``timing``, bf16 timings of each
    mode (the first mode is the main path's; ``<label>:ms`` and
    ``<label>:plain_ms`` the others'). -> per-kernel {key: numbers}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: {} for name in shapes}
    for name, keys in shapes.items():
        for key in sorted(keys, key=repr):
            row = {"max_abs_err": 0.0, "rel_bf16": 0.0, "rel_fp32": 0.0}
            for dtype in (torch.bfloat16, torch.float32):
                case = CASES[name](key, dtype, gen)
                for i, mode in enumerate(case["modes"]):
                    got, ref = kernel_and_plain(case, mode)
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
                    worst = "rel_bf16" if dtype == torch.bfloat16 else "rel_fp32"
                    row[worst] = max(row[worst], rel)
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
    the 512^2 and the 4032x3024 4:2:0 files (best of 2)."""
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
        for _ in range(2):
            t0 = time.perf_counter()
            img = jpeg.decode_jpeg(data)
            best = min(best, time.perf_counter() - t0)
        log(f"  decode {os.path.basename(path)} ({len(data)} bytes, "
            f"{img.shape[1]}x{img.shape[0]}): {best:.3f} s (best of 2)")
        if not np.isfinite(img.astype(np.float32)).all() or img.ndim != 3:
            raise AssertionError(f"{path}: bad decode {img.shape}")
    if len(names) < 7:
        raise AssertionError(f"JPEG fixtures missing: {names}")


# ---------------------------------------------------------------------------
# phase 3: trained toy checkpoint, card against CPU
# ---------------------------------------------------------------------------

def ellipse_mask(ellipse, height: int, width: int = None) -> np.ndarray:
    """Filled ellipse ((xc, yc), (d1, d2), angle_deg), 4x4 supersampled ->
    (height, width) uint8 coverage (square where ``width`` is None)."""
    width = height if width is None else width
    (xc, yc), (d1, d2), ang = ellipse
    ss = 4
    x, y = np.meshgrid((np.arange(width * ss) + 0.5) / ss - xc,
                       (np.arange(height * ss) + 0.5) / ss - yc)
    t = np.deg2rad(ang)
    u = x * np.cos(t) + y * np.sin(t)
    v = -x * np.sin(t) + y * np.cos(t)
    inside = (u / (d1 / 2)) ** 2 + (v / (d2 / 2)) ** 2 <= 1.0
    cover = inside.reshape(height, ss, width, ss).mean(axis=(1, 3))
    return np.round(cover * 255).astype(np.uint8)


def toy_edits(height: int, steps: int, width: int = None):
    """A move and a remove edit on a synthetic toy scene: a colored ellipse
    on a gradient background, with the toy's class embeddings; ``height``
    by ``width`` (square where ``width`` is None). Any size goes: the
    pipeline floors the output to multiples of 8."""
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.train import toy
    h, w = height, height if width is None else width
    rng = np.random.RandomState(4)
    cls = 0
    emb = toy.class_embeddings()
    t = np.linspace(0.0, 1.0, h)[:, None, None]
    img = (1 - t) * np.array([120.0, 130, 140]) + t * np.array([160.0, 150,
                                                                 120])
    img = np.broadcast_to(img, (h, w, 3)).copy()
    src = ((w * 0.35, h * 0.45), (w * 0.3, h * 0.4), 20.0)
    dst = ((w * 0.65, h * 0.55), (w * 0.3, h * 0.4), 20.0)
    m = ellipse_mask(src, h, w)[..., None] / 255.0
    img = np.clip((1 - m) * img + m * np.array(toy.COLORS[cls][1]), 0,
                  255).astype(np.uint8)
    fg = np.where(m > 0.5, img, 255).astype(np.uint8)
    bg = np.where(m > 0, 255, img).astype(np.uint8)
    bg_move = np.where(ellipse_mask(dst, h, w)[..., None] > 0, 0,
                       bg).astype(np.uint8)
    lh, lw = h // 8, w // 8
    lat = rng.randn(1, lh, lw, 4).astype(np.float32)
    common = dict(height=h, width=w, num_inference_steps=steps,
                  guidance_scale=4.0, latents=lat)
    move = dict(common, fg_image=fg, bg_image=bg_move,
                gs_score=blob_math.blob_score_from_ellipse(
                    dst, w, h, (lh, lw)).numpy(),
                prompt_embeds=emb["text"][cls][None],
                negative_prompt_embeds=np.zeros_like(emb["text"][cls])[None],
                fg_dino_feats=emb["appearance"][cls][None])
    remove = dict(common, fg_image=np.full_like(img, 255), bg_image=bg,
                  gs_score=np.stack([np.ones((1, lh, lw)),
                                     np.zeros((1, lh, lw))], -1).astype(
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


GATE_STEPS = 20   # the gate's edits, as tests/test_toy_quality_gate_256.py
TOY_CPU_STEPS = 3  # the edits held against the CPU, the phase's cost
# the gate's lossy modes: (name, extra kwargs, the switches around the edit)
GATE_MODES = (("encoder cache", dict(encoder_cache_interval=3,
                                     encoder_cache_warmup=5), "exact"),
              ("guidance-interval CFG", dict(cfg_guidance_start=0.15,
                                             cfg_guidance_end=0.75), "exact"),
              ("int8-everything", {}, "int8"),
              ("int8 + encoder cache", dict(encoder_cache_interval=3,
                                            encoder_cache_warmup=5), "int8"),
              ("fused", {}, "fused"))


def quality_gate(pipe, size: int = 256, steps: int = GATE_STEPS):
    """Phase 3's quality gate on the trained toy (``train/toy.py``'s
    evaluation half), the held-out scenes and bars of
    ``tests/test_toy_quality_gate_256.py``: the move edit's colour at the
    target (< 0.06, every other class more than twice as far) with its
    source inpainted (> 0.1); a two-blob compose (each object < 0.08, the
    vacated source > 0.1); a remove (> 0.1 inside, inside/outside mean gap
    < 0.08); each lossy mode > 27 dB against the exact edit with the
    colour at the target < 0.06. Counters zeroed before each edit, read
    after it: the mode's kernels ran."""
    from blobctrl_torch import ops
    from blobctrl_torch.blob import viz
    from blobctrl_torch.train import toy
    rng = np.random.RandomState(10_000)  # held out: training used seed 0
    scene = toy.make_scene(rng, size)
    target = toy._random_ellipse(rng, size)
    cls = scene["cls"]
    kw = toy.edit_kwargs(scene, target, size=size, steps=steps)

    def edit(mode, kwargs):
        with mode_context(mode):
            ops.reset_counts()
            out = pipe(**kwargs).images[0]
            ran = {k: launch_counts()[k] for k in MODES[mode]}
        if min(ran.values()) == 0 or not np.isfinite(out).all():
            raise AssertionError(f"gate edit {mode}: launches {ran}")
        return out, ran

    def err(img, ellipse, c):
        return toy.color_error_inside(img, ellipse, c, size)

    exact, ran = edit("exact", kw)
    e = err(exact, target, cls)
    wrong = min(err(exact, target, c) for c in range(len(toy.COLORS))
                if c != cls)
    src = err(exact, scene["ellipse"], cls)
    log(f"  quality gate, trained {size}^2 toy, {steps} steps, fp32 on the "
        f"card (bars of tests/test_toy_quality_gate_256.py):")
    log(f"    {'edit':<28} {'colour error':>12} {'PSNR vs exact':>14}  "
        f"launches")
    log(f"    {'move, exact':<28} {e:12.4f} {'':>14}  {ran} (other classes "
        f">= {wrong:.4f}, source {src:.4f})")
    fails = []
    if not (e < 0.06 and wrong > 2 * e and src > 0.1):
        fails.append(f"move: {e}, {wrong}, {src}")
    crng = np.random.RandomState(20_000)
    two = tgt = None
    for _ in range(50):   # the first 2-object scene that admits a target
        cand = toy.make_scene(crng, size, n_objects=2)
        if len(cand["objects"]) != 2:
            continue
        tgt = toy._distractor_ellipse(
            crng, size, [o["ellipse"] for o in cand["objects"]])
        if tgt is not None:
            two = cand
            break
    o0, o1 = two["objects"]
    out, ran = edit("exact", toy.compose_kwargs(two, tgt, size=size,
                                                steps=steps))
    e0, e1 = err(out, tgt, o0["cls"]), err(out, o1["ellipse"], o1["cls"])
    src0 = err(out, o0["ellipse"], o0["cls"])
    log(f"    {'compose, 2 blobs':<28} {max(e0, e1):12.4f} {'':>14}  {ran} "
        f"(moved {e0:.4f}, kept {e1:.4f}, source {src0:.4f})")
    if not (e0 < 0.08 and e1 < 0.08 and src0 > 0.1):
        fails.append(f"compose: {e0}, {e1}, {src0}")
    out, ran = edit("exact", toy.remove_kwargs(scene, size=size, steps=steps))
    inside = err(out, scene["ellipse"], cls)
    m = viz.ellipse_mask(scene["ellipse"], size, size) > 127
    gap = float(np.abs(out[m].mean(0) - out[~m].mean(0)).max())
    log(f"    {'remove':<28} {inside:12.4f} {'':>14}  {ran} (inside/outside "
        f"gap {gap:.4f})")
    if not (inside > 0.1 and gap < 0.08):
        fails.append(f"remove: {inside}, {gap}")
    for name, extra, mode in GATE_MODES:
        out, ran = edit(mode, dict(kw, **extra))
        p, e = psnr(out, exact), err(out, target, cls)
        log(f"    {'move, ' + name:<28} {e:12.4f} {p:11.2f} dB  {ran}")
        if not (p > 27.0 and e < 0.06):
            fails.append(f"{name}: {p} dB, {e}")
    if fails:
        raise AssertionError(f"quality gate: {fails}")


# a photo-size CPU worker's threads: 3 workers beside this process, 8 cores
TOY_CPU_THREADS = 2


def toy_card_edit(card, mode, kw):
    """-> (images, launches, seconds, tensor-core launches) of one toy
    edit on the card in ``mode``."""
    from blobctrl_torch import ops
    with mode_context(mode):
        ops.reset_counts()
        t0 = time.perf_counter()
        got = card(**kw).images
        t_card = time.perf_counter() - t0
        return got, launch_counts(), t_card, tensor_core_counts()


def hold_toy(w, h, mode, name, card_run, want, t_cpu):
    """Phase 3's bars on one toy edit at W x H: the card's ``card_run``
    (``toy_card_edit``) of the photo's shape, >= 40 dB against the CPU's
    ``want``, every kernel of ``mode`` launched."""
    got, counts, t_card, tc = card_run
    p = psnr(got, want)
    ran = {k: counts[k] for k in MODES[mode]}
    tag = f"toy {w}x{h} (W x H) {mode} {name}"
    log(f"  {tag}: card {t_card:.2f} s, cpu {t_cpu:.2f} s, PSNR "
        f"card vs cpu {p:.2f} dB, launches {ran}")
    if not (got.shape == (1, h, w, 3) and p >= 40.0
            and min(ran.values()) > 0 and np.isfinite(got).all()):
        raise AssertionError(f"{tag}: {got.shape}, PSNR {p}, "
                             f"launches {counts}")
    if mode == "int8":  # the int8 conv: tensor cores in fp32 too
        check_tensor_cores(f"{tag}, fp32", counts, ("conv3x3_int8",), tc)


def _toy_cpu_rank(rank, world, port, sizes, out):
    """Phase 3's fp32 CPU edits at ``sizes`` in the rank-th of MODES, on
    TOY_CPU_THREADS threads: -> {(W, H, mode, edit): (images, seconds)}."""
    import traceback
    try:
        sys.path.insert(0, ROOT)
        from blobctrl_torch.train import toy
        torch.set_num_threads(TOY_CPU_THREADS)
        mode = list(MODES)[rank]
        cpu, _ = toy.load_toy(os.path.join(ROOT, "assets", "toy_ckpt_256"),
                              device="cpu", dtype=torch.float32)
        got = {}
        for w, h in sizes:
            for name, kw in toy_edits(h, TOY_CPU_STEPS, width=w).items():
                t0 = time.perf_counter()
                with mode_context(mode):
                    images = cpu(**kw).images
                got[w, h, mode, name] = (images, time.perf_counter() - t0)
        out.put((rank, "ok", got))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


def toy_phase():
    from blobctrl_torch import ops
    from blobctrl_torch.train import toy
    ckpt = os.path.join(ROOT, "assets", "toy_ckpt_256")
    card, _ = toy.load_toy(ckpt, device="cuda", dtype=torch.float32)
    cpu, _ = toy.load_toy(ckpt, device="cpu", dtype=torch.float32)
    cpu_fp32 = {}
    for mode in MODES:
        for name, kw in toy_edits(256, TOY_CPU_STEPS).items():
            got = toy_card_edit(card, mode, kw)
            t0 = time.perf_counter()
            with mode_context(mode):
                want = cpu_fp32[256, 256, mode, name] = cpu(**kw).images
            hold_toy(256, 256, mode, name, got, want, time.perf_counter() - t0)
    # the photo sizes: their CPU edits in a process a mode, the card's here
    t0, card_runs = time.perf_counter(), {}

    def on_the_card():
        for w, h in TOY_PHOTO_SIZES:
            for name, kw in toy_edits(h, TOY_CPU_STEPS, width=w).items():
                for mode in MODES:
                    card_runs[w, h, mode, name] = toy_card_edit(card, mode,
                                                                kw)
    for refs in spawn(_toy_cpu_rank, len(MODES), (TOY_PHOTO_SIZES,),
                      meanwhile=on_the_card):
        for key, (want, t_cpu) in refs.items():
            hold_toy(*key, card_runs[key], want, t_cpu)
    PHOTO_SECONDS["phase 3"] = time.perf_counter() - t0
    edits = toy_edits(256, TOY_CPU_STEPS)
    # this slice's samplers and options; the stochastic ones draw their
    # variance noise from the seed's keys, the same bits on both sides
    for name, extra in (("ddim eta 0.5", dict(scheduler="ddim", eta=0.5,
                                                seed=5)),
                        ("dpm_sde_karras", dict(scheduler="dpm_sde_karras",
                                                seed=6)),
                        ("encoder cache 3", dict(encoder_cache_interval=3,
                                                 encoder_cache_warmup=2))):
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
    quality_gate(card)
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
        want32 = cpu_fp32[256, 256, mode, "move"]
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
    want = (1, kw["height"] // 8 * 8, kw["width"] // 8 * 8, 3)
    if out.shape != want or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape}")
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    return out, secs, launches, torch.cuda.max_memory_allocated() / 2 ** 30


# ---------------------------------------------------------------------------
# a photo's own size (phases 2, 3, 4 and 6): edits that are not 512^2
# ---------------------------------------------------------------------------

# W x H of phase 2's one-step edits, each a user's photo: 3:2, 2:3, rows of
# 36 and 18 at the deepest levels (no multiple of 8), odd W at every level,
# 4:3 (h % 8 != 0 below level 0, and odd-size upsampling)
PHOTO_SIZES = ((768, 512), (512, 768), (576, 512), (520, 512), (640, 480))
TOY_PHOTO_SIZES = ((192, 256), (320, 256))  # phase 3's, W x H
PHOTO = (768, 512)    # phase 4's full-width request and the CLI's photo
CLI_PHOTO_STEPS = 4   # the CLI's edit at PHOTO
CLI_PHOTO_ELLIPSE = (430.0, 260.0, 180.0, 240.0, 30.0)  # xc, yc, d1, d2, deg
PHOTO_SECONDS = {}    # the photo checks' own seconds, by part
# W x H of the large photos: phase 2's one-step edits in every mode, phase
# 4's edit at the first (32,768 tokens at the top level, BH = 16 under CFG)
LARGE_SIZES = ((1024, 1024), (1024, 768))
# the seconds, by part, of the large photos and of the batched (phase 7) and
# sharded (phase 9) edits at a photo's size
LARGE_SECONDS = {}


def photo_edit_kwargs(wh, steps: int, **extra):
    """The standard edit at W x H ``wh``, with ``extra`` kwargs."""
    from blobctrl_torch.utils import benchkit
    w, h = wh
    return dict(benchkit.standard_edit_kwargs(h, steps, width=w), **extra)


def record_photo_shapes(pipe, checked, sizes):
    """Phase 2's photo sizes: a one-step full-width edit at each W x H of
    ``sizes`` in every mode (a mode's derived weights made once for its
    edits). -> ({kernel: launch keys not in ``checked``}, {(W, H):
    {kernel: launches}})."""
    from blobctrl_torch import ops
    new = {name: set() for name in checked}
    per_size = {wh: {} for wh in sizes}
    for mode, names in MODES.items():
        with mode_context(mode):
            for wh in sizes:
                ops.reset_counts()
                out = pipe(**photo_edit_kwargs(
                    wh, 1, blobnet_control_guidance_end=1.0)).images
                want = (1, wh[1] // 8 * 8, wh[0] // 8 * 8, 3)
                if out.shape != want or not np.isfinite(out).all():
                    raise AssertionError(f"{mode} {wh}: {out.shape}")
                counts = launch_counts()
                per_size[wh].update({k: counts[k] for k in names})
                for name, keys in launch_shapes().items():
                    if name in new:
                        new[name] |= set(keys) - checked[name]
        pipe._param_cache.clear()  # the mode's int8 or Winograd weights
    torch.cuda.synchronize()
    return new, per_size


def photo_kernel_checks(pipe, results, checked, sizes=PHOTO_SIZES,
                        seconds=PHOTO_SECONDS):
    """Phase 2's photo part: record the launch keys of ``sizes`` and check
    each one that no earlier edit (``checked``) launched, under phase 2's
    bars, without timing; ``results`` gains their rows, ``seconds`` this
    part's. -> {kernel: (new shapes, worst rel bf16, worst rel fp32)}."""
    t0 = time.perf_counter()
    new, per_size = record_photo_shapes(pipe, checked, sizes)
    for wh, counts in per_size.items():
        log(f"  one-step edits at {wh[0]}x{wh[1]} (W x H), every mode: "
            f"launches {counts}")
    t_rec = time.perf_counter() - t0
    rows = check_kernels(new, timing=False)
    summary = {}
    for name in checked:
        got = rows.get(name, {})
        results[name].update(got)
        summary[name] = (len(got),
                         max((r["rel_bf16"] for r in got.values()),
                             default=0.0),
                         max((r["rel_fp32"] for r in got.values()),
                             default=0.0))
        log(f"  {name}: {summary[name][0]} shapes new at these sizes, "
            f"worst rel err bf16 {summary[name][1]:.3e} (bar "
            f"{TOL[torch.bfloat16]:.0e}), fp32 {summary[name][2]:.3e} "
            f"(bar {TOL[torch.float32]:.0e})")
    never = [k for k in checked
             if not any(c.get(k) for c in per_size.values())]
    if never:
        raise AssertionError(f"never launched at {sizes}: {never}")
    seconds["phase 2"] = time.perf_counter() - t0
    log(f"  this part of phase 2: {seconds['phase 2']:.1f} s ({t_rec:.1f} "
        f"s of edits)")
    return summary


def photo_request(pipe, square, card: str, wh=PHOTO, seconds=PHOTO_SECONDS):
    """Phase 4's photo request: the standard edit at W x H ``wh``, bf16,
    STEPS steps, exact; its seconds, peak memory and launches beside
    ``square``, the 512^2 edit's (secs, launches, mem); ``seconds`` gains
    its own. -> its launch keys."""
    from blobctrl_torch import ops
    t0 = time.perf_counter()
    ops.reset_counts()
    out, secs, launches, mem = run_request(pipe, photo_edit_kwargs(wh,
                                                                   STEPS))
    shapes = launch_shapes()
    check_tensor_cores(f"edit at {wh[0]}x{wh[1]}", launch_counts(), EXACT)
    if min(launches[k] for k in EXACT) == 0:
        raise AssertionError(f"photo edit: launches {launches}")
    ran = {k: n for k, n in launches.items() if n}
    log(f"  edit at {wh[0]}x{wh[1]} (W x H), {STEPS} steps: output "
        f"{out.shape}, {secs:.3f} s, launches {ran}, peak memory {mem:.2f} "
        f"GiB; the 512^2 edit: {square[0]:.3f} s, launches "
        f"{({k: n for k, n in square[1].items() if n})}, {square[2]:.2f} "
        f"GiB ({card})")
    seconds["phase 4"] = time.perf_counter() - t0
    return shapes


def cli_photo_phase(models_root: str, device="cuda", steps: int =
                    CLI_PHOTO_STEPS, wh=PHOTO):
    """``python -m blobctrl_torch.apps.cli --device cuda`` on the models
    root at a photo's size: a seeded W x H object image and background,
    written as PNGs here; its PNG must be W x H and within 1 uint8 level
    of the pipeline loaded from the same root and called directly with the
    same arguments (``tests/test_torch_cli.py``'s check)."""
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.params import io
    from blobctrl_torch.utils import png
    t0 = time.perf_counter()
    w, h = wh
    work = tempfile.mkdtemp(prefix="cli_photo_")
    try:
        rng = np.random.RandomState(21)
        arrays = {name: rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                  for name in ("object", "background")}
        paths = {}
        for name, arr in arrays.items():
            paths[name] = os.path.join(work, f"{name}.png")
            with open(paths[name], "wb") as f:
                f.write(png.encode_png(arr))
        ellipse = ",".join(str(v) for v in CLI_PHOTO_ELLIPSE)
        out_dir = os.path.join(work, "out")
        argv = [sys.executable, "-m", "blobctrl_torch.apps.cli",
                "--models_root", models_root, "--device", device,
                "--object_image", paths["object"],
                "--edited_background", paths["background"],
                "--scene_prompt", PROMPT, "--ellipse", ellipse,
                "--num_inference_steps", str(steps), "--output_dir", out_dir]
        t1 = time.perf_counter()
        run = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        t_cli = time.perf_counter() - t1
        if run.returncode != 0:
            raise AssertionError(f"cli exited {run.returncode}:\n"
                                 f"{run.stderr[-4000:]}")
        with open(os.path.join(out_dir, "edit_0.png"), "rb") as f:
            got = png.decode_png(f.read())
        pipe = io.load_pipeline(models_root, dtype=torch.bfloat16,
                                device=device)
        xc, yc, d1, d2, ang = CLI_PHOTO_ELLIPSE
        want = pipe(prompt=[PROMPT], negative_prompt=None,
                    fg_image=arrays["object"], bg_image=arrays["background"],
                    gs_score=blob_math.blob_score_from_ellipse(
                        ((xc, yc), (d1, d2), ang), w, h,
                        (h // 8, w // 8)).numpy(),
                    height=h, width=w, num_inference_steps=steps,
                    guidance_scale=7.5, seed=1248464818,
                    blobnet_conditioning_scale=1.2,
                    blobnet_control_guidance_start=0.0,
                    blobnet_control_guidance_end=0.9,
                    scheduler="unipc").images
        del pipe
        want = (want[0] * 255).astype(np.uint8)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    log(f"  the CLI at {w}x{h} (W x H), {steps} steps, bf16: "
        f"{t_cli:.1f} s as a process; its PNG {got.shape}, against the "
        f"pipeline called here: max {int(diff.max())} uint8 levels, "
        f"{100 * float((diff == 0).mean()):.3f} % of values equal")
    if got.shape != (h, w, 3) or diff.max() > 1:
        raise AssertionError(f"cli photo: {got.shape}, {int(diff.max())}")
    PHOTO_SECONDS["phase 6"] = time.perf_counter() - t0


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
SAFETY_STEPS = 6


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
    drawn = sam.init(cfg or sam.SAMConfig.vit_h(), key=SAM_SEED,
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
    drawn = sc.init(cfg, key=13, device=device)
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
    """The five trees drawn on ``device`` in fp16, the checkpoint's dtype:
    the JAX package's init trees for ``PRNGKey(seed)`` to ``PRNGKey(seed +
    4)`` (the BlobNet's taps drawn too), and a rank-16 LoRA over the UNet's
    attention projections, A ~ N(0, 1/in), B ~ N(0, 0.02^2), stored in
    fp16, A and B of each target from ``key, a, b = split(key, 3)`` along
    a chain from ``PRNGKey(seed + 5)``."""
    from blobctrl_torch.models import blobnet, clip_text, dinov2, unet, vae
    from blobctrl_torch.params import export
    from blobctrl_torch.utils import threefry
    f16 = torch.float16
    trees = dict(
        unet=unet.init_unet(cfgs["unet"], seed, device, f16),
        blobnet=blobnet.init_blobnet(cfgs["blobnet"], seed + 1, device, f16,
                                     zero_taps=False),
        vae=vae.init_vae(cfgs["vae"], seed + 2, device, f16),
        clip=clip_text.init(cfgs["clip"], seed + 3, device, f16),
        dino=dinov2.init(cfgs["dino"], seed + 4, device, f16))
    key = threefry.key(seed + 5)
    lora = {}
    for path, k in export.flatten(trees["unet"]).items():
        parts = path.split(".")
        if parts[-1] == "kernel" and parts[-2] in ("to_q", "to_k", "to_v",
                                                    "to_out"):
            d_in, d_out = k.shape
            key, ka, kb = threefry.split(key, 3)
            a = threefry.normal(ka, (d_in, LORA_RANK), device=device)
            b = threefry.normal(kb, (LORA_RANK, d_out), device=device)
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


HOST_DRAWS = "dpm_sde_karras again, seed 11, its noise drawn on the host"


def checkpoint_requests(size: int):
    """The standard edit's kwargs from a text prompt and the object image,
    under each sampler and option of this slice. The request labelled
    ``HOST_DRAWS`` draws its noise on the CPU and moves it, as the port
    drew before its draws ran on the card."""
    from blobctrl_torch.schedulers import common
    base = text_edit_kwargs(size, STEPS)
    first = dict(base, scheduler="dpm_karras")
    sde = dict(base, scheduler="dpm_sde_karras", seed=11)
    trailing = [int(t) for t in common.make_timesteps(STEPS,
                                                      spacing="trailing")]
    # the repeat comes before the LoRA rescale, which moves the UNet's
    # weights by a bf16 rounding
    return [(f"dpm_karras, {STEPS} steps", first),
            ("dpm_karras repeat (conditioning memo)", dict(first)),
            (f"dpm_sde_karras, {STEPS} steps, seed 11", sde),
            (HOST_DRAWS, dict(sde)),
            (f"ddim, eta 0.5, {STEPS} steps", dict(
                base, scheduler="ddim", eta=0.5, seed=12)),
            (f"unipc, {STEPS} trailing timesteps", dict(
                base, timesteps=trailing)),
            ("unipc, LoRA scale 0.5", dict(
                base, cross_attention_kwargs={"scale": 0.5})),
            ("unipc, LoRA scale back to 1.0", dict(
                base, cross_attention_kwargs={"scale": 1.0})),
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


# jax.random 0.9.0 (threefry2x32, x64 off, partitionable) for seed 7, taken
# from JAX on the CPU: the key data, step 3's variance key fold_in(fold_in(
# key, 0x5de), 3), the first 8 random bits of a DRAW_SHAPE draw, and the
# first 8 elements of normal(key) and normal(step 3's key) at DRAW_SHAPE as
# float32 bits
JAX_SEED7 = dict(
    key=(0x0, 0x7), vkey3=(0xDC462665, 0x1C542F15),
    bits=(0xAC91290B, 0xF9807E00, 0x4D8729AA, 0x71A74530, 0xBB1B6386,
          0xA1849B6B, 0x72D43358, 0x6956D56A),
    latents=(0x3EE7084B, 0x3FFA0AAE, 0xBF042845, 0xBE1052A7, 0x3F1D9131,
             0x3EAB2B88, 0xBE046DB0, 0xBE651B2E),
    step3=(0xBF84535D, 0xBE866F4B, 0xBF5BF753, 0x3FB03AB7, 0xBF51F534,
           0x3F4B82DC, 0xBFB4FC4A, 0x3D5AD96C))
DRAW_SHAPE = (1, 64, 64, 4)   # a 512^2 edit's latents
DRAW_BATCH = 4


def _ulps(got: torch.Tensor, want) -> int:
    """The largest distance in float32 ulps between the first elements of
    ``got`` and the float32 bit patterns ``want``."""
    def ordered(i):
        i = i.astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    g = got.flatten()[:len(want)].cpu().numpy().view(np.int32)
    w = np.array(want, np.uint32).view(np.int32)
    return int(np.abs(ordered(g) - ordered(w)).max())


def seeded_draws(pipe, card: str, device="cuda"):
    """Phase 6's seeded draws: the pipeline's ``_seed_noise(7, DRAW_SHAPE)``
    made on ``device``, its latents and step 3's variance draw, against
    ``JAX_SEED7`` (key data and bits exact, the normals within 4 ulp) and
    against the same draws made on the CPU (bit-equal), as is one SDE
    step's draw at B = ``DRAW_BATCH`` (a row per request, as
    ``edit_batch`` draws them); then the seconds (median of 5, until the
    noise is on ``device``) of one latent draw and of that SDE step's draw,
    made on the host and moved, and made on ``device``. ``card``: the
    card's name and power limit, for the log."""
    from blobctrl_torch.utils import threefry
    key = threefry.key(7)
    exact = {
        "key": tuple(int(x) for x in key) == JAX_SEED7["key"],
        "vkey3": tuple(int(x) for x in threefry.fold_in(threefry.fold_in(
            key, 0x5DE), 3)) == JAX_SEED7["vkey3"],
        "bits": tuple(int(x) for x in threefry.random_bits(
            key, DRAW_SHAPE, device=device).flatten()[:8].tolist())
        == JAX_SEED7["bits"]}
    lat, draw = pipe._seed_noise(7, DRAW_SHAPE, device)
    ulps = {"latents": _ulps(lat, JAX_SEED7["latents"]),
            "step3": _ulps(draw(3, DRAW_SHAPE), JAX_SEED7["step3"])}
    host_lat, host_draw = pipe._seed_noise(7, DRAW_SHAPE)
    seeds = list(range(DRAW_BATCH))
    step_shape = (DRAW_BATCH,) + DRAW_SHAPE[1:]
    draws = {where: pipe._seed_noise(seeds, DRAW_SHAPE, where)[1]
             for where in ("cpu", device)}
    same = {"latents": torch.equal(lat.cpu(), host_lat),
            "step3": torch.equal(draw(3, DRAW_SHAPE).cpu(),
                                 host_draw(3, DRAW_SHAPE)),
            "sde_step": torch.equal(draws[device](5, step_shape).cpu(),
                                    draws["cpu"](5, step_shape))}
    log(f"  seed 7's draws against JAX's: exact {exact}; the first 8 "
        f"latents and step 3's variance noise within {ulps} ulp (tol 4); "
        f"made on {device} against the CPU, bit-equal: {same}")
    if not all(exact.values()) or max(ulps.values()) > 4 \
            or not all(same.values()):
        raise AssertionError(f"seeded draws: {exact}, {ulps} ulp, {same}")

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()
    secs = {}
    for where in ("cpu", device):
        for name, fn in (
                ("latents", lambda: pipe._seed_noise(11, DRAW_SHAPE,
                                                     where)[0]),
                ("sde_step", lambda: draws[where](5, step_shape))):
            times = []
            for _ in range(5):
                sync()
                t0 = time.perf_counter()
                fn().to(device)
                sync()
                times.append(time.perf_counter() - t0)
            secs[(name, where)] = statistics.median(times)
    log(f"  seconds of one draw on {card}, made on the host and moved / "
        f"made on {device}: latents {DRAW_SHAPE} "
        f"{secs[('latents', 'cpu')]:.4f} / {secs[('latents', device)]:.4f}"
        f" s, one SDE step at B = {DRAW_BATCH} "
        f"{secs[('sde_step', 'cpu')]:.4f} / {secs[('sde_step', device)]:.4f}"
        f" s (median of 5, until the noise is on {device})")
    return secs


# jax.random 0.9.0's parameter init, taken from the JAX package on the CPU
# by scripts/torch_init_constants.py, which checks each key path against the
# JAX package's whole init at a narrow geometry with the same split counts.
# For a few leaves of the trees that ``apps/flagship.production_params(0)``
# draws and of CLIP ViT-L/14 text for key 3 (``benchkit.add_encoders(pipe,
# seed=3)``): the tree and its seed, the leaf's path, its key's path below
# PRNGKey(seed) (child i of split(key, n) for each (n, i); a conv or linear
# kernel is drawn from the first of split(that key)), its draw and shape,
# and the float32 bits of its first 8 elements
JAX_INIT = {
    'unet conv_in': dict(
        tree='unet', seed=0,
        path=('conv_in', 'kernel'),
        splits=((12, 0),),
        draw='conv', shape=(3, 3, 5, 320),
        bits=(0xBD84AB95, 0x3DAFE933, 0xBCFA23EB, 0x3E0154CC, 0xBD73FBFA,
              0xBE0C497B, 0xBDBBB21A, 0x3CCB13D6)),
    'unet mid attn1 to_q': dict(
        tree='unet', seed=0,
        path=('mid_block', 'attentions', 0, 'blocks', 0, 'attn1', 'to_q',
              'kernel'),
        splits=((12, 6), (3, 2), (3, 1), (3, 0), (4, 0)),
        draw='linear', shape=(1280, 1280),
        bits=(0xBC996410, 0xBC125FEA, 0x3A98AC75, 0xBBB4B096, 0xBBE94317,
              0x3BDD878C, 0xBBD63C35, 0xBCADE624)),
    'blobnet conv_in': dict(
        tree='blobnet', seed=1,
        path=('conv_in', 'kernel'),
        splits=((12, 0),),
        draw='conv', shape=(3, 3, 1029, 320),
        bits=(0xB81E12A9, 0xBB9B4D34, 0x3C171E95, 0x3AD8FCA2, 0x3C284F10,
              0x3BA61762, 0xBBE7B7E0, 0x3B83EB81)),
    'vae decoder conv_out': dict(
        tree='vae', seed=2,
        path=('decoder', 'conv_out', 'kernel'),
        splits=((64, 41),),
        draw='conv', shape=(3, 3, 128, 3),
        bits=(0xBCD06ADC, 0xBCA54D87, 0x3CDA66BE, 0xBC5BDA50, 0x3A86FD40,
              0x3AA6C31A, 0xBB9D6179, 0x3AF5B528)),
    'clip token_embedding': dict(
        tree='clip', seed=3,
        path=('token_embedding',),
        splits=((100, 0),),
        draw='normal', shape=(49408, 768),
        bits=(0xBD42D566, 0xBD0BC4E9, 0xBC210552, 0xBC9DCC6D, 0x3B795093,
              0x3CB68064, 0x3C769BFC, 0xBD2E23B9)),
}


def init_draws(card: str, device="cuda"):
    """Phase 6's init check: ``flagship.production_params(0)`` drawn on
    ``device`` in fp32, before any cast (seconds until drawn, the peak
    memory the draw adds and the tree's bytes printed), and CLIP ViT-L/14
    text for key 3; each leaf of ``JAX_INIT`` against JAX's first 8
    elements (uniform 0 ulp, normal within 4), and its first row drawn on
    the CPU from the leaf's key (``utils.threefry``, ``rows=``) bit-equal
    to the card's. ``card``: the card's name and power limit."""
    from blobctrl_torch.apps import flagship
    from blobctrl_torch.models import clip_text
    from blobctrl_torch.params import export
    from blobctrl_torch.utils import threefry
    trees = {}

    def draw(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return out, secs, (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    (trees["unet"], trees["blobnet"], trees["vae"]), secs, peak = draw(
        lambda: flagship.production_params(0, device, torch.float32))
    held = sum(t.numel() * t.element_size() for tree in trees.values()
               for t in export.flatten(tree).values())
    trees["clip"], clip_secs, clip_peak = draw(lambda: clip_text.init(
        flagship.clip_vit_l_config(), 3, device))
    log(f"  production_params(0) drawn on {card} in fp32: {secs:.3f} s, "
        f"{held / 2 ** 30:.2f} GiB held, peak {peak:.2f} GiB above what was "
        f"allocated before; CLIP ViT-L/14 text for key 3: {clip_secs:.3f} "
        f"s, peak {clip_peak:.2f} GiB")
    worst, same = {}, {}
    for name, leaf in JAX_INIT.items():
        got = trees[leaf["tree"]]
        for p in leaf["path"]:
            got = got[p]
        worst[name] = _ulps(got, leaf["bits"])
        key = threefry.key(leaf["seed"])
        for n, i in leaf["splits"]:
            key = threefry.split(key, n)[i]
        shape = leaf["shape"]
        if leaf["draw"] == "normal":
            row = threefry.normal(key, shape, rows=range(1)) * 0.02
        else:
            bound = 1.0 / math.sqrt(math.prod(shape[:-1]))
            row = threefry.uniform(threefry.split(key)[0], shape, -bound,
                                   bound, rows=range(1))
        same[name] = torch.equal(got[:1].cpu(), row)
    log(f"  the first 8 elements against JAX's (ulp; uniform 0, normal 4): "
        f"{worst}; the first row drawn on the CPU from the leaf's key, "
        f"bit-equal to the card's: {same}")
    tol = {name: 4 if leaf["draw"] == "normal" else 0
           for name, leaf in JAX_INIT.items()}
    if any(worst[n] > tol[n] for n in worst) or not all(same.values()):
        raise AssertionError(f"init draws: {worst} ulp, {same}")
    del trees, got
    torch.cuda.empty_cache()
    return secs, peak


def checkpoint_phase(root: str, card: str, device="cuda", size: int = 512):
    """Phase 6 (``device`` and ``size`` let it be rehearsed on the CPU at a
    small size); -> (per-request records, the loaded pipeline). The models
    root is written into the directory ``root``, which the caller owns;
    ``card`` is the card's name and power limit, for the log."""
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
    seeded_draws(pipe, card, device)
    if device != "cpu":
        init_draws(card, device)
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

    def host_noise(seed, shape, device=None):
        return type(pipe)._seed_noise(seed, shape)
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
            if label == HOST_DRAWS:
                pipe._seed_noise = host_noise
            res, secs = timed(lambda: pipe(**kw))
            pipe.__dict__.pop("_seed_noise", None)
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
            last = kw["num_inference_steps"] - 1
            if fired and ([i for i, _, _ in fired] != [
                    i for i in range(last + 1) if i % 10 == 0 or i == last]
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
    log(f"  dpm_sde_karras twice with one seed, its noise drawn on "
        f"{device} ({records[2]['secs']:.3f} s) and on the host "
        f"({records[3]['secs']:.3f} s): images bit-equal {same['sde']}; "
        f"the repeat's image equals the first's: {same['repeat']}")
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
TRACE_STEPS = 10
CHECK_STEPS = 6    # 7.4's server requests and 7.6's int8 edits (7.1: STEPS)
# the traced edit's kernels by kind: (kind, regex on the kernel's name; None:
# the hand-written kernels), first match wins
TRACE_KINDS = (("hand-written", None),
               ("reductions (norm statistics)", r"reduce_kernel"),
               ("cuDNN convs", r"fprop|onvolve|cudnn|nhwc"),
               ("cuBLAS GEMMs", r"nvjet|gemm|Kernel2<cutlass"),
               ("copies and casts", r"copy|Memcpy|Memset|CatArray"),
               ("elementwise", r"elementwise"))


def serving_requests(size: int, n: int, text: bool = True,
                     width: int = None):
    """n distinct edit_batch requests at ``size`` by ``width`` (square where
    ``width`` is None): own images, ellipse and seed, and a text prompt
    (phase 7's loaded pipeline has CLIP and DINOv2) or the embeddings
    (phase 2's pipeline has neither)."""
    from blobctrl_torch.utils import benchkit
    keep = ("fg_image", "bg_image", "gs_score") + (
        () if text else ("prompt_embeds", "negative_prompt_embeds",
                         "fg_dino_feats"))
    w = size if width is None else width
    reqs = []
    for b in range(n):
        kw = benchkit.make_edit_inputs(size, seed=20 + b, ellipse=(
            (w * (0.4 + 0.06 * b), size * 0.5),
            (w * 0.25, size * 0.38), 25.0 * b), width=width)
        req = {k: kw[k] for k in keep}
        if text:
            req["prompt"] = SERVE_PROMPTS[b % len(SERVE_PROMPTS)]
        req["seed"] = 20 + b
        reqs.append(req)
    return reqs


def record_batch_shapes(pipe):
    """Phase 2's part of phase 7: one-step edit_batch runs at B = 2 and 4
    (exact) at 512^2 and at PHOTO, so that phase 2 checks every kernel shape
    phase 7 launches."""
    for w, h in ((512, 512), PHOTO):
        for n in BATCH_SIZES[1:]:
            pipe.edit_batch(serving_requests(h, n, text=False, width=w),
                            height=h, width=w, num_inference_steps=1,
                            **dict(SERVE_SHARED,
                                   blobnet_control_guidance_end=1.0))


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
    """edit_batch at each B of BATCH_SIZES (distinct requests), warm, then
    the first request's solo ``__call__`` against its row. ``tally`` banks
    the counters and zeroes them."""
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
    res, secs = timed(lambda: pipe(**reqs[0], num_inference_steps=steps,
                                   **shared))
    log(f"  solo __call__ of request 0: {secs:.3f} s; PSNR of its row in "
        f"the B={max(BATCH_SIZES)} batch against it "
        f"{psnr(out[max(BATCH_SIZES)][:1], res.images):.2f} dB (bf16, for "
        f"information)")


def toy_batch_against_solo(w: int = 256, h: int = 256):
    """The trained toy 256^2 checkpoint in fp32 on the card at W x H: three
    distinct requests batched, each row against its solo edit, >= 40 dB."""
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.train import toy
    card, _ = toy.load_toy(os.path.join(ROOT, "assets", "toy_ckpt_256"),
                           device="cuda", dtype=torch.float32)
    move = toy_edits(h, 20, width=w)["move"]
    shared = {k: move[k] for k in ("height", "width", "num_inference_steps",
                                   "guidance_scale")}
    reqs = []
    for b in range(3):
        dst = ((w * (0.55 + 0.05 * b), h * 0.55),
               (77.0 * w / 256, 102.0 * h / 256), 20.0 + 30 * b)
        reqs.append(dict(
            {k: move[k] for k in ("fg_image", "bg_image", "prompt_embeds",
                                  "negative_prompt_embeds",
                                  "fg_dino_feats")},
            gs_score=blob_math.blob_score_from_ellipse(
                dst, w, h, (h // 8, w // 8)).numpy(), seed=30 + b))
    batch = card.edit_batch(reqs, **shared).images
    if batch.shape != (3, h, w, 3):
        raise AssertionError(f"toy batch at {w}x{h}: {batch.shape}")
    for b, req in enumerate(reqs):
        p = psnr(batch[b:b + 1], card(**req, **shared).images)
        log(f"  toy {w}x{h} (W x H) fp32 edit_batch row {b} against its "
            f"solo edit: {p:.2f} dB")
        if not p >= 40.0:
            raise AssertionError(f"toy batched row {b} at {w}x{h}: {p} dB")
    del card


PHOTO_BATCH = 4   # 7.2's full-width batch at PHOTO


def photo_batch_against_solo(pipe, steps: int, tally):
    """edit_batch of PHOTO_BATCH distinct requests at PHOTO (W x H), bf16,
    ``steps`` steps, warm: its seconds a batch and an image and its peak
    memory, every launch on the tensor cores, row 0 >= 40 dB from its solo
    edit (a batched row is not bit-equal: the wrappers split K by M =
    B.H.W). ``tally`` banks the counters and zeroes them."""
    w, h = PHOTO
    reqs = serving_requests(h, PHOTO_BATCH, width=w)
    shared = dict(SERVE_SHARED, height=h, width=w)
    pipe.edit_batch(reqs, num_inference_steps=1, **shared)   # warm
    tally()
    torch.cuda.reset_peak_memory_stats()
    res, secs = timed(lambda: pipe.edit_batch(
        reqs, num_inference_steps=steps, **shared))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = launch_counts()
    check_tensor_cores(f"edit_batch B={PHOTO_BATCH} at {w}x{h}", counts,
                       EXACT)
    ran = {k: v for k, v in counts.items() if v}
    if (set(ran) != set(EXACT) or res.images.shape != (PHOTO_BATCH, h, w, 3)
            or not np.isfinite(res.images).all()):
        raise AssertionError(f"edit_batch at {w}x{h}: launches {ran}, "
                             f"output {res.images.shape}")
    tally()
    solo, secs_solo = timed(lambda: pipe(**reqs[0], num_inference_steps=steps,
                                         **shared))
    p = psnr(res.images[:1], solo.images)
    log(f"  edit_batch B={PHOTO_BATCH} at {w}x{h} (W x H), {steps} steps: "
        f"{secs:.3f} s a batch, {secs / PHOTO_BATCH:.3f} s an image, peak "
        f"memory {peak:.2f} GiB, launches {ran}; the solo edit of request 0 "
        f"{secs_solo:.3f} s, its row in the batch {p:.2f} dB from it")
    if not p >= 40.0:
        raise AssertionError(f"batched row 0 at {w}x{h}: {p} dB")


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


def serve_payload(req, b: int, size: int, steps: int,
                  extra: dict = None) -> dict:
    """The JSON body of request ``req`` (the b-th of ``serving_requests``)
    to ``/v1/edit``: its prompt, seed, ellipse and PNG images, at ``size``
    and ``steps``, then the fields of ``extra`` (which may replace
    them)."""
    import base64
    from blobctrl_torch.utils import png
    (cx, cy), (d1, d2), ang = ((size * (0.4 + 0.06 * b), size * 0.5),
                               (size * 0.25, size * 0.38), 25.0 * b)
    return dict({"prompt": req["prompt"], "seed": req["seed"], "size": size,
                 "num_inference_steps": steps,
                 "guidance_scale": SERVE_SHARED["guidance_scale"],
                 "blobnet_conditioning_scale":
                     SERVE_SHARED["blobnet_conditioning_scale"],
                 "blobnet_control_guidance_end":
                     SERVE_SHARED["blobnet_control_guidance_end"],
                 "ellipse": [cx, cy, d1, d2, ang],
                 "fg_image": base64.b64encode(png.encode_png(
                     req["fg_image"])).decode(),
                 "bg_image": base64.b64encode(png.encode_png(
                     req["bg_image"])).decode()}, **(extra or {}))


def served_images(body):
    """-> (the response of ``/v1/edit``, its images as floats in [0, 1])."""
    import base64
    from blobctrl_torch.utils import png
    resp = json.loads(body)
    return resp, np.stack([png.decode_png(base64.b64decode(b)).astype(
        np.float32) / 255.0 for b in resp["images"]])


def concurrent_edits(base, payloads):
    """POST every payload to ``base``'s ``/v1/edit`` at once, a thread
    each. -> for each payload (status, response, its images as floats in
    [0, 1] or None where the status is not 200, the client's seconds)."""
    results = [None] * len(payloads)

    def worker(b):
        t = time.perf_counter()
        c, bd = _http(base + "/v1/edit", payloads[b])
        results[b] = (c, bd, time.perf_counter() - t)
    threads = [threading.Thread(target=worker, args=(b,))
               for b in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [(c,) + (served_images(bd) if c == 200
                    else (json.loads(bd), None)) + (wall,)
            for c, bd, wall in results]


def server_phase(pipe, size, steps):
    """``apps.server.serve`` on the card (max_batch=4, preview_every=10,
    warmup at ``steps``): warmup seconds until /healthz is 200, a solo
    request from a text prompt, an ellipse and PNG images, four concurrent
    requests (one batch of 4), a remove request, a preview request with
    /v1/progress seen mid-edit, a 400 for a cold shape."""
    from blobctrl_torch.apps import server
    reqs = serving_requests(size, 4)

    def payload(b, **extra):
        return serve_payload(reqs[b], b, size, steps, extra)

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
        resp, img = served_images(body)
        log(f"  solo request (text prompt, ellipse, PNG images): {code}, "
            f"server {resp['seconds']:.3f} s (batch of "
            f"{resp.get('batch_size')}), client {wall:.3f} s with the "
            f"1.5 s batch window")
        if code != 200 or img.shape != (1, size, size, 3):
            raise AssertionError(f"solo request {code}")
        for b, (c, resp, _, wall) in enumerate(concurrent_edits(
                base, [payload(b) for b in range(4)])):
            if c != 200 or resp.get("batch_size") != 4:
                raise AssertionError(f"concurrent request {b}: {c} {resp}")
            log(f"  concurrent request {b}: batch of {resp['batch_size']}, "
                f"server {resp['seconds']:.3f} s, client {wall:.3f} s")
        if service.batches_run != 2:   # the solo request's, and this one
            raise AssertionError(f"batches run {service.batches_run}")
        jpeg_requests(base, payload, served_images, size)
        decode_repair(pipe, base, service, size, steps)
        rm = payload(1, remove=True)
        del rm["ellipse"]
        code, body = _http(base + "/v1/edit", rm)
        resp, img = served_images(body)
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
        resp, img = served_images(body)
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

CKPT_DAY_STEPS = 6
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
    kw = dict(serving_requests(size, 1)[0], height=size, width=size,
              num_inference_steps=TRACE_STEPS, **SERVE_SHARED)
    report_trace(f"{TRACE_STEPS}-step edit", lambda: pipe(**kw))


def report_trace(what, fn):
    """``fn`` once under ``torch.profiler`` (after a warm-up call) and once
    untraced: device time, the device's busy share of the untraced wall
    time, the top kernels and the device time by kind, hand-written
    kernels first."""
    import re
    from blobctrl_torch.utils import observability
    ops_ms = observability.profile_op_breakdown(fn, repeats=1, top_k=100000)
    _, wall = timed(fn)
    # the profiler names them e.g. "void (anonymous namespace)::
    # conv3x3_kernel_tc<true>(...)"
    pat = re.compile(r"(^|[\s:])(" + "|".join(sorted(hand_kernel_names()))
                     + r")[<(]")
    total = sum(ops_ms.values())
    hand = sum(v for k, v in ops_ms.items() if pat.search(k))
    log(f"  traced {what}: device time {total:.1f} ms over "
        f"{len(ops_ms)} kernels; the same call untraced {1e3 * wall:.1f} ms "
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


def int8_linear_edit(pipe, size, steps, tally):
    """One edit in the int8-everything mode without and with the int8
    linear path; PSNR against the exact edit at as many steps and between
    the two."""
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
    tally()
    exact, secs = timed(lambda: pipe(**kw).images)
    check_tensor_cores("the exact edit", launch_counts(), EXACT)
    log(f"  the exact edit, {steps} steps: {secs:.3f} s")
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
    batch_scaling(pipe, size, steps, tally)
    tally()
    log("  7.2 batched against solo, toy 256^2 fp32 on the card")
    toy_batch_against_solo()
    t0 = time.perf_counter()
    log(f"  7.2 at a photo's size: the toy at {TOY_PHOTO_SIZES[1][0]}x"
        f"{TOY_PHOTO_SIZES[1][1]} (W x H), then full width at {PHOTO[0]}x"
        f"{PHOTO[1]}")
    toy_batch_against_solo(*TOY_PHOTO_SIZES[1])
    # the toy's fp32 launches are off the main path: held batch against solo
    # only, not against the plain versions
    ops.reset_counts()
    photo_batch_against_solo(pipe, steps, tally)
    tally()
    LARGE_SECONDS["phase 7"] = time.perf_counter() - t0
    log("  7.3 (phase 2 checked every kernel shape of this phase)")
    check = min(steps, CHECK_STEPS)
    log(f"  7.4 the HTTP server, {check} steps a request")
    server_phase(pipe, size, check)
    check_tensor_cores("server", launch_counts(), EXACT)
    tally()
    log("  7.5 one traced edit")
    traced_edit(pipe, size)
    tally()
    log(f"  7.6 the int8 linear path, {check} steps an edit")
    int8_linear_edit(pipe, size, check, tally)
    tally()
    return shapes, dict(totals)


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

# PyTorch's own TF32 switches (cuDNN, cuBLAS), which phase 2 turns off for
# the fp32 references; 8c and 8d run on them, as a user's training process
TF32_DEFAULTS = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
TRAIN_SIZE = 512         # 8a's and 8c's image side
TRAIN_LATENT = (TRAIN_SIZE // 8, TRAIN_SIZE // 8, 4)
TRAIN_STEPS = 3          # 8c's steps at each batch size
TRAIN_BATCHES = (1, 2)   # 8c's batch sizes (8a records the shapes of both)
TRAIN_LORA_RANK = 16
TOY_TRAIN_BATCH = 4      # 8b's toy batch
TOY_TRAIN_STEPS = 2      # 8b's AdamW steps a side
CLI_SCENES = 4           # 8d's data set
CLI_EDIT_STEPS = 10
CLI_STEPS = (2, 3)       # 8d: steps with a checkpoint, then --resume to


def train_batch(step, b: int, seed: int = 0):
    """A random batch for ``step``'s nets at ``TRAIN_SIZE``^2
    (``scripts/bench_train_512.py``'s: latents and features standard
    normal, scores uniform, 77 text tokens)."""
    rng = np.random.RandomState(seed)
    lh = TRAIN_LATENT[0]
    dino_c = step.blobnet_cfg.conditioning_channels - 1
    ctx = step.unet_cfg.cross_attention_dim
    return {"x0_latents": rng.randn(b, lh, lh, 4).astype(np.float32),
            "fg_latents": rng.randn(b, lh, lh, 4).astype(np.float32),
            "bg_latents": rng.randn(b, lh, lh, 4).astype(np.float32),
            "fg_score": rng.rand(b, lh, lh, 1).astype(np.float32),
            "bg_score": rng.rand(b, lh, lh, 1).astype(np.float32),
            "fg_feats": rng.randn(b, lh, lh, dino_c).astype(np.float32),
            "text_embeds": rng.randn(b, 77, ctx).astype(np.float32)}


def training_setup(group=None):
    """8c's configuration: the UNet (5-ch conv_in) frozen in bf16, a
    rank-16 LoRA, the full BlobNet as fp32 masters with AdamW, bf16
    compute, remat; random weights from ``apps/flagship.production_params``
    (the same on every rank). ``group``: the data-parallel ranks (phase
    10). -> (step, state, frozen UNet)."""
    from blobctrl_torch.apps import flagship
    from blobctrl_torch.models import lora
    from blobctrl_torch.train import train_step as ts
    from blobctrl_torch.utils import threefry
    ucfg, bcfg = (flagship.sd15_unet_config(),
                  flagship.blobctrl_blobnet_config())
    frozen, blob, _ = flagship.production_params(0, "cuda", torch.bfloat16)
    adapter = lora.init_lora(threefry.key(0), frozen,
                             rank=TRAIN_LORA_RANK, device="cuda")
    cfg = ts.TrainConfig()
    state = ts.init_train_state(cfg, blob, adapter)
    del blob
    return ts.make_train_step(cfg, ucfg, bcfg, group=group), state, frozen


def record_training_shapes(step, state, frozen):
    """8a's shapes: every K1 and K6 key one training step launches (loss
    and gradients, nothing updated) at each of 8c's batch sizes."""
    from blobctrl_torch import ops
    from blobctrl_torch.train import train_step as ts
    from blobctrl_torch.utils import threefry
    shapes = {name: set() for name in EXACT}
    for b in TRAIN_BATCHES:
        ops.reset_counts()
        step.loss_and_grads(state, frozen, train_batch(step, b, b),
                            *ts.draw_t_noise(threefry.key(b),
                                             b, TRAIN_LATENT, device="cuda"))
        for name in EXACT:
            shapes[name] |= set(launch_shapes()[name])
    return shapes


def _vjp_inputs(name, key, dtype, gen):
    """A K1 or K6 key's inputs on the card (all requiring grad), the
    Function and its plain version."""
    from blobctrl_torch.ops import conv3x3 as cv
    from blobctrl_torch.ops import flash_attention as fa
    if name == "flash_attention":
        bh, sq, skv, d = key[:4]
        q, k, v = (_rnd(gen, bh, n, d).to(dtype) for n in (sq, skv, skv))
        scale = d ** -0.5
        return ((q, k, v), ("dq", "dk", "dv"),
                lambda q, k, v: fa.flash_attention(q, k, v, scale),
                lambda q, k, v: fa.flash_attention_reference(q, k, v, scale))
    x, w, bias, pro, _, _ = _conv_inputs(key, dtype, gen)
    args = (x, w, bias) + (pro if key[6] else ())
    return (args, ("dx", "dw", "dbias", "dscale", "dshift")[:len(args)],
            lambda *a: cv.conv3x3(*a), lambda *a: cv.conv3x3_reference(*a))


def check_training_functions(shapes):
    """8a: at every recorded K1 and K6 key, in bf16 and fp32 (TF32 off),
    the Function's forward against the plain version and its gradients
    against torch autograd through the plain version, under phase 2's
    bars; each Function output must carry a ``grad_fn`` (a kernel writes
    a fresh tensor autograd cannot see). -> {kernel: {key: max abs err}}."""
    from blobctrl_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {name: {} for name in shapes}
    for name, keys in shapes.items():
        for key in sorted(keys, key=repr):
            worst = 0.0
            for dtype in (torch.bfloat16, torch.float32):
                args, names, fn, plain = _vjp_inputs(name, key, dtype, gen)
                args = [a.requires_grad_() for a in args]
                got = fn(*args)
                if got.grad_fn is None:
                    raise AssertionError(f"{name} {key}: no grad_fn")
                ref = plain(*args)
                cot = torch.randn(ref.shape, generator=gen, device="cuda",
                                  dtype=ref.dtype)
                errs = {"out": rel_err(got, ref)}
                errs.update(zip(names, (rel_err(g, r) for g, r in zip(
                    torch.autograd.grad(got, args, cot),
                    torch.autograd.grad(ref, args, cot)))))
                del got, ref, args
                bad = {k: r for k, (_, r) in errs.items() if r > TOL[dtype]}
                chunked = (name == "flash_attention"
                           and key[1] * key[2] > fa._CHUNKED_BWD_ELEMS)
                log(f"  {shape_label(name, key)} {str(dtype)[6:]}"
                    f"{' (chunked backward)' if chunked else ''}: " + ", ".join(
                        f"{k} {r:.2e}" for k, (_, r) in errs.items())
                    + f" (tol {TOL[dtype]:.0e}) {'FAIL' if bad else 'ok'}")
                if bad:
                    raise AssertionError(f"{name} {key} {dtype}: {bad}")
                worst = max(worst, *(a for a, _ in errs.values()))
            out[name][key] = worst
            torch.cuda.empty_cache()
    return out


def toy_training_phase(card_device="cuda", batch: int = TOY_TRAIN_BATCH):
    """8b: the trained 256^2 toy (K1 at 2048 tokens, K6 at >= 32 channels)
    trained as the toy is (``train_unet_full``), fp32, remat on, on a
    batch its VAE encodes from ``toy.build_dataset``, t and noise drawn on
    the CPU: one backward on the card and one on the CPU (loss within 1e-5
    relative, the global gradient norm within 1e-4 relative, each leaf's
    gradient within 1e-3 of that leaf's max |CPU gradient|), three
    optimizer steps on each side, and one bf16 step on the card, every K1
    and K6 launch of it on the tensor cores."""
    from blobctrl_torch import ops
    from blobctrl_torch.train import toy
    from blobctrl_torch.train import train_step as ts
    from blobctrl_torch.utils import threefry
    ckpt = os.path.join(ROOT, "assets", "toy_ckpt_256")
    (card, meta), (cpu, _) = (toy.load_toy(ckpt, device=dev,
                                           dtype=torch.float32)
                              for dev in (card_device, "cpu"))
    size = meta["size"]
    data = toy.encode_dataset(cpu.vae_params, cpu.vae_cfg, toy.build_dataset(
        batch, size=size, seed=8, ctx=meta["ctx"], dino_c=meta["dino_c"]))
    latent = (size // 8, size // 8, 4)
    t, noise = ts.draw_t_noise(threefry.key(8), batch,
                               latent, device="cpu")

    def state_and_step(pipe, dtype):
        cfg = ts.TrainConfig(learning_rate=1e-4, weight_decay=1e-3,
                             train_unet_full=True, compute_dtype=dtype)
        return (ts.init_train_state(cfg, pipe.blobnet_params,
                                    pipe.unet_params),
                ts.make_train_step(cfg, pipe.unet_cfg, pipe.blobnet_cfg))

    def backward(pipe):
        state, step = state_and_step(pipe, torch.float32)
        dev = pipe.device
        ops.reset_counts()
        t0 = time.perf_counter()
        loss, g = step.loss_and_grads(state, None, data, t.to(dev),
                                      noise.to(dev))
        norm = float(ts.global_norm(g))
        return (float(loss), norm, [x.cpu() for x in g],
                time.perf_counter() - t0, launch_counts())

    lc, nc, gc_, sc, counts = backward(card)
    ran = {k: counts[k] for k in EXACT}
    lp, np_, gp, sp, _ = backward(cpu)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gc_, gp))
    log(f"  toy 256^2 fp32 backward, B = {batch}: loss card {lc:.8f} cpu "
        f"{lp:.8f} (rel {abs(lc - lp) / lp:.2e}, tol 1e-05), grad norm card "
        f"{nc:.6f} cpu {np_:.6f} (rel {abs(nc - np_) / np_:.2e}, tol 1e-04), "
        f"worst leaf {worst:.2e} of its max |CPU gradient| (tol 1e-03) over "
        f"{len(gp)} leaves; card {sc:.2f} s, cpu {sp:.2f} s; card launches "
        f"{ran}")
    if not (abs(lc - lp) <= 1e-5 * lp and abs(nc - np_) <= 1e-4 * np_
            and worst <= 1e-3 and min(ran.values()) > 0):
        raise AssertionError("toy backward: card and CPU disagree")
    del gc_, gp
    trail = []
    for pipe in (card, cpu):
        state, step = state_and_step(pipe, torch.float32)
        trail.append([])
        for i in range(TOY_TRAIN_STEPS):
            tt, nn_ = ts.draw_t_noise(threefry.key(20 + i),
                                      batch, latent, device=pipe.device)
            state, m = step(state, None, data, tt, nn_)
            trail[-1].append(float(m["loss"]))
        del state
    log(f"  toy 256^2 fp32, {TOY_TRAIN_STEPS} AdamW steps: losses card "
        f"{[f'{x:.6f}' for x in trail[0]]}, cpu "
        f"{[f'{x:.6f}' for x in trail[1]]}")
    if not np.isfinite(trail).all():
        raise AssertionError(f"toy steps: {trail}")
    state, step = state_and_step(card, torch.bfloat16)
    ops.reset_counts()
    _, m = step(state, None, data, t.to(card.device), noise.to(card.device))
    bf16_loss = float(m["loss"])
    check_tensor_cores("toy 256^2 bf16 training step", launch_counts(),
                       EXACT)
    log(f"  toy 256^2 bf16 step on the card: loss {bf16_loss:.6f} (fp32: "
        f"{lc:.6f})")
    if not np.isfinite(bf16_loss):
        raise AssertionError(f"toy bf16 step: loss {bf16_loss}")


@contextlib.contextmanager
def no_plain_forward(step):
    """Count the plain flash and conv calls made inside the step's forward
    (``TrainStep.loss``) -> a list of their names; the backward recomputes
    the plain versions by design and is not counted."""
    from blobctrl_torch.ops import conv3x3 as cv
    from blobctrl_torch.ops import flash_attention as fa
    inside, calls = [False], []
    real_loss = step.loss
    patched = [(fa, "flash_attention_reference"),
               (cv, "conv3x3_reference")]
    reals = [getattr(m, n) for m, n in patched]

    def loss(*args):
        inside[0] = True
        try:
            return real_loss(*args)
        finally:
            inside[0] = False

    def spy(name, real):
        def call(*args, **kwargs):
            if inside[0]:
                calls.append(name)
            return real(*args, **kwargs)
        return call
    step.loss = loss
    for (m, n), real in zip(patched, reals):
        setattr(m, n, spy(n, real))
    try:
        yield calls
    finally:
        del step.loss
        for (m, n), real in zip(patched, reals):
            setattr(m, n, real)


def full_width_training(step, state, frozen):
    """8c: ``TRAIN_STEPS`` AdamW steps at each of ``TRAIN_BATCHES`` on the
    state of ``training_setup``: the loss and the gradient norm finite,
    LoRA B off zero after the first step, every BlobNet leaf finite at the
    end; per step the K1 and K6 launches, all on their tensor-core kernels,
    and no plain flash or conv in the forward pass; the step seconds
    (median of steps 2..), images per second and peak memory; then three
    more steps at the first batch size (``report_trace``: a warm-up, one
    traced, one timed untraced). -> the launches of every kernel over the
    counted steps."""
    from blobctrl_torch import ops
    from blobctrl_torch.params import export
    from blobctrl_torch.train import train_step as ts
    from blobctrl_torch.utils import threefry

    def draw(b, seed):
        return ts.draw_t_noise(threefry.key(seed), b,
                               TRAIN_LATENT, device="cuda")
    n_blob = ts.num_params(state["params"]["blobnet"])
    n_lora = ts.num_params(state["params"]["lora"])
    log(f"  trainables: BlobNet {n_blob} fp32 + LoRA {n_lora} (rank "
        f"{TRAIN_LORA_RANK}) = {n_blob + n_lora} parameters, AdamW on both; "
        f"the UNet frozen in bf16")
    b0 = TRAIN_BATCHES[0]
    ops.reset_counts()  # one forward alone (no grad: remat recomputes none)
    with torch.no_grad():
        step.loss(state["params"], frozen, ts.batch_to(
            train_batch(step, b0), "cuda"), *draw(b0, 0))
    fwd = {k: launch_counts()[k] for k in EXACT}
    log(f"  one forward alone launches {fwd}; remat launches the layers' "
        f"kernels again in the backward: K1 twice as many a step, K6 twice "
        f"less the convs outside the layers")
    totals = collections.Counter()
    with no_plain_forward(step) as plain_calls:
        for b in TRAIN_BATCHES:
            batch = train_batch(step, b, seed=10 + b)
            times, per_step = [], []
            torch.cuda.reset_peak_memory_stats()
            for i in range(TRAIN_STEPS):
                t, noise = draw(b, 100 * b + i)
                ops.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, frozen, batch, t, noise)
                loss, norm = float(m["loss"]), float(m["grad_norm"])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts = launch_counts()
                totals.update(counts)
                check_tensor_cores(f"training step B = {b} #{i + 1}", counts,
                                   EXACT)
                per_step.append({k: counts[k] for k in EXACT})
                if not (np.isfinite(loss) and np.isfinite(norm)) or min(
                        per_step[-1].values()) == 0 or any(
                        n for k, n in counts.items() if k not in EXACT):
                    raise AssertionError(f"step B = {b} #{i + 1}: loss {loss}"
                                         f", norm {norm}, launches {counts}")
                if plain_calls:
                    raise AssertionError(f"plain versions in the forward: "
                                         f"{collections.Counter(plain_calls)}")
                k1, k6 = (per_step[-1][k] for k in EXACT)
                if k1 != 2 * fwd["flash_attention"] or not (
                        fwd["conv3x3"] < k6 <= 2 * fwd["conv3x3"]):
                    raise AssertionError(f"step launches {per_step[-1]} "
                                         f"against the forward's {fwd}")
                if b == b0 and i == 0 and not any(
                        ab["B"].any() for ab in
                        state["params"]["lora"].values()):
                    raise AssertionError("LoRA B still zero after step 1")
                log(f"  B = {b} step {i + 1}: loss {loss:.5f}, grad norm "
                    f"{norm:.4f}, lr {m['lr']:.2e}, {times[-1]:.3f} s, "
                    f"launches {per_step[-1]}")
            med = statistics.median(times[1:])
            log(f"  B = {b}: step seconds (median of steps 2-{TRAIN_STEPS}) "
                f"{med:.3f}, {b / med:.3f} images/s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    bad = [k for k, p in export.flatten(state["params"]["blobnet"]).items()
           if not torch.isfinite(p).all()]
    if bad:
        raise AssertionError(f"BlobNet leaves not finite: {bad[:5]}")
    # where a step's device time goes (its launches not counted)
    batch = train_batch(step, b0, seed=10 + b0)
    report_trace(f"training step at B = {b0}", lambda: step(
        state, frozen, batch, *draw(b0, 0)))
    return totals


def write_scenes(data_root: str, size: int):
    """``CLI_SCENES`` seeded scenes (``train/toy.make_scene``: a coloured ellipse on a
    gradient) with their masks and a prompts.json, PNG by the port's
    codec."""
    from blobctrl_torch.train import toy
    from blobctrl_torch.utils import png
    os.makedirs(os.path.join(data_root, "images"))
    os.makedirs(os.path.join(data_root, "masks"))
    rng = np.random.RandomState(13)
    prompts = {}
    for i in range(CLI_SCENES):
        scene = toy.make_scene(rng, size)
        name = f"scene{i}"
        for sub, arr in (("images", scene["image"]), ("masks",
                                                      scene["mask"])):
            with open(os.path.join(data_root, sub, name + ".png"), "wb") as f:
                f.write(png.encode_png(arr))
        prompts[name] = f"a {toy.COLORS[scene['cls']][0]} ball"
    with open(os.path.join(data_root, "prompts.json"), "w") as f:
        json.dump(prompts, f)


class EventLog(logging.Handler):
    """The port's structured log events, as dicts."""

    def __init__(self):
        super().__init__()
        self.events = []

    def emit(self, record):
        try:
            self.events.append(json.loads(record.getMessage()))
        except ValueError:
            pass


def reload_export(models_root: str, export_dir: str, params, copy: str,
                  device="cuda"):
    """The exported BlobNet and LoRA put into a copy of the models root
    (links to the rest) and loaded with ``load_pipeline(dtype=bf16)``:
    every BlobNet leaf and the LoRA bit-equal to ``params`` as the loader
    casts them, each UNet LoRA target the fp32 merge of the adapter then
    the cast. -> the loaded pipeline."""
    from blobctrl_torch.models import lora as lora_lib
    from blobctrl_torch.params import export, io
    for dirpath, dirnames, filenames in os.walk(models_root):
        rel = os.path.relpath(dirpath, models_root)
        os.makedirs(os.path.join(copy, rel), exist_ok=True)
        if rel in (os.path.join("BlobCtrl", "blobnet"),
                   os.path.join("BlobCtrl", "unet_lora")):
            continue
        for f in filenames:
            os.symlink(os.path.join(dirpath, f), os.path.join(copy, rel, f))
    shutil.copy(os.path.join(models_root, "BlobCtrl", "blobnet",
                             "config.json"),
                os.path.join(copy, "BlobCtrl", "blobnet"))
    for sub, name in (("blobnet", "diffusion_pytorch_model.safetensors"),
                      ("unet_lora", "adapter_model.safetensors")):
        os.replace(os.path.join(export_dir, sub, name),
                   os.path.join(copy, "BlobCtrl", sub, name))
    pipe, secs = timed(lambda: io.load_pipeline(copy, dtype=torch.bfloat16,
                                                device=device))
    bf16 = torch.bfloat16
    got, want = (export.flatten(pipe.blobnet_params),
                 export.flatten(params["blobnet"]))
    bad = [k for k in want if not torch.equal(got[k],
                                              want[k].to(bf16))]
    lora = params["lora"]
    bad += [k for k, ab in lora.items() for n in ("A", "B")
            if not torch.equal(pipe._lora_tree[k][n], ab[n])]
    base = export.flatten(io.load_sd15_unet(os.path.join(
        models_root, "stable-diffusion-v1-5", "unet"), device=device))
    loaded = export.flatten(pipe.unet_params)
    for k, w in base.items():
        target = k.rsplit(".", 1)[0].replace(".", "/")
        if k.endswith(".kernel") and target in lora:
            w = lora_lib.merge_kernel(w, lora[target], 1.0, None)
        if not torch.equal(loaded[k], w.to(bf16)):
            bad.append("unet." + k)
    log(f"  load_pipeline of the copy with the export: {secs:.2f} s; "
        f"{len(want)} BlobNet leaves, {2 * len(lora)} LoRA leaves and "
        f"{len(base)} UNet leaves checked, {len(bad)} differ")
    if bad or len(got) != len(want):
        raise AssertionError(f"exported leaves differ: {bad[:5]}")
    return pipe


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@contextlib.contextmanager
def peak_rss(out: list):
    """Samples this process's resident memory every 5 ms while the block
    runs; appends the peak rise above its start (bytes) to ``out``."""
    start, peak, done = rss_bytes(), [0], threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], rss_bytes())
            done.wait(0.005)
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield
    finally:
        done.set()
        t.join()
        out.append(max(peak[0], rss_bytes()) - start)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(path) for n in names)


@contextlib.contextmanager
def timed_checkpoints(out: list):
    """``train.checkpoint.save`` / ``restore`` timed while the block runs
    (device synchronized around each): appends (kind, seconds, bytes on
    disk, the read's peak host memory rise or None) to ``out``."""
    from blobctrl_torch.train import checkpoint as ckpt_lib
    real = ckpt_lib.save, ckpt_lib.restore

    def save(*a, **k):
        path, secs = timed(lambda: real[0](*a, **k))
        out.append(("write", secs, _dir_bytes(path), None))
        return path

    def restore(ckpt_dir, step=None, device="cuda"):
        peak = []
        with peak_rss(peak):
            state, secs = timed(lambda: real[1](ckpt_dir, step, device))
        s = ckpt_lib.latest_step(ckpt_dir) if step is None else step
        out.append(("read", secs, _dir_bytes(os.path.join(
            ckpt_dir, f"step_{s:08d}")), peak[0]))
        return state
    ckpt_lib.save, ckpt_lib.restore = save, restore
    try:
        yield
    finally:
        ckpt_lib.save, ckpt_lib.restore = real


def cli_training_phase(models_root: str, work: str, device="cuda",
                       size: int = 512, edit_steps: int = CLI_EDIT_STEPS):
    """8d: ``python -m blobctrl_torch.apps.train_cli`` (its ``main``) on the
    models root at ``size``: 2 per batch, CLI_STEPS[0] steps with a
    checkpoint at the last and the export, then ``--resume`` to
    CLI_STEPS[1] (it must start at CLI_STEPS[0]);
    the export put into a copy of the root (links to the rest) and loaded
    with ``load_pipeline(dtype=bf16)``: every BlobNet leaf and the LoRA
    bit-equal to the trained state as the loader casts them, each UNet
    LoRA target the fp32 merge of the trained adapter then the cast; one
    edit from the copy, K1 and K6 on the tensor cores. Seconds of each
    stage printed."""
    from blobctrl_torch import ops
    from blobctrl_torch.apps import train_cli
    data_root = os.path.join(work, "train_data")
    ckpt_dir = os.path.join(work, "train_ckpts")
    export_dir = os.path.join(work, "train_export")
    write_scenes(data_root, size)
    events = EventLog()
    logging.getLogger("blobctrl_torch").addHandler(events)
    first_n, last_n = CLI_STEPS
    argv = ["--models_root", models_root, "--data_root", data_root,
            "--size", str(size), "--batch_size", "2", "--ckpt_every",
            str(first_n),
            "--log_every", "1", "--ckpt_dir", ckpt_dir, "--export_dir",
            export_dir, "--device", str(device)]
    io_log = []
    try:
        with timed_checkpoints(io_log):
            state, secs = timed(lambda: train_cli.main(
                argv + ["--steps", str(first_n)]))
        first = list(events.events)
        del state
        steps = sorted(os.listdir(ckpt_dir))
        if steps != [f"step_{first_n:08d}"]:
            raise AssertionError(f"checkpoints {steps}")
        with open(os.path.join(ckpt_dir, steps[0], "_METADATA")) as f:
            if not json.load(f).get("use_ocdbt"):
                raise AssertionError("8d: the checkpoint is not in the JAX "
                                     "package's layout")
        events.events.clear()
        with timed_checkpoints(io_log):
            state, secs2 = timed(lambda: train_cli.main(
                argv + ["--steps", str(last_n), "--resume"]))
        second = list(events.events)
    finally:
        logging.getLogger("blobctrl_torch").removeHandler(events)
    for kind, secs_io, nbytes, peak in io_log:
        log(f"  checkpoint {kind} (the JAX package's layout: OCDBT, zarr): "
            f"{secs_io:.2f} s, {nbytes / 1e9:.3f} GB"
            + ("" if peak is None else
               f", peak host memory rise {peak / 2 ** 30:.2f} GiB"))
    trained = [e for e in first if e.get("event") == "train"]
    resumed = [e for e in second if e.get("event") == "resumed"]
    later = [e for e in second if e.get("event") == "train"]
    log(f"  train_cli, {first_n} steps at B = 2 from {CLI_SCENES} scenes: "
        f"{secs:.2f} s (load, data, steps, a checkpoint at {first_n}, "
        f"export); "
        + ", ".join(f"step {e['step']} loss {e['loss']} "
                    f"{e['sec_per_step']} s" for e in trained))
    log(f"  --resume --steps {last_n}: {secs2:.2f} s; resumed at "
        f"{[e['step'] for e in resumed]}; " + ", ".join(
            f"step {e['step']} loss {e['loss']} {e['sec_per_step']} s"
            for e in later))
    if [e["step"] for e in trained] != list(range(1, first_n + 1)) or [
            e["step"] for e in resumed] != [first_n] or [
            e["step"] for e in later] != list(
                range(first_n + 1, last_n + 1)) or state["step"] != last_n \
            or not all(np.isfinite(e["loss"]) for e in trained + later):
        raise AssertionError(f"train_cli: {first} / {second}")
    shutil.rmtree(ckpt_dir)
    pipe = reload_export(models_root, export_dir, state["params"],
                         os.path.join(work, "models_root_trained"), device)
    del state
    ops.reset_counts()
    out, secs, launches, mem = run_request(pipe, text_edit_kwargs(
        size, edit_steps))
    check_tensor_cores("edit from the trained export", launch_counts(),
                       EXACT)
    log(f"  {edit_steps}-step edit from the trained copy: {secs:.3f} s, "
        f"launches {({k: n for k, n in launches.items() if n})}, peak "
        f"memory {mem:.2f} GiB")
    if min(launches[k] for k in EXACT) == 0:
        raise AssertionError(f"edit from the export: launches {launches}")


ORBAX_FIXTURE = os.path.join(ROOT, "tests", "data", "orbax")
DECODE_BYTES = 256 * 2 ** 20   # 8e: the weights frame decoded to this much
DECODE_THREADS = 8             # as train/checkpoint.READ_THREADS
JAX_STATE_BYTES = 10.18e9      # 8c's state (params, mu, nu) in JAX's layout


def leaf_record(tree) -> dict:
    """{dotted name: [dtype, shape, sha256[:16] of its bytes, float64 sum,
    first 2 elements]} of a tree's tensors, as
    ``scripts/torch_orbax_fixtures.py`` records JAX's."""
    import hashlib
    from blobctrl_torch.train import checkpoint as ckpt_lib
    out = {}
    for keys, t in ckpt_lib._tree_leaves(tree, ()):
        if t is None:
            continue
        t = t.cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
               ).numpy()
        vals = t.float().numpy() if t.dtype == torch.bfloat16 else raw
        out[".".join(k for k, _ in keys)] = [
            str(t.dtype).removeprefix("torch."), list(raw.shape),
            hashlib.sha256(raw.tobytes()).hexdigest()[:16],
            float(vals.astype(np.float64).sum()),
            vals.reshape(-1)[:2].tolist()]
    return out


def fixture_frames(step_dir: str):
    """Every zstd frame of an orbax step directory: its chunks' values and
    the bodies of its manifests and root b-tree nodes (each file range is
    a 14-byte header, the body, a 4-byte CRC)."""
    from blobctrl_torch.params import ocdbt
    magic = (0xFD2FB528).to_bytes(4, "little")
    frames = []
    for root in (step_dir, os.path.join(step_dir, "ocdbt.process_0")):
        with ocdbt.Store(root) as store:
            with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
                ranges = [f.read()]
            ranges += [store.read(v["root"].path, v["root"].offset,
                                  v["root"].length)
                       for v in store.versions if v["num_keys"]]
            frames += [r[14:-4] for r in ranges if r[13] == 1]
            if root == step_dir:
                frames += [v for v in map(store.get, store.keys())
                           if v[:4] == magic]
    return frames


def decoder_rates(frame: bytes, size: int):
    """MB/s of the compiled decoder on ``frame`` (``size`` bytes out):
    one thread decoding it again and again to DECODE_BYTES, then
    DECODE_THREADS threads at once, each to DECODE_BYTES / threads."""
    from concurrent.futures import ThreadPoolExecutor
    from blobctrl_torch.params import ocdbt
    reps = -(-DECODE_BYTES // size)

    def run(n):
        buf = np.empty(size, np.uint8)
        for _ in range(n):
            ocdbt.zstd_decompress(frame, out=buf)
    t0 = time.perf_counter()
    run(reps)
    one = reps * size / (time.perf_counter() - t0) / 1e6
    each = -(-reps // DECODE_THREADS)
    with ThreadPoolExecutor(DECODE_THREADS) as pool:
        t0 = time.perf_counter()
        list(pool.map(run, [each] * DECODE_THREADS))
        many = each * DECODE_THREADS * size / (time.perf_counter() - t0) / 1e6
    return reps * size, one, many


def orbax_fixture_phase(work: str, device="cuda"):
    """8e: the committed JAX-written checkpoint (``tests/data/orbax``,
    ``scripts/torch_orbax_fixtures.py``). Part one: its tree read on the
    card and on the CPU, every leaf bit-equal between them and to the
    digests, sums and first elements JAX recorded; the training CLI
    resumes it on the card and on the CPU (fp32, TF32 off) for 2 steps
    on the roots ``benchkit.write_tiny_training_roots`` rebuilds: losses
    within 1e-5 relative and each step's gradients within 1e-3 of each
    leaf's max |CPU gradient| (8b's bars), the final states within the
    step bound, and both runs' losses within 1e-5 of JAX's. Part two: the
    compiled decoder bit-equal to the plain one on every frame of the
    fixture, and its MB/s on the committed weights frame, with the read
    time of 8c's state in JAX's layout projected from it."""
    from blobctrl_torch.apps import train_cli
    from blobctrl_torch.params import ocdbt
    from blobctrl_torch.train import checkpoint as ckpt_lib
    from blobctrl_torch.train import train_step as ts
    from blobctrl_torch.utils import benchkit, zstd
    t_phase = time.perf_counter()
    step_dir = os.path.join(ORBAX_FIXTURE, "step_00000002")
    with open(os.path.join(ORBAX_FIXTURE, "jax_run.json")) as f:
        record = json.load(f)
    (card, secs), cpu = timed(lambda: ckpt_lib.read_tree(
        step_dir, device=device)), ckpt_lib.read_tree(step_dir, "cpu")
    got, host = leaf_record(card), leaf_record(cpu)
    bad = sorted(k for k in record["leaves"]
                 if got.get(k) != record["leaves"][k] or host.get(k) !=
                 record["leaves"][k])
    log(f"  the fixture's {len(got)} leaves read on {device} in {secs:.2f} "
        f"s: {len(bad)} differ from the CPU read or from JAX's record")
    if bad or set(got) != set(record["leaves"]):
        raise AssertionError(f"8e: leaves {bad[:5]}")
    models, data = (os.path.join(work, "orbax_models"),
                    os.path.join(work, "orbax_data"))
    benchkit.write_tiny_training_roots(models, data)
    runs = {}
    for dev in (device, "cpu"):
        ckpts = os.path.join(work, f"orbax_ckpts_{torch.device(dev).type}")
        shutil.copytree(ORBAX_FIXTURE, ckpts, ignore=shutil.ignore_patterns(
            "*.json", "*.zst"))
        argv = [a.replace("MODELS", models).replace("DATA", data)
                .replace("CKPTS", ckpts) for a in record["argv"]]
        with tests_module("torch_ranks").fp32_train_steps() as rec:
            state, secs = timed(lambda: train_cli.main(
                argv + ["--device", str(dev)]))
        runs[dev] = (rec, ts.tree_map(lambda t: t.cpu() if torch.is_tensor(
            t) else t, state), secs)
        shutil.rmtree(ckpts)
    (card_rec, card_state, card_s), (cpu_rec, cpu_state, cpu_s) = \
        runs[device], runs["cpu"]
    want = [record["losses"]["3"], record["losses"]["4"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(card_rec["loss"],
                                               cpu_rec["loss"])]
    rel_jax = [abs(a - b) / abs(b) for r in (card_rec, cpu_rec)
               for a, b in zip(r["loss"], want)]
    grad = max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for gs, ws in zip(card_rec["grads"], cpu_rec["grads"])
               for g, w in zip(gs, ws))
    worst, far, total = state_distance(card_state, cpu_state, 4, 1e-3)
    log(f"  the CLI resumed the fixture to step 4: {device} {card_s:.2f} s,"
        f" cpu {cpu_s:.2f} s; losses {card_rec['loss']} / {cpu_rec['loss']}"
        f" (rel {max(rel):.2e}, tol 1e-05), JAX's {want} (rel "
        f"{max(rel_jax):.2e}, tol 1e-05); gradients {grad:.2e} of each "
        f"leaf's max (tol 1e-03); final state {worst:.3f} of the step "
        f"bound, {far} of {total} elements past 1e-3 lr")
    if len(card_rec["loss"]) != 2 or max(rel) > 1e-5 or max(rel_jax) > 1e-5 \
            or grad > 1e-3 or worst > 1 or far > 1e-3 * total \
            or card_state["step"] != 4:
        raise AssertionError("8e: the resumed fixture on the card")
    # part two: the decoder
    frames = fixture_frames(step_dir)
    with open(os.path.join(ORBAX_FIXTURE, "weights_l1.zst"), "rb") as f:
        weights = f.read()
    frames.append(weights)
    t0 = time.perf_counter()
    differ = sum(zstd.decompress(f) != ocdbt.zstd_decompress(f).tobytes()
                 for f in frames)
    log(f"  compiled against plain zstd decoder on the fixture's "
        f"{len(frames)} frames: {differ} differ "
        f"({time.perf_counter() - t0:.2f} s)")
    if differ:
        raise AssertionError("8e: the compiled zstd decoder differs")
    size = 4 * record["weights"]["elements"]
    total_b, one, many = decoder_rates(weights, size)
    log(f"  compiled decoder on the {len(weights)}-byte level-1 weights "
        f"frame ({size} bytes out), {total_b / 1e6:.0f} MB decoded: "
        f"{one:.1f} MB/s on one host thread, {many:.1f} MB/s on "
        f"{DECODE_THREADS}; projected read of 8c's {JAX_STATE_BYTES / 1e9:.2f}"
        f" GB state written by JAX (level 1): "
        f"{JAX_STATE_BYTES / (many * 1e6):.1f} s decoding on "
        f"{DECODE_THREADS} threads ({JAX_STATE_BYTES / (one * 1e6):.1f} s "
        f"on one)")
    log(f"  8e took {time.perf_counter() - t_phase:.1f} s")


def training_phase(models_root: str, work: str):
    """Phase 8 on the card. -> ({kernel: 8a's worst abs error},
    {kernel: 8c's launches})."""
    t_phase = time.perf_counter()
    step, state, frozen = training_setup()
    shapes = record_training_shapes(step, state, frozen)
    log("  8a: the Functions at the K1 and K6 shapes of one full-width "
        "training step at B = " + ", ".join(map(str, TRAIN_BATCHES)) + ": "
        + ", ".join(f"{k} {len(v)}" for k, v in shapes.items()))
    t0 = time.perf_counter()
    errs = check_training_functions(shapes)
    log(f"  8a took {time.perf_counter() - t0:.1f} s")
    log("  8b: the trained 256^2 toy, card against CPU")
    t0 = time.perf_counter()
    toy_training_phase()
    log(f"  8b took {time.perf_counter() - t0:.1f} s")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = TF32_DEFAULTS
    log(f"  8c and 8d on PyTorch's TF32 switches (cuDNN, cuBLAS) "
        f"{TF32_DEFAULTS}, as train_cli runs; the backward's VJPs turn both "
        f"off for their own calls")
    log(f"  8c: full width, 512^2 double width (64 x 128 latents), remat, "
        f"bf16, B = " + ", ".join(map(str, TRAIN_BATCHES)) + f", "
        f"{TRAIN_STEPS} steps each")
    t0 = time.perf_counter()
    totals = full_width_training(step, state, frozen)
    log(f"  8c took {time.perf_counter() - t0:.1f} s")
    del step, state, frozen
    torch.cuda.empty_cache()
    log("  8d: the training CLI on phase 6's models root")
    t0 = time.perf_counter()
    cli_training_phase(models_root, work)
    log(f"  8d took {time.perf_counter() - t0:.1f} s")
    log("  8e: the committed checkpoint of the JAX package's training CLI")
    orbax_fixture_phase(work)
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return errs, totals


# ---------------------------------------------------------------------------
# phase 9: the edit sharded over ranks that share the one card
# ---------------------------------------------------------------------------

PARALLEL_TOY_STEPS = 10   # 9a's toy edits
PARALLEL_FULL_STEPS = 2   # 9b's full-width edits
PARALLEL_BATCH = 4        # 9a's edit_batch rows
PARALLEL_TIMEOUT_S = 600.0  # the ranks' collective timeout and our wait
PARALLEL_BAR_DB = 40.0
# rank groups: (world, [job, ...]); every rank of a group runs its jobs
PARALLEL_GROUPS = ((2, ("toy_model", "toy_data", "full_model",
                        "shapes_model2", "toy_photo_model")),
                   (4, ("toy_hybrid", "full_hybrid", "shapes_model4",
                        "toy_photo_hybrid")))
_RANK = {}  # a rank process's pipelines, loaded once
# full-width one-step edits at PHOTO, sharded: {job: (mesh shape, recipe)}
PHOTO_SHARDED = {"photo_model2": ({"data": 1, "model": 2}, "model"),
                 "photo_model4": ({"data": 1, "model": 4}, "model"),
                 "photo_hybrid": ({"data": 2, "model": 2}, "hybrid")}


def parallel_toy_requests():
    """9a's edit_batch: PARALLEL_BATCH toy requests (their own ellipses and
    seeds) and the shared sampler arguments."""
    from blobctrl_torch.blob import math as blob_math
    move = toy_edits(256, PARALLEL_TOY_STEPS)["move"]
    shared = {k: move[k] for k in ("height", "width", "num_inference_steps",
                                   "guidance_scale")}
    reqs = []
    for b in range(PARALLEL_BATCH):
        dst = ((256 * (0.5 + 0.05 * b), 256 * 0.55), (77.0, 102.0),
               20.0 + 30 * b)
        reqs.append(dict(
            {k: move[k] for k in ("fg_image", "bg_image", "prompt_embeds",
                                  "negative_prompt_embeds",
                                  "fg_dino_feats")},
            gs_score=blob_math.blob_score_from_ellipse(
                dst, 256, 256, (32, 32)).numpy(), seed=40 + b))
    return reqs, shared


def parallel_edits():
    """-> {"toy": the move edit, "toy_photo": the move edit at
    TOY_PHOTO_SIZES[1] (W x H), "full": phase 4's standard edit at
    PARALLEL_FULL_STEPS steps, "one_step": phase 2's one-step edit,
    "photo_one_step": the same at PHOTO (W x H)}, seeded, so no rank draws
    a seed of its own."""
    from blobctrl_torch.utils import benchkit
    w, h = TOY_PHOTO_SIZES[1]
    return {"toy": dict(toy_edits(256, PARALLEL_TOY_STEPS)["move"], seed=0),
            "toy_photo": dict(toy_edits(h, PARALLEL_TOY_STEPS,
                                        width=w)["move"], seed=0),
            "full": dict(benchkit.standard_edit_kwargs(
                512, PARALLEL_FULL_STEPS), seed=0),
            "one_step": dict(benchkit.standard_edit_kwargs(512, 1),
                             blobnet_control_guidance_end=1.0, seed=0),
            "photo_one_step": photo_edit_kwargs(
                PHOTO, 1, blobnet_control_guidance_end=1.0, seed=0)}


def _rank_pipe(which):
    from blobctrl_torch.train import toy
    from blobctrl_torch.utils import benchkit
    if which not in _RANK:
        _RANK.clear()   # the peak memory a rank reports is this pipe's
        gc.collect()
        torch.cuda.empty_cache()
        if which == "toy":
            _RANK[which], _ = toy.load_toy(
                os.path.join(ROOT, "assets", "toy_ckpt_256"), device="cuda",
                dtype=torch.float32)
        else:
            _RANK[which] = benchkit.make_flagship_pipe(
                seed=0, device="cuda", dtype=torch.bfloat16)
    return _RANK[which]


def _sharded_run(which, shape, recipe, fn, digests=False):
    """Shard rank pipeline ``which`` by ``recipe`` over a mesh of ``shape``
    and run ``fn(pipe)``, the launch counters and the collective log zeroed
    just before and read just after. -> what this rank saw."""
    import hashlib
    from blobctrl_torch import ops
    from blobctrl_torch.models import blobnet as blobnet_lib
    from blobctrl_torch.parallel import collectives
    from blobctrl_torch.parallel import mesh as mesh_lib
    pipe = _rank_pipe(which)
    pipe.shard_to_mesh(mesh_lib.make_mesh(**shape),
                       model_parallel=recipe != "data",
                       hybrid_cfg_data=recipe == "hybrid")
    seen, apply = [], blobnet_lib.blobnet_apply
    if digests:   # BlobNet's residuals, hashed step by step
        def hashed(*a, **k):
            res = apply(*a, **k)
            h = hashlib.blake2b(digest_size=8)
            for r in list(res[0]) + [res[1]] + list(res[2]):
                h.update(r.float().cpu().numpy().tobytes())
            seen.append(h.hexdigest())
            return res
        blobnet_lib.blobnet_apply = hashed
    try:
        collectives.barrier()  # every rank built and sharded: start together
        ops.reset_counts()
        collectives.reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(pipe)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        blobnet_lib.blobnet_apply = apply
    return {"images": out, "secs": secs, "launches": launch_counts(),
            "tc": tensor_core_counts(),
            "shapes": {k: dict(v) for k, v in launch_shapes().items()},
            "collectives": collectives.summary(),
            "counts": collectives.counts(), "digests": seen,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _job_name(job) -> str:
    """A rank job is its name (phase 9) or (name, payload) (phase 10)."""
    return job if isinstance(job, str) else job[0]


def _rank_job(job):
    if not isinstance(job, str):
        return DP_JOBS[job[0]](job[1])
    edits = parallel_edits()
    if job == "toy_model":
        return _sharded_run("toy", {"data": 1, "model": 2}, "model",
                            lambda p: p(**edits["toy"]).images)
    if job == "toy_hybrid":
        return _sharded_run("toy", {"data": 2, "model": 2}, "hybrid",
                            lambda p: p(**edits["toy"]).images, digests=True)
    if job in ("toy_photo_model", "toy_photo_hybrid"):
        shape = ({"data": 1, "model": 2} if job == "toy_photo_model"
                 else {"data": 2, "model": 2})
        return _sharded_run("toy", shape, job[10:],
                            lambda p: p(**edits["toy_photo"]).images,
                            digests=job == "toy_photo_hybrid")
    if job == "toy_data":
        reqs, shared = parallel_toy_requests()
        return _sharded_run("toy", {"data": 2, "model": 1}, "data",
                            lambda p: p.edit_batch(reqs, **shared).images)
    if job in ("full_model", "full_hybrid"):
        shape = ({"data": 1, "model": 2} if job == "full_model"
                 else {"data": 2, "model": 2})
        return _sharded_run("full", shape, job[5:],
                            lambda p: p(**edits["full"]).images)
    if job in PHOTO_SHARDED:   # scripts/torch_nccl_mesh.py's, a card a rank
        shape, recipe = PHOTO_SHARDED[job]
        return _sharded_run("full", shape, recipe,
                            lambda p: p(**edits["photo_one_step"]).images)

    def one_step_each_mode(pipe):
        for mode in MODES:
            with mode_context(mode):
                pipe(**edits["one_step"])
            pipe._param_cache.clear()  # the mode's derived weights
        return None
    model = 2 if job == "shapes_model2" else 4
    return _sharded_run("full", {"data": 1, "model": model}, "model",
                        one_step_each_mode)


STAGING = "_staging"   # a rank's [collectives, staged through host memory]


def count_staging():
    """Count this process's collectives and those staged through host
    memory: -> the [calls, staged] list the wrapper keeps."""
    from blobctrl_torch.parallel import collectives
    real, seen = collectives._staged, [0, 0]

    def staged(t, group):
        s = real(t, group)
        seen[0] += 1
        seen[1] += int(s)
        return s
    collectives._staged = staged
    return seen


def _rank_main(rank, world, port, jobs, device, backend, out):
    """One rank of a phase-9 or phase-10 group, over ``backend``: gloo
    with every rank on ``device`` (cuda:0, or the CPU for 10d's
    reference), or nccl with ``device`` "cuda", rank r on cuda:r. ->
    {job: its result, STAGING: this rank's collectives}."""
    import traceback
    try:
        sys.path.insert(0, ROOT)
        from blobctrl_torch.parallel import multihost
        seen = count_staging()
        multihost.initialize(f"127.0.0.1:{port}", world, rank,
                             device=device, backend=backend,
                             timeout_s=PARALLEL_TIMEOUT_S)
        try:
            got = {_job_name(job): _rank_job(job) for job in jobs}
            got[STAGING] = list(seen)
            out.put((rank, "ok", got))
        finally:
            multihost.shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


def collect(out, procs, deadline_s):
    """The next (rank, "ok" | "error", value) of every process in
    ``procs`` from ``out`` -> their values in rank order. A rank that
    fails, dies or is late raises AssertionError."""
    import queue
    got, deadline = {}, time.monotonic() + deadline_s
    while len(got) < len(procs):
        try:
            rank, status, value = out.get(timeout=5.0)
        except queue.Empty:
            if time.monotonic() > deadline or any(
                    p.exitcode not in (None, 0) for p in procs):
                raise AssertionError(
                    f"ranks {sorted(set(range(len(procs))) - set(got))} "
                    f"gave no result (exit codes "
                    f"{[p.exitcode for p in procs]})")
            continue
        if status != "ok":
            raise AssertionError(f"rank {rank} failed:\n{value}")
        got[rank] = value
    return [got[r] for r in range(len(procs))]


def join(procs):
    """Join every process, killing any still alive after 30 s."""
    for p in procs:
        p.join(30.0)
        if p.is_alive():
            p.kill()
            p.join(10.0)


def spawn(target, world: int, args, meanwhile=None):
    """``target(rank, world, port, *args, out)`` on ``world`` spawned
    processes, each putting (rank, "ok" | "error", value) on ``out``, and
    ``meanwhile()`` here while they start and run; -> their values in rank
    order (``collect``, within PARALLEL_TIMEOUT_S). Every process is
    joined, or killed, before this returns."""
    import multiprocessing
    from blobctrl_torch.parallel import multihost
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = multihost.free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        if meanwhile is not None:
            meanwhile()
        return collect(out, procs, deadline - time.monotonic())
    finally:
        join(procs)


def spawn_ranks(world: int, jobs, meanwhile=None, device="cuda:0",
                backend="gloo"):
    """Run ``jobs`` on ``world`` spawned ranks (``_rank_main``: gloo on
    ``device``, or nccl a card a rank with ``device`` "cuda"), and
    ``meanwhile()`` here; -> their results in rank order. A rank that
    fails or dies fails the phase."""
    return spawn(_rank_main, world, (jobs, device, backend),
                 meanwhile=meanwhile)


def _local(run, name, reference_keys):
    """Launch keys of kernel ``name`` that the unsharded run never had."""
    return set(run["shapes"][name]) - set(reference_keys[name])


def parallel_phase(results):
    """Phase 9. ``results``: phase 2's checked shapes, extended with the
    local shapes found here. -> {kernel: launches of the sharded edits,
    summed over ranks}."""
    from blobctrl_torch import ops
    from blobctrl_torch.parallel import collectives
    from blobctrl_torch.train import toy
    from blobctrl_torch.utils import benchkit
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    edits = parallel_edits()
    card, _ = toy.load_toy(os.path.join(ROOT, "assets", "toy_ckpt_256"),
                           device="cuda", dtype=torch.float32)
    ops.reset_counts()
    ref_toy = card(**edits["toy"]).images
    keys_toy = launch_shapes()
    ops.reset_counts()
    ref_photo, secs_photo = timed(lambda: card(**edits["toy_photo"]).images)
    keys_photo = launch_shapes()
    ops.reset_counts()
    reqs, shared = parallel_toy_requests()
    ref_batch = card.edit_batch(reqs, **shared).images
    keys_batch = launch_shapes()
    del card
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()   # what earlier phases still hold
    flag = benchkit.make_flagship_pipe(seed=0, device="cuda",
                                       dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    ref_full, secs_full = timed(lambda: flag(**edits["full"]).images)
    peak_full = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del flag
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  the unsharded references on the card: the toy move edit, the "
        f"toy batch of {PARALLEL_BATCH}, the full-width edit "
        f"({PARALLEL_FULL_STEPS} steps, {secs_full:.3f} s, peak memory "
        f"{peak_full:.2f} GiB)")
    log("  the ranks below share this ONE card over gloo (collectives go "
        "through host memory): their seconds say nothing of the recipes' "
        "speed on one card a rank over NCCL, and are for information only")
    runs = {}
    for world, jobs in PARALLEL_GROUPS:
        t0 = time.perf_counter()
        ranks = spawn_ranks(world, jobs)
        log(f"  {world} ranks on cuda:0 ran {', '.join(jobs)} in "
            f"{time.perf_counter() - t0:.1f} s (spawn, load and shard "
            f"included)")
        for job in jobs:
            runs[job] = [r[job] for r in ranks]
    ucfg, bcfg, vcfg = toy.toy_configs(size=256)
    from blobctrl_torch.apps import flagship
    from blobctrl_torch.pipeline.blobnet_pipeline import blobnet_keep_schedule
    fcfg = (flagship.sd15_unet_config(), flagship.blobctrl_blobnet_config(),
            flagship.sd15_vae_config())
    blobnet_steps = int(blobnet_keep_schedule(   # BlobNet's control window
        PARALLEL_FULL_STEPS, 0.0,
        edits["full"]["blobnet_control_guidance_end"]).sum())
    launched = collections.Counter()
    # 9a: the trained toy, fp32, against the same edit unsharded on the card
    for job, shape, recipe, ref, keys in (
            ("toy_model", {"data": 1, "model": 2}, "model", ref_toy,
             keys_toy),
            ("toy_data", {"data": 2, "model": 1}, "data", ref_batch,
             keys_batch),
            ("toy_hybrid", {"data": 2, "model": 2}, "hybrid", ref_toy,
             keys_toy),
            ("toy_photo_model", {"data": 1, "model": 2}, "model", ref_photo,
             keys_photo),
            ("toy_photo_hybrid", {"data": 2, "model": 2}, "hybrid",
             ref_photo, keys_photo)):
        expected = collectives.expected_counts(
            ucfg, bcfg, vcfg, shape, recipe, PARALLEL_TOY_STEPS,
            data_split=recipe == "data")
        for rank, run in enumerate(runs[job]):
            if run["images"].shape != ref.shape:
                raise AssertionError(f"{job} rank {rank}: "
                                     f"{run['images'].shape}")
            rows = [psnr(run["images"][b:b + 1], ref[b:b + 1])
                    for b in range(ref.shape[0])]
            local = {k: len(_local(run, k, keys)) for k in EXACT}
            log(f"  9a {job} rank {rank}: PSNR against the unsharded card "
                f"edit {', '.join(f'{p:.2f}' for p in rows)} dB; launches "
                f"{ {k: run['launches'][k] for k in EXACT} }, shapes the "
                f"unsharded edit never launched {local}; collectives "
                f"{run['counts']}")
            if not min(rows) >= PARALLEL_BAR_DB:
                raise AssertionError(f"{job} rank {rank}: {rows} dB")
            if min(local.values()) == 0 or min(
                    run["launches"][k] for k in EXACT) == 0:
                raise AssertionError(f"{job} rank {rank}: K1 or K6 not at "
                                     f"local shapes: {local}")
            if run["counts"] != expected:
                raise AssertionError(f"{job} rank {rank}: collectives "
                                     f"{run['counts']} != {expected}")
            launched.update({k: run["launches"][k] for k in EXACT})
    for job in ("toy_hybrid", "toy_photo_hybrid"):
        digests = [run["digests"] for run in runs[job]]
        if len(digests[0]) != PARALLEL_TOY_STEPS or any(
                d != digests[0] for d in digests):
            raise AssertionError(f"{job}: BlobNet's residuals differ "
                                 f"across ranks")
        log(f"  9a {job}: BlobNet's residuals bit-equal on all 4 ranks at "
            f"every one of {PARALLEL_TOY_STEPS} steps")
    # 9b: full width, bf16, random weights
    for job, shape in (("full_model", {"data": 1, "model": 2}),
                       ("full_hybrid", {"data": 2, "model": 2})):
        recipe = job[5:]
        expected = collectives.expected_counts(
            *fcfg, shape, recipe, PARALLEL_FULL_STEPS,
            blobnet_steps=blobnet_steps)
        for rank, run in enumerate(runs[job]):
            check_tensor_cores(f"9b {job} rank {rank}", run["launches"],
                               EXACT, run["tc"])
            if run["counts"] != expected:
                raise AssertionError(f"{job} rank {rank}: collectives "
                                     f"{run['counts']} != {expected}")
            summ = run["collectives"]
            step = {op: [sum(summ.get(s, {}).get(op, {}).get(f, 0)
                             for s in ("unet", "blobnet", "pipeline"))
                         for f in ("count", "bytes", "seconds")]
                    for op in ("all_reduce", "all_gather")}
            vae = {op: [c[f] for f in ("count", "bytes", "seconds")]
                   for op, c in summ.get("vae", {}).items()}
            n = PARALLEL_FULL_STEPS
            log(f"  9b {job} rank {rank}: PSNR against the unsharded edit "
                f"{psnr(run['images'], ref_full):.2f} dB (for information), "
                f"peak memory {run['peak_gib']:.2f} GiB, launches "
                f"{ {k: run['launches'][k] for k in EXACT} }")
            for op, (c, b, sec) in step.items():
                log(f"    {op} a step (UNet, BlobNet, the pipeline's): "
                    f"{c / n:.1f} calls, {b / n / 2 ** 20:.1f} MiB, "
                    f"{sec / n:.3f} s inside them")
            log(f"    the VAE's (once an edit): " + ", ".join(
                f"{op} {c} calls {b / 2 ** 20:.1f} MiB {sec:.3f} s"
                for op, (c, b, sec) in vae.items()))
            log(f"    seconds an edit, ranks sharing one card over gloo "
                f"(information only): {run['secs']:.3f}")
            if job == "full_model" and not run["peak_gib"] < peak_full:
                raise AssertionError(
                    f"{job} rank {rank}: peak {run['peak_gib']:.2f} GiB, "
                    f"not below the unsharded edit's {peak_full:.2f} GiB")
            launched.update({k: run["launches"][k] for k in EXACT})
    # 9c: phase 2's bars at every local shape the one-step edits launched,
    # and the toy's at a photo's size
    photo_jobs = ("toy_photo_model", "toy_photo_hybrid")
    for group, jobs in (("one-step edits at model=2 and model=4, each mode",
                         ("shapes_model2", "shapes_model4")),
                        (f"the toy at {TOY_PHOTO_SIZES[1][0]}x"
                         f"{TOY_PHOTO_SIZES[1][1]} (W x H) at model=2 and "
                         f"hybrid 2 x 2", photo_jobs)):
        t0, new = time.perf_counter(), collections.defaultdict(set)
        for job in jobs:
            for run in runs[job]:
                if job not in photo_jobs:   # 9a counted the toy's launches
                    launched.update(run["launches"])  # every mode's kernels
                for name, per in run["shapes"].items():
                    if name in results:
                        new[name] |= set(per) - set(results[name])
        log(f"  9c: local shapes of {group}, not checked before: "
            + ", ".join(f"{k} {len(v)}" for k, v in sorted(new.items())))
        for name, rows in check_kernels(dict(new), timing=False).items():
            results[name].update(rows)
    # the sharded photo-size edits' own seconds: the unsharded reference,
    # each job's slowest rank, their shapes' checks
    LARGE_SECONDS["phase 9"] = secs_photo + time.perf_counter() - t0 + sum(
        max(run["secs"] for run in runs[job]) for job in photo_jobs)
    log(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return dict(launched)


# ---------------------------------------------------------------------------
# phase 10: data-parallel training on ranks that share the one card
# ---------------------------------------------------------------------------

DP_WORLD = 2              # ranks
DP_TOY_BATCH = 4          # 10a's global batch (2 rows a rank)
DP_STEPS = 2              # 10a's and 10b's steps
DP_FULL_BATCH = 2         # 10b's global batch (1 row a rank)
DP_CLI_BATCH = 2          # 10c's --batch_size, the global batch
DP_CLI_STEPS = (1, 2)     # 10c: steps with a checkpoint, then --resume to
DP_CLI_CKPT_EVERY = 1     # 10c: a checkpoint before the last step too
DP_SEED = 8
DP_HOSTS = 2              # 10d: hosts of the --coordinator form
DP_HOST_RANKS = 2         # 10d: ranks a host, every one on cuda:0
DP_HOST_BATCH = 2         # 10d's --batch_size, a host's (1 row a rank)
DP_HOST_STEPS = 2         # 10d's steps, a checkpoint at the last
DP_HOST_SIZE = 256        # 10d's image side, the trained toy's
DP_HOST_LR = 1e-3
DP_FULL_GRAD_BYTES = 3_392_833_024   # 4 bytes of each of 8c's trainables
TOY_256 = os.path.join(ROOT, "assets", "toy_ckpt_256")


def digest(tree) -> str:
    """A hash of a tree's leaves in its order: of each fp32 tensor two sums
    of its bits as int32 words, computed where it lives (plain and
    weighted by odd position weights, in wrapping int64: one changed word
    always moves the weighted sum), and of each number its repr. Hashing
    the bytes on the host would cost about 2.7 s a GB."""
    import hashlib
    from blobctrl_torch.train import train_step as ts
    h = hashlib.blake2b(digest_size=16)
    for t in ts.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            words = t.detach().contiguous().view(torch.int32).reshape(-1).to(
                torch.int64)
            odd = torch.arange(words.numel(), device=words.device) * 2 + 1
            h.update(repr((tuple(t.shape), int(words.sum()),
                           int((words * odd).sum()))).encode())
        else:
            h.update(repr(t).encode())
    return h.hexdigest()


def dp_toy_step(pipe, group=None):
    """10a's state and step: the trained toy as 8b trains it
    (``train_unet_full``, fp32, remat)."""
    from blobctrl_torch.train import train_step as ts
    cfg = ts.TrainConfig(learning_rate=1e-4, weight_decay=1e-3,
                         train_unet_full=True, compute_dtype=torch.float32)
    return (ts.init_train_state(cfg, pipe.blobnet_params, pipe.unet_params),
            ts.make_train_step(cfg, pipe.unet_cfg, pipe.blobnet_cfg,
                               group=group))


def dp_draw(i: int, batch: int, latent, rows=None):
    """Step i's t and noise for the global batch (its ``rows``), on the
    card: JAX's draws for ``PRNGKey(DP_SEED + i)``."""
    from blobctrl_torch.train import train_step as ts
    from blobctrl_torch.utils import threefry
    return ts.draw_t_noise(threefry.key(DP_SEED + i), batch, latent,
                           device="cuda", rows=rows)


def worst_leaf(got, want) -> float:
    """10a's gradient metric: over the leaves, the largest max |got -
    want| of a leaf over that leaf's max |want|."""
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                 1e-30)
               for g, w in zip(got, want))


def _rows(tree, rows):
    return {k: v[rows.start:rows.stop] for k, v in tree.items()}


def _steps(step, state, frozen, batches, draws):
    """The data-parallel steps of a rank, counters and the collective log
    zeroed before each and read after it. -> (state, per-step records)."""
    from blobctrl_torch import ops
    from blobctrl_torch.parallel import collectives
    out = []
    for batch, (t, noise) in zip(batches, draws):
        ops.reset_counts()
        collectives.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch, t, noise)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        out.append({"secs": time.perf_counter() - t0, "loss": loss,
                    "grad_norm": norm, "launches": launch_counts(),
                    "tc": tensor_core_counts(),
                    "shapes": {k: dict(v) for k, v in launch_shapes().items()},
                    "summary": collectives.summary(),
                    "sizes": collectives.sizes()})
    return state, out


def _dp_toy(data):
    """10a on a rank: the toy state replicated from rank 0, the averaged
    gradients of the first batch (nothing updated), then DP_STEPS steps on
    this rank's rows of the global batch."""
    from blobctrl_torch.parallel import collectives, multihost
    from blobctrl_torch.train import toy
    from blobctrl_torch.train import train_step as ts
    torch.backends.cudnn.allow_tf32 = False  # as the single-process step
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe, _ = toy.load_toy(TOY_256, device="cuda", dtype=torch.float32)
    group = multihost.world_group()
    state, step = dp_toy_step(pipe, group)
    del pipe
    rows = multihost.local_rows(DP_TOY_BATCH)
    latent = data["x0_latents"].shape[1:]
    local = _rows(data, rows)
    collectives.reset()
    state = ts.replicate_state(state)
    rep = collectives.sizes()
    loss, grads = step.loss_and_grads(state, None, local,
                                      *dp_draw(0, DP_TOY_BATCH, latent, rows))
    grads, loss = ts.mean_over_ranks(grads, loss, group)
    first = {"loss": float(loss), "norm": float(ts.global_norm(grads)),
             "grads": ([g.cpu().numpy() for g in grads]
                       if multihost.is_coordinator() else None)}
    del grads
    state, recs = _steps(step, state, None, [local] * DP_STEPS,
                         [dp_draw(i, DP_TOY_BATCH, latent, rows)
                          for i in range(DP_STEPS)])
    return {"first": first, "steps": recs, "replicate": rep,
            "want_replicate": ts.training_counts(
                state["params"], DP_WORLD, steps=0, replicated=state),
            "want_step": ts.training_counts(state["params"], DP_WORLD),
            "digest": digest(state)}


def _dp_full(seed):
    """10b on a rank: 8c's configuration at one row of the global batch,
    DP_STEPS steps; the peak memory over them."""
    from blobctrl_torch.parallel import multihost
    from blobctrl_torch.train import train_step as ts
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = TF32_DEFAULTS
    step, state, frozen = training_setup(multihost.world_group())
    rows = multihost.local_rows(DP_FULL_BATCH)
    batch = _rows(train_batch(step, DP_FULL_BATCH, seed), rows)
    draws = [dp_draw(i, DP_FULL_BATCH, TRAIN_LATENT, rows)
             for i in range(DP_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    state, recs = _steps(step, state, frozen, [batch] * DP_STEPS, draws)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"steps": recs, "peak_gib": peak,
           "want_step": ts.training_counts(state["params"], DP_WORLD),
           "digest": digest(state["params"])}
    del step, state, frozen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rss_peak(fn):
    """``fn()`` while a thread samples this process's resident set every
    2 ms (``/proc/self/statm``). -> (its result, the peak rise over the
    resident set at the start, in bytes)."""
    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page
    start = rss()
    peak = [start]
    done = threading.Event()

    def sample():
        while not done.wait(0.002):
            peak[0] = max(peak[0], rss())
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        out = fn()
    finally:
        done.set()
        t.join()
    return out, max(peak[0], rss()) - start


def example_bytes(example) -> int:
    return sum(v.nbytes for v in example.values())


def _measure_loader(data_lib, mem):
    """Wrap ``BlobDataLoader.__init__`` so that the first loader built
    records into ``mem`` its rows, examples and the bytes an example
    holds, and the peak rise of the resident set while it is built (after
    one example encoded unmeasured, so neither measure holds the
    encoders' first call), then the same for its examples built again as
    ``build_example`` returns them. -> the original ``__init__``."""
    real = data_lib.BlobDataLoader.__init__

    def init(self, pipeline, images, masks, pes, **kw):
        if not mem:   # the encoders' first call, outside both measures
            data_lib.encode_example(pipeline, images[0], masks[0], pes[0],
                                    kw["size"])
        _, rise = rss_peak(lambda: real(self, pipeline, images, masks, pes,
                                        **kw))
        if mem:
            return
        full, full_rise = rss_peak(lambda: [
            data_lib.build_example(pipeline, im, mk, pe, kw["size"])
            for im, mk, pe in zip(images, masks, pes)])
        mem.update(rows=[self.rows.start, self.rows.stop],
                   examples=len(self.examples),
                   bytes=example_bytes(self.examples[0]), rise=rise,
                   full_bytes=example_bytes(full[0]), full_rise=full_rise)
    data_lib.BlobDataLoader.__init__ = init
    return real


def _dp_cli(job):
    """10c on a rank: ``train_cli.run_rank`` on the models root at the
    global batch DP_CLI_BATCH, 1 row a rank: DP_CLI_STEPS[0] steps with a
    checkpoint every DP_CLI_CKPT_EVERY, then ``--resume`` to
    DP_CLI_STEPS[1] with the export, each in a group of its own; the
    checkpoint directories after each run, and the first loader's
    memory (``_measure_loader``)."""
    from blobctrl_torch import ops
    from blobctrl_torch.apps import train_cli
    from blobctrl_torch.parallel import collectives, multihost
    from blobctrl_torch.train import data as data_lib
    from blobctrl_torch.train import train_step as ts
    argv, export_dir, ports = job
    rank = multihost.process_index()
    multihost.shutdown()   # the CLI's rank body joins groups of its own
    events = EventLog()
    logging.getLogger("blobctrl_torch").addHandler(events)
    mem = {}
    real_init = _measure_loader(data_lib, mem)
    runs = []
    try:
        for steps, port, extra in (
                (DP_CLI_STEPS[0], ports[0], []),
                (DP_CLI_STEPS[1], ports[1],
                 ["--resume", "--export_dir", export_dir])):
            args = train_cli.build_parser().parse_args(
                argv + ["--steps", str(steps)] + extra)
            events.events.clear()
            ops.reset_counts()
            collectives.reset()
            t0 = time.perf_counter()
            state = train_cli.run_rank(args, rank, DP_WORLD,
                                       f"127.0.0.1:{port}", "gloo", "cuda:0")
            secs = time.perf_counter() - t0
            start = DP_CLI_STEPS[0] if extra else 0
            runs.append({
                "secs": secs, "events": list(events.events),
                "launches": launch_counts(), "sizes": collectives.sizes(),
                "ckpts": sorted(os.listdir(args.ckpt_dir)),
                "want": ts.training_counts(
                    state["params"], DP_WORLD, steps=steps - start,
                    replicated=state,
                    checkpoints=len(dp_cli_checkpoints(start, steps))),
                "step": state["step"], "digest": digest(state["params"]),
                "memory": dict(mem)})
            del state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        data_lib.BlobDataLoader.__init__ = real_init
        logging.getLogger("blobctrl_torch").removeHandler(events)
    return runs


def dp_cli_checkpoints(start: int, end: int):
    """The steps at which a 10c run from ``start`` to ``end`` checkpoints."""
    return [s for s in range(start + 1, end + 1)
            if s % DP_CLI_CKPT_EVERY == 0 or s == end]


def check_dp_cli(cli):
    """10c's checks of each rank's two ``_dp_cli`` runs (``cli[rank]``),
    their lines printed. -> the K1/K6 launches over the ranks."""
    launched = collections.Counter()
    for rank, runs in enumerate(cli):
        first, last = DP_CLI_STEPS
        for run, (what, want, dirs) in zip(runs, (
                ("steps", {"train": list(range(1, first + 1)),
                           "checkpoint": dp_cli_checkpoints(0, first)},
                 dp_cli_checkpoints(0, first)),
                ("--resume", {"resumed": [first],
                              "train": list(range(first + 1, last + 1)),
                              "checkpoint": dp_cli_checkpoints(first, last),
                              "exported": None},
                 dp_cli_checkpoints(0, first)
                 + dp_cli_checkpoints(first, last)))):
            got = {}
            for e in run["events"]:
                if e.get("event") in ("train", "checkpoint", "resumed",
                                      "exported"):
                    got.setdefault(e["event"], []).append(e.get("step"))
            lead_want = {k: v if v is not None else [None]
                         for k, v in want.items()}
            calls = {op: c["count"]
                     for op, c in run["sizes"].get("pipeline", {}).items()}
            ran = {k: n for k, n in run["launches"].items() if n}
            rates = [(e["step"], e["img_per_sec"], e["sec_per_step"])
                     for e in run["events"] if e.get("event") == "train"]
            log(f"  10c rank {rank} {what}: {run['secs']:.2f} s, global "
                f"batch {DP_CLI_BATCH}, rows {run['memory']['rows']} of "
                f"each, img_per_sec (step, img/s, s) {rates}, events "
                f"{got}, collectives {calls}, launches {ran}, checkpoints "
                f"{run['ckpts']}")
            if got != (lead_want if rank == 0 else {}):
                raise AssertionError(f"10c rank {rank} {what}: events {got}")
            # img_per_sec is the global batch over the step's seconds, each
            # logged rounded to 2 and 3 decimals
            if any(abs(r - DP_CLI_BATCH / dt) > 0.005 + DP_CLI_BATCH * 5e-4
                   / (dt * (dt - 5e-4)) for _, r, dt in rates):
                raise AssertionError(f"10c rank {rank} {what}: img_per_sec "
                                     f"{rates} not over {DP_CLI_BATCH}")
            if run["ckpts"] != [f"step_{s:08d}" for s in dirs]:
                raise AssertionError(f"10c rank {rank} {what}: checkpoints "
                                     f"{run['ckpts']}, want steps {dirs}")
            if run["sizes"] != run["want"]:
                raise AssertionError(f"10c rank {rank} {what}: collectives "
                                     f"{run['sizes']} != {run['want']}")
            launched.update({k: run["launches"][k] for k in EXACT})
    for rank, runs in enumerate(cli):
        m = runs[0]["memory"]
        log(f"  10c rank {rank} loader: {m['examples']} examples, rows "
            f"{m['rows']} of each batch of {DP_CLI_BATCH}; "
            f"{m['bytes']} bytes an example held compact, peak resident "
            f"rise {m['rise'] / 2 ** 20:.1f} MiB while the loader was "
            f"built; as build_example returns them (with the DINOv2 splat) "
            f"{m['full_bytes']} bytes an example, peak rise "
            f"{m['full_rise'] / 2 ** 20:.1f} MiB")
        if m["rows"] != [rank, rank + 1] or m["examples"] != CLI_SCENES:
            raise AssertionError(f"10c rank {rank}: loader {m}")
    if any([x["digest"] for x in r] != [x["digest"] for x in cli[0]]
           for r in cli) or cli[0][-1]["step"] != DP_CLI_STEPS[1]:
        raise AssertionError("10c: the ranks' final states differ")
    return launched


def tests_module(name: str):
    """A helper module of the repository's tests/ (no test in it),
    imported from its file: tests/ is no package, and one named ``tests``
    elsewhere on the path may come first."""
    import importlib.util
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "tests", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def _dp_hosts(job):
    """10d on a rank: ``train_cli.run_rank``, the --coordinator form's
    rank body, as global rank g, local rank g % DP_HOST_RANKS of host
    g // DP_HOST_RANKS, in a group of its own, in fp32 on the device the
    job names (the card, or the CPU for the reference), recorded by
    ``tests/torch_ranks.recorded_cli`` as the CPU tests record it. -> its
    seconds, its loader's start-up, its loader's example indices, each
    step's draws (the global batch, the rows drawn, t, noise), losses and
    first gradients, log events, launches, collective log and the one it
    should be, and the final state's digest."""
    from blobctrl_torch import ops
    from blobctrl_torch.apps import train_cli
    from blobctrl_torch.parallel import collectives, multihost
    from blobctrl_torch.train import data as data_lib
    from blobctrl_torch.train import train_step as ts
    argv, device, port = job
    rank = multihost.process_index()
    multihost.shutdown()   # the CLI's rank body joins a group of its own
    if device == "cpu":
        torch.set_num_threads(1)
    world = DP_HOSTS * DP_HOST_RANKS
    address = f"127.0.0.1:{port}"
    args = train_cli.build_parser().parse_args(argv + [
        "--coordinator", address, "--num_processes", str(DP_HOSTS),
        "--process_id", str(rank // DP_HOST_RANKS), "--data_parallel",
        str(world), "--device", device])
    built, real = [], data_lib.BlobDataLoader.__init__

    def init(self, *a, **k):   # encodes the host's stride: start-up time
        t0 = time.perf_counter()
        real(self, *a, **k)
        built.append((len(self.examples), time.perf_counter() - t0))
    data_lib.BlobDataLoader.__init__ = init
    try:
        with tests_module("torch_ranks").recorded_cli() as rec:
            ops.reset_counts()
            collectives.reset()
            t0 = time.perf_counter()
            state = train_cli.run_rank(args, rank, world, address, "gloo",
                                       device, per_process=True)
            if device != "cpu":   # the CPU's ranks never touch the card
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        data_lib.BlobDataLoader.__init__ = real
    return {"secs": secs, "built": built[0], "seen": rec["seen"],
            "draws": rec["draws"], "loss": rec["steps"]["loss"],
            "grads": rec["steps"]["grads"], "events": rec["events"],
            "launches": launches, "sizes": collectives.sizes(),
            "want": ts.training_counts(state["params"], world,
                                       steps=DP_HOST_STEPS,
                                       replicated=state, checkpoints=1),
            "digest": digest(state["params"])}


def write_hosts_roots(root: str):
    """10d's models root under ``root``/models, the trained 256^2 toy with
    ``benchkit.write_training_root``'s encoders and LoRA, and its data
    under ``root``/data: CLI_SCENES scenes at DP_HOST_SIZE."""
    from blobctrl_torch.train import toy
    from blobctrl_torch.utils import benchkit
    pipe, _ = toy.load_toy(TOY_256, device="cpu")
    benchkit.write_training_root(
        os.path.join(root, "models"), pipe.unet_params, pipe.unet_cfg,
        pipe.blobnet_params, pipe.blobnet_cfg, pipe.vae_params,
        pipe.vae_cfg)
    write_scenes(os.path.join(root, "data"), DP_HOST_SIZE)


def hosts_argv(root: str, ckpt_dir: str):
    """10d's training flags on ``write_hosts_roots``' roots, save the
    ranks' layout and device."""
    return ["--models_root", os.path.join(root, "models"), "--data_root",
            os.path.join(root, "data"), "--size", str(DP_HOST_SIZE),
            "--batch_size", str(DP_HOST_BATCH), "--steps",
            str(DP_HOST_STEPS), "--ckpt_every", str(DP_HOST_STEPS),
            "--log_every", "1", "--lora_rank", "4", "--learning_rate",
            str(DP_HOST_LR), "--ckpt_dir", ckpt_dir]


def state_distance(got, want, steps: int, lr: float):
    """Two final train states of fp32 runs on different devices: ->
    (the largest parameter difference over the step bound, steps (1 +
    wd |p|) lr; the elements past 1e-3 lr; all elements)."""
    from blobctrl_torch.train import train_step as ts
    wd = ts.TrainConfig().weight_decay
    far = total = 0
    worst = 0.0
    for a, b in zip(ts.tree_leaves(got["params"]),
                    ts.tree_leaves(want["params"]), strict=True):
        err = (a - b).abs()
        worst = max(worst, float(err.max() / (
            steps * (1 + wd * b.abs().max()) * lr)))
        far += int((err > 1e-3 * lr).sum())
        total += err.numel()
    return worst, far, total


def adam_moves(steps_grads, lr: float):
    """The parameter moves that clip + Adam (``train_step.
    apply_optimizer``, its weight decay left out) make from zero moments
    out of each step's applied gradients, in float64: -> per leaf, the
    sum over the steps of -lr m^/(sqrt(v^) + eps)."""
    from blobctrl_torch.train import train_step as ts
    b1, b2, eps = ts.ADAM_B1, ts.ADAM_B2, ts.ADAM_EPS
    clip = ts.TrainConfig().max_grad_norm
    m = v = moves = None
    for t, grads in enumerate(steps_grads, 1):
        g = [np.asarray(x, np.float64) for x in grads]
        norm = float(np.sqrt(sum(float((x * x).sum()) for x in g)))
        if norm >= clip:
            g = [x / norm * clip for x in g]
        m = [b1 * a + (1 - b1) * x for a, x in zip(m or [0.0] * len(g), g)]
        v = [b2 * a + (1 - b2) * x * x
             for a, x in zip(v or [0.0] * len(g), g)]
        step = [-lr * (a / (1 - b1 ** t)) / (np.sqrt(c / (1 - b2 ** t)) + eps)
                for a, c in zip(m, v)]
        moves = step if moves is None else [a + b for a, b in
                                            zip(moves, step)]
    return moves


def hosts_state_check(got, want, got_grads, want_grads):
    """10d's final-state bar: two final states of DP_HOST_STEPS steps at
    DP_HOST_LR from one start, ``got_grads`` / ``want_grads`` the
    gradients each run applied at each step. No element past the step
    bound, and every element's difference the one those gradients make
    (``adam_moves``), within 1e-3 lr: what the runs' devices computed
    differently shows in their gradients alone, and a fault in the update,
    the broadcast or the checkpoint shows here. Its control: the leaf of
    the largest first gradient moved 2e-3 lr in ``got`` must fail. ->
    (held, the readings)."""
    from blobctrl_torch.train import train_step as ts
    worst, far, total = state_distance(got, want, DP_HOST_STEPS, DP_HOST_LR)
    made = [a - b for a, b in zip(adam_moves(got_grads, DP_HOST_LR),
                                  adam_moves(want_grads, DP_HOST_LR))]
    leaves = list(zip(ts.tree_leaves(got["params"]),
                      ts.tree_leaves(want["params"]), made, strict=True))

    def residual(shift=None):
        """-> (the largest |difference - its gradients' share| over lr,
        the elements past 1e-3 lr), leaf ``shift`` moved 2e-3 lr."""
        top, over = 0.0, 0
        for i, (a, b, d) in enumerate(leaves):
            r = np.abs((a - b).numpy().astype(np.float64)
                       + (2e-3 * DP_HOST_LR if i == shift else 0.0)
                       - d.reshape(a.shape)) / DP_HOST_LR
            top, over = max(top, float(r.max())), over + int(
                (r > 1e-3).sum())
        return top, over
    top, over = residual()
    i = max(range(len(leaves)), key=lambda i: float(np.abs(
        np.asarray(want_grads[0][i])).max()))
    c_top, c_over = residual(i)
    d = {"worst": worst, "far": far, "total": total, "residual": top,
         "over": over, "control": {"leaf": i,
                                   "elements": leaves[i][0].numel(),
                                   "residual": c_top, "over": c_over}}
    return worst <= 1 and over == 0 and c_over > 0, d


def hosts_state_reading(d) -> str:
    """``hosts_state_check``'s readings, for the log."""
    c = d["control"]
    return (f"{d['worst']:.3f} of the step bound, {d['far']} of "
            f"{d['total']} elements past 1e-3 lr; less the share the "
            f"runs' gradients make, at most {d['residual']:.2e} lr, "
            f"{d['over']} elements past 1e-3 lr (tol 0); control: leaf "
            f"{c['leaf']} ({c['elements']} elements, the largest first "
            f"gradient) moved 2e-3 lr: {c['over']} past, at most "
            f"{c['residual']:.2e} lr (must fail)")


def dp_hosts_phase(work: str):
    """10d: the --coordinator form over DP_HOSTS hosts of DP_HOST_RANKS
    ranks, its rank bodies on cuda:0 over gloo and, meanwhile, on the CPU
    (the reference), both in fp32 on the trained 256^2 toy's models root.
    -> the K1/K6 launches over the card's ranks."""
    from blobctrl_torch.parallel import multihost
    from blobctrl_torch.train import checkpoint as ckpt_lib
    t0 = time.perf_counter()
    root = os.path.join(work, "dp_hosts")
    write_hosts_roots(root)
    world = DP_HOSTS * DP_HOST_RANKS
    ports = set()
    while len(ports) < 2:
        ports.add(multihost.free_port())
    jobs = {where: [("dp_hosts", (hosts_argv(root, os.path.join(
        root, where)), "cuda:0" if where == "card" else "cpu", port))]
        for where, port in zip(("card", "cpu"), sorted(ports))}
    ref = []
    card = [r["dp_hosts"] for r in spawn_ranks(
        world, jobs["card"], meanwhile=lambda: ref.extend(
            r["dp_hosts"] for r in spawn_ranks(world, jobs["cpu"],
                                               device="cpu")))]
    launched = collections.Counter()
    for g, (c, r) in enumerate(zip(card, ref)):
        host, index = divmod(g, DP_HOST_RANKS)
        rows = multihost.host_rows(DP_HOST_BATCH, DP_HOST_RANKS, index, host)
        per = DP_HOST_BATCH // DP_HOST_RANKS
        rel = [abs(a - b) / abs(b) for a, b in zip(c["loss"], r["loss"])]
        grads = worst_leaf(c["grads"][0], r["grads"][0])
        later = [worst_leaf(a, b) for a, b in zip(c["grads"][1:],
                                                  r["grads"][1:])]
        drawn = [d[1] for d in c["draws"]]
        noise = max(float(np.abs(a[3] - b[3]).max())
                    for a, b in zip(c["draws"], r["draws"]))
        ran = {k: c["launches"][k] for k in EXACT}
        events = {}
        for e in c["events"]:
            if e.get("event") in ("train", "checkpoint"):
                events.setdefault(e["event"], []).append(e["step"])
        rates = [(e["step"], e["img_per_sec"], e["sec_per_step"])
                 for e in c["events"] if e.get("event") == "train"]
        log(f"  10d rank {g} (host {host}, local rank {index}): "
            f"{c['secs']:.2f} s on the card, {r['secs']:.2f} s on the CPU; "
            f"its loader encoded its host's {c['built'][0]} examples in "
            f"{c['built'][1]:.2f} s on the card; "
            f"examples {c['seen'][:DP_HOST_STEPS]} of its host's stride, "
            f"global rows {drawn} of {DP_HOSTS * DP_HOST_BATCH}; losses "
            f"{[f'{x:.7f}' for x in c['loss']]} against the CPU's (rel "
            f"{max(rel):.2e}, tol {TOL[torch.float32]:.0e}, the kernels' "
            f"fp32 bar), first gradients {grads:.2e} of each leaf's max "
            f"(tol 1e-03, 8e's; later steps' {later}), "
            f"noise {noise:.1e} from the CPU's; img_per_sec (step, img/s, "
            f"s) {rates}; collectives "
            f"{ {op: x['count'] for op, x in c['sizes'].get('pipeline', {}).items()} }"
            f"; launches {ran}")
        if (c["seen"][:DP_HOST_STEPS] != r["seen"][:DP_HOST_STEPS]
                or any(len(s) != per for s in c["seen"][:DP_HOST_STEPS])
                or drawn != [rows] * DP_HOST_STEPS
                or drawn != [d[1] for d in r["draws"]]
                or any(d[0] != DP_HOSTS * DP_HOST_BATCH for d in c["draws"])
                or any(not np.array_equal(a[2], b[2])
                       for a, b in zip(c["draws"], r["draws"]))
                or noise > 1e-6):
            raise AssertionError(f"10d rank {g}: rows or draws")
        if len(c["loss"]) != DP_HOST_STEPS or max(rel) > TOL[torch.float32] \
                or grads > 1e-3 or c["loss"] != card[0]["loss"]:
            raise AssertionError(f"10d rank {g}: losses {c['loss']} / "
                                 f"{r['loss']}")
        if events != ({"train": list(range(1, DP_HOST_STEPS + 1)),
                       "checkpoint": [DP_HOST_STEPS]} if g == 0 else {}):
            raise AssertionError(f"10d rank {g}: events {events}")
        if any(abs(x - DP_HOSTS * DP_HOST_BATCH / dt) > 0.005 + DP_HOSTS
               * DP_HOST_BATCH * 5e-4 / (dt * (dt - 5e-4))
               for _, x, dt in rates):
            raise AssertionError(f"10d rank {g}: img_per_sec {rates}")
        if c["sizes"] != c["want"] or r["sizes"] != r["want"]:
            raise AssertionError(f"10d rank {g}: collectives {c['sizes']} "
                                 f"!= {c['want']}")
        if min(ran.values()) == 0:
            raise AssertionError(f"10d rank {g}: launches {ran}")
        launched.update(ran)
    if any(c["digest"] != card[0]["digest"] for c in card):
        raise AssertionError("10d: the card's ranks' final states differ")
    got, want = (ckpt_lib.restore(os.path.join(root, where), device="cpu")
                 for where in ("card", "cpu"))
    same = digest(got["params"]) == card[0]["digest"]
    ok, d = hosts_state_check(got, want, card[0]["grads"], ref[0]["grads"])
    log(f"  10d: global rank 0's checkpoint on the card (bit-equal to "
        f"every card rank's final state: {same}) against the CPU run's: "
        f"{hosts_state_reading(d)}; 10d took "
        f"{time.perf_counter() - t0:.1f} s")
    if got["step"] != DP_HOST_STEPS or not same or not ok:
        raise AssertionError("10d: the final state on the card")
    shutil.rmtree(root)
    return launched


DP_JOBS = {"dp_toy": _dp_toy, "dp_full": _dp_full, "dp_cli": _dp_cli,
           "dp_hosts": _dp_hosts}


def dp_training_phase(models_root: str, work: str, train_shapes):
    """Phase 10. ``train_shapes``: phase 8a's K1 and K6 keys. -> {kernel:
    launches of the phase, summed over ranks}."""
    from blobctrl_torch.parallel import multihost
    from blobctrl_torch.train import checkpoint as ckpt_lib
    from blobctrl_torch.train import toy
    from blobctrl_torch.train import train_step as ts
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card, meta = toy.load_toy(TOY_256, device="cuda", dtype=torch.float32)
    data = toy.encode_dataset(card.vae_params, card.vae_cfg,
                              toy.build_dataset(DP_TOY_BATCH, size=256,
                                                seed=DP_SEED,
                                                ctx=meta["ctx"],
                                                dino_c=meta["dino_c"]))
    latent = data["x0_latents"].shape[1:]
    data_root = os.path.join(work, "dp_data")    # 10c's data set
    write_scenes(data_root, TRAIN_SIZE)
    ckpt_dir = os.path.join(work, "dp_ckpts")
    export_dir = os.path.join(work, "dp_export")
    argv = ["--models_root", models_root, "--data_root", data_root,
            "--size", str(TRAIN_SIZE), "--batch_size", str(DP_CLI_BATCH),
            "--ckpt_every", str(DP_CLI_CKPT_EVERY), "--log_every", "1",
            "--ckpt_dir", ckpt_dir]
    ports = set()
    while len(ports) < 2:
        ports.add(multihost.free_port())
    refs = {}

    def references():
        """The single-process steps of the global batches, on the card
        while the ranks start: 10a's toy gradients (fp32, TF32 off), then
        10b's DP_STEPS steps in 8c's configuration."""
        state, step = dp_toy_step(card)

        def grads_of(rows=None):
            batch = data if rows is None else _rows(data, rows)
            loss, grads = step.loss_and_grads(
                state, None, batch, *dp_draw(0, DP_TOY_BATCH, latent, rows))
            return (float(loss), float(ts.global_norm(grads)),
                    [g.cpu().numpy() for g in grads])
        loss, norm, want = grads_of()
        again = grads_of()[2]
        halves = [grads_of(range(0, 2)), grads_of(range(2, 4))]
        mean = [(a + b) / 2 for a, b in zip(halves[0][2], halves[1][2])]
        refs["a"] = (loss, norm, want, {
            "split": worst_leaf(mean, want), "again": worst_leaf(again, want),
            "dropped": worst_leaf(halves[0][2], want)})
        del state, step, want, again, halves, mean
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = TF32_DEFAULTS
        step, state, frozen = training_setup()
        batch = train_batch(step, DP_FULL_BATCH, DP_SEED)
        refs["b"] = []
        for i in range(DP_STEPS):
            state, m = step(state, frozen, batch,
                            *dp_draw(i, DP_FULL_BATCH, TRAIN_LATENT))
            refs["b"].append((float(m["loss"]), float(m["grad_norm"])))
        del step, state, frozen
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  the single-process references on the card, made while the "
            f"ranks ran: 10a's toy gradients at B = {DP_TOY_BATCH} (loss "
            f"{refs['a'][0]:.8f}), 10b's {DP_STEPS} steps at B = "
            f"{DP_FULL_BATCH} (losses "
            f"{[f'{x[0]:.6f}' for x in refs['b']]})")

    t0 = time.perf_counter()
    ranks = spawn_ranks(DP_WORLD, [("dp_toy", data), ("dp_full", DP_SEED),
                                   ("dp_cli", (argv, export_dir,
                                               sorted(ports)))],
                        meanwhile=references)
    del card
    ref_a, ref_b = refs["a"], refs["b"]
    log(f"  {DP_WORLD} ranks on cuda:0 ran 10a, 10b and 10c in "
        f"{time.perf_counter() - t0:.1f} s (spawn and loads included)")
    launched = collections.Counter()
    # 10a: the averaged gradients may differ from one process's by what
    # summing the batch as 2 + 2 rows and running again move them on the
    # card in this run (``noise``), twice over; a rank's rows dropped from
    # the mean (``dropped``) must lie ten bars above that
    loss_a, norm_a, g_ref, noise = ref_a
    bar_a = 2.0 * (noise["split"] + noise["again"])
    log(f"  10a's gradient bar: 2 x (2 + 2 rows against 4: "
        f"{noise['split']:.2e}, run to run: {noise['again']:.2e}) = "
        f"{bar_a:.2e} of a leaf's max |gradient|; one rank's rows alone: "
        f"{noise['dropped']:.2e}")
    if noise["dropped"] < 10.0 * bar_a:
        raise AssertionError(f"10a: the bar {bar_a} cannot tell a dropped "
                             f"rank ({noise['dropped']}) from noise")
    for rank, run in enumerate(r["dp_toy"] for r in ranks):
        first = run["first"]
        rel_loss = abs(first["loss"] - loss_a) / loss_a
        rel_norm = abs(first["norm"] - norm_a) / norm_a
        worst = (None if first["grads"] is None
                 else worst_leaf(first["grads"], g_ref))
        counts = [{k: r["launches"][k] for k in EXACT} for r in run["steps"]]
        log(f"  10a rank {rank}: the mean over ranks of the first batch: "
            f"loss {first['loss']:.8f} against {loss_a:.8f} in one process "
            f"(rel {rel_loss:.2e}, tol 1e-06), grad norm rel {rel_norm:.2e}"
            + ("" if worst is None else f", worst leaf {worst:.2e} of its "
               f"max |gradient| (tol {bar_a:.2e})") + "; steps: "
            + ", ".join(f"loss {r['loss']:.6f} norm {r['grad_norm']:.5f} "
                        f"{r['secs']:.3f} s" for r in run["steps"])
            + f"; launches a step {counts}")
        if rel_loss > 1e-6 or (worst is not None and worst > bar_a):
            raise AssertionError(f"10a rank {rank}: loss rel {rel_loss}, "
                                 f"gradients {worst}")
        if run["replicate"] != run["want_replicate"] or any(
                r["sizes"] != run["want_step"] for r in run["steps"]):
            raise AssertionError(
                f"10a rank {rank}: collectives {run['replicate']} / "
                f"{[r['sizes'] for r in run['steps']]} != "
                f"{run['want_replicate']} / {run['want_step']}")
        if min(min(c.values()) for c in counts) == 0:
            raise AssertionError(f"10a rank {rank}: launches {counts}")
        for r in run["steps"]:
            launched.update({k: r["launches"][k] for k in EXACT})
    toy_runs = [r["dp_toy"] for r in ranks]
    if any(r["digest"] != toy_runs[0]["digest"]
           or [s["loss"] for s in r["steps"]]
           != [s["loss"] for s in toy_runs[0]["steps"]] for r in toy_runs):
        raise AssertionError("10a: the ranks' states differ")
    log(f"  10a: the state (params, moments) bit-equal on both ranks after "
        f"{DP_STEPS} steps; collectives a step "
        f"{toy_runs[0]['want_step']}, the replicate "
        f"{toy_runs[0]['want_replicate']}")
    # 10b
    full = [r["dp_full"] for r in ranks]
    for rank, run in enumerate(full):
        for i, (r, (loss_b, norm_b)) in enumerate(zip(run["steps"], ref_b)):
            check_tensor_cores(f"10b rank {rank} step {i + 1}", r["launches"],
                               EXACT, r["tc"])
            off = {k: set(r["shapes"][k]) - set(train_shapes[k])
                   for k in EXACT}
            ar = r["sizes"]["pipeline"]["all_reduce"]
            secs_in = r["summary"]["pipeline"]["all_reduce"]["seconds"]
            rel_loss = abs(r["loss"] - loss_b) / loss_b
            rel_norm = abs(r["grad_norm"] - norm_b) / norm_b
            log(f"  10b rank {rank} step {i + 1}: loss {r['loss']:.6f} "
                f"(rel {rel_loss:.2e} of B = {DP_FULL_BATCH} in one "
                f"process, tol 1e-02), grad norm {r['grad_norm']:.5f} (rel "
                f"{rel_norm:.2e}, tol 2e-02); {r['secs']:.3f} s a step, "
                f"{secs_in:.3f} s of it inside {ar['count']} all-reduces of "
                f"{ar['bytes']} bytes (ranks sharing one card over gloo: "
                f"information only); launches "
                f"{ {k: r['launches'][k] for k in EXACT} }")
            if rel_loss > 1e-2 or rel_norm > 2e-2:
                raise AssertionError(f"10b rank {rank} step {i + 1}: loss "
                                     f"{rel_loss}, norm {rel_norm}")
            if any(off.values()) or min(r["launches"][k] for k in EXACT) \
                    == 0:
                raise AssertionError(f"10b rank {rank}: K1/K6 shapes not "
                                     f"checked in 8a: {off}")
            if r["sizes"] != run["want_step"] or \
                    ar["bytes"] != DP_FULL_GRAD_BYTES + 4:
                raise AssertionError(f"10b rank {rank}: collectives "
                                     f"{r['sizes']} != {run['want_step']}")
            launched.update({k: r["launches"][k] for k in EXACT})
        log(f"  10b rank {rank}: peak memory {run['peak_gib']:.2f} GiB; "
            f"step seconds {[round(r['secs'], 3) for r in run['steps']]}")
    if any(r["digest"] != full[0]["digest"] for r in full):
        raise AssertionError("10b: the ranks' parameters differ")
    log(f"  10b: the parameters bit-equal on both ranks after {DP_STEPS} "
        f"steps")
    # 10c
    cli = [r["dp_cli"] for r in ranks]
    launched.update(check_dp_cli(cli))
    final = ckpt_lib.restore(ckpt_dir, device="cuda")
    if final["step"] != DP_CLI_STEPS[1] or digest(final["params"]) != \
            cli[0][-1]["digest"]:
        raise AssertionError("10c: rank 0's last checkpoint is not the "
                             "final state")
    pipe = reload_export(models_root, export_dir, final["params"],
                         os.path.join(work, "dp_models_root_trained"))
    del pipe, final
    shutil.rmtree(ckpt_dir)
    gc.collect()
    torch.cuda.empty_cache()
    launched.update(dp_hosts_phase(work))
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s; launches "
        f"over every rank {dict(launched)}")
    return dict(launched)


T_START = time.perf_counter()


def log_elapsed():
    log(f"  ({time.perf_counter() - T_START:.1f} s into the run)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from blobctrl_torch import ops
    from blobctrl_torch.ops import _build, conv3x3, winograd
    from blobctrl_torch.ops import flash_attention as fa
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
    log_elapsed()
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  kernel build {time.perf_counter() - t0:.2f} s")
    jpeg_phase()
    torch.backends.cudnn.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 2 ------------------------------------------------------------
    log("phase 2: kernels against their plain versions at the 512^2 shapes")
    log_elapsed()
    t0 = time.perf_counter()
    pipe = benchkit.make_flagship_pipe(seed=0, device="cuda",
                                       dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  the production pipeline's weights drawn on the card (bf16, "
        f"JAX's init trees): {time.perf_counter() - t0:.3f} s")
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
    log(f"  the photo sizes {', '.join(f'{w}x{h}' for w, h in PHOTO_SIZES)}"
        f" (W x H): one-step edits in every mode, and every kernel shape "
        f"they launch that the 512^2 and batched edits did not, checked "
        f"without timing:")
    photo = photo_kernel_checks(pipe, results, {
        name: shapes[name] | batch_shapes.get(name, set())
        for name in EXACT + INT8 + FUSED})
    log(f"  the large photos {', '.join(f'{w}x{h}' for w, h in LARGE_SIZES)}"
        f" (W x H): one-step edits in every mode, and every kernel shape "
        f"they launch that no edit above did, checked without timing (flash "
        f"over more than {fa.PLAIN_MAX_ROWS} query rows or "
        f"{fa.PLAIN_MAX_SCORES} scores at three tiles of {fa.CHECK_TILE} "
        f"rows: the first, the middle and the last):")
    large = photo_kernel_checks(
        pipe, results, {name: set(results[name])
                        for name in EXACT + INT8 + FUSED},
        sizes=LARGE_SIZES, seconds=LARGE_SECONDS)
    results["blob_splat"], splat_calls = check_splat()

    # -- phase 3 ------------------------------------------------------------
    log("phase 3: trained toy checkpoint, card against CPU")
    log_elapsed()
    toy_phase()

    # -- phase 4 ------------------------------------------------------------
    log(f"phase 4: full width, bf16, {STEPS} steps per request")
    log_elapsed()
    requests = full_width_requests(STEPS)
    ops.reset_counts()
    for name, kw in requests:
        out, secs, launches, mem = run_request(pipe, kw)
        if name == "edit":
            exact_edit, square = out, (secs, launches, mem)
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
    photo_shapes = photo_request(pipe, square, smi.splitlines()[0])
    large_shapes = photo_request(pipe, square, smi.splitlines()[0],
                                 wh=LARGE_SIZES[0], seconds=LARGE_SECONDS)
    for name in EXACT:
        missing = (set(photo_shapes[name]) | set(large_shapes[name])) \
            - set(results[name])
        if missing:
            raise AssertionError(f"{name}: the photo requests' shapes not "
                                 f"checked in phase 2: {missing}")

    # -- phase 5 ------------------------------------------------------------
    log(f"phase 5: the interactive session at full width, bf16, {STEPS} "
        f"steps per run")
    log_elapsed()
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
    log_elapsed()
    del pipe
    torch.cuda.empty_cache()
    _, pipe = checkpoint_phase(models_root, smi.splitlines()[0])
    log(f"  the CLI as a process at {PHOTO[0]}x{PHOTO[1]} (W x H), "
        f"{CLI_PHOTO_STEPS} steps, on this models root")
    cli_photo_phase(models_root)

    # -- phase 7 ------------------------------------------------------------
    log(f"phase 7: serving on phase 6's loaded pipeline: edit_batch at B = "
        f"{', '.join(map(str, BATCH_SIZES))}, the HTTP server, a traced "
        f"edit, the int8 linear path")
    log_elapsed()
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
    log_elapsed()
    checkpoint_day_phase(models_root, demo_root)

    # -- phase 8 ------------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8: training (device memory held before it: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)")
    log_elapsed()
    train_errs, trained = training_phase(models_root, work.name)

    # -- phase 9 ------------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 9: the edit sharded over ranks that share this card over "
        "gloo: the toy and full width at model=2, data=2 and hybrid 2 x 2")
    log_elapsed()
    parallel = parallel_phase(results)

    # -- phase 10 -----------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10: data-parallel training on {DP_WORLD} ranks that share "
        f"this card over gloo: the toy, full width, the training CLI; "
        f"then {DP_HOSTS} hosts of {DP_HOST_RANKS} ranks (10d)")
    log_elapsed()
    dp_trained = dp_training_phase(models_root, work.name,
                                   {k: set(v) for k, v in train_errs.items()})

    # -- phase 11 -----------------------------------------------------------
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
                 "train_launches": trained.get(name, 0),
                 "parallel_launches": parallel.get(name, 0),
                 "dp_train_launches": dp_trained.get(name, 0),
                 "max_abs_err": max(r["max_abs_err"]
                                    for r in results[name].values())}
        if name in photo:  # the shapes only the photo sizes launched
            entry["photo_shapes"], entry["photo_rel_bf16"], \
                entry["photo_rel_fp32"] = photo[name]
            entry["large_photo_shapes"], entry["large_photo_rel_bf16"], \
                entry["large_photo_rel_fp32"] = large[name]
        if name in train_errs:  # the Function's forward and gradients
            entry["train_max_abs_err"] = max(train_errs[name].values())
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
    log(f"the photo sizes' checks: {sum(PHOTO_SECONDS.values()):.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in PHOTO_SECONDS.items())
        + f") on {smi.splitlines()[0]}")
    log(f"the large photos' and the batched and sharded photo-size checks: "
        f"{sum(LARGE_SECONDS.values()):.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in LARGE_SECONDS.items())
        + f") on {smi.splitlines()[0]}")
    log(f"chip_smoke total {time.perf_counter() - T_START:.1f} s on "
        f"{smi.splitlines()[0]}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
