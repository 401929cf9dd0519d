"""Stateless HTTP serving of BlobCtrl edits from the PyTorch port
(counterpart of ``blobctrl_tpu/apps/server.py``, with the same HTTP
contract). stdlib only (``http.server``); request images are PNG or JPEG
(``utils/image.decode_image``, the port's own decoders), responses PNG.

Endpoints
  GET  /healthz     -> 200 "ok" once the model is warm, else 503
  GET  /v1/info     -> model geometry, schedulers, device, warmup state
  GET  /v1/progress -> in-flight edit progress {"active", "step", "total"}
                       (step counts only for preview-mode edits)
  POST /v1/edit     -> run one edit; JSON body:
      {
        "prompt": str | ["p1", ...],            (or "prompt_embeds": nested list)
        "negative_prompt": str | [...],          (optional)
        "fg_image": base64 PNG or JPEG,          (object on white canvas)
        "bg_image": base64 PNG or JPEG,          (edited background)
        "ellipse": [cx, cy, d1, d2, angle_deg],  (pixel units; OR "gs_score":
                                                  nested [h][w][M+1] floats)
        "remove": bool,                          (remove mode: strength 0,
                                                  bg-only score)
        "num_inference_steps": int, "guidance_scale": float,
        "blobnet_conditioning_scale": float,
        "blobnet_control_guidance_start"/"_end": float,
        "seed": int | null, "num_samples": int, "scheduler": str,
        "encoder_cache_interval": int,           (opt-in fast mode)
        "preview": bool                          (requires --preview_every N:
                                                  approximate RGB thumbnails
                                                  of intermediate steps +
                                                  live /v1/progress)
      }
      -> {"images": [base64 PNG, ...], "seconds": float,
          "previews": [base64 PNG, ...], "preview_steps": [int, ...]}
  Input that neither decoder supports (another format, a CMYK or
  arithmetic-coded JPEG, truncated data, ...) is a 400 that names it.

Design notes
  * The card is one exclusive resource: edits serialize through a lock
    (queueing happens in the threaded HTTP layer). Scale out with more
    replicas, one card each, behind a load balancer.
  * Dynamic micro-batching (--max_batch N): concurrent requests that share
    the sampler configuration coalesce into one ``pipeline.edit_batch``
    run, padded up to the next warm batch size. Each step then launches
    its kernels once for the whole batch, so the per-step host work and
    the fixed costs (encodes, decode) are shared; how a batch's seconds
    grow with its size on the card is measured, not assumed
    (``chip_smoke.py`` phase 7). Responses carry "batch_size".
    Multi-sample, encoder-cache, remove-mode and preview requests run solo
    under the same lock.
  * Warmup runs the standard edit, its preview variant, the remove-mode
    edit and a batch at each warm size once before traffic. On the card
    there is no graph compile; what the first requests would otherwise pay
    under the lock is the nvcc build of the hand-written kernels at their
    first launch (``ops/_build.py``), cuBLAS/cuDNN's first-call heuristics
    and the caching allocator's growth to the batch's working set.
  * Request limits: bodies above ``max_body_bytes`` get 413; once warmup
    has run, ``num_inference_steps`` and ``size`` are pinned to the warm
    values and non-default schedulers, sample counts and encoder-cache or
    preview+remove requests are refused with 400 (under ``strict_shapes``)
    so that a client sees the same contract as from the JAX package's
    server, and no request allocates an unwarmed working set under the
    lock. ``num_samples`` is bounded by ``MAX_SAMPLES``.
  * Request images decode in worker processes (``DecodePool``), never on
    the handler thread: the port's decoders are pure Python and would hold
    the interpreter lock for seconds on a large JPEG while the batcher and
    the denoise loop wait. The pool has a worker for each image of a full
    micro-batch (fg and bg of ``max_batch`` requests), so concurrent
    requests decode at once, as the JAX package's handler threads decode
    theirs, and reach the batcher together. The pool starts with the
    service (its workers come up in the warmup), uses the ``spawn`` start
    method (the parent holds a CUDA context) and has no in-process
    fallback: a worker that dies fails its request with a 500 and the pool
    is replaced.
  * Input validation mirrors the pipeline's own errors; client mistakes are
    400s with the message, not 500s.
  * Sharded serving (--mesh data=N,model=M, --hybrid_cfg_data): this
    process is rank 0 and spawns the other ranks (one card each over NCCL;
    gloo with --device cpu). Rank 0 runs HTTP, validation, the batcher,
    previews and /v1/progress, and sends each edit to the followers, which
    run the same ``__call__`` or ``edit_batch`` (``parallel.multihost.
    LeaderPipeline``); rank 0 gathers the images. A request that the
    pipeline refuses by its arguments is a 400 on the mesh too, and the mesh
    serves on. A follower that dies fails the edit in flight within the
    group timeout (a 500), and every later one at once. ``close()`` stops
    and joins the followers.
  * Deployment: http.server performs only basic security checks. Run this
    behind a reverse proxy that terminates TLS, enforces auth and rate
    limits, and bind it to a private interface (--host).
"""

from __future__ import annotations

import argparse
import base64
import binascii
import collections
import json
import multiprocessing
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from blobctrl_torch.parallel import multihost
from blobctrl_torch.utils import image, png


def _decode_image(b64: str, field: str = "image") -> np.ndarray:
    """Base64 PNG or JPEG -> (H, W, 3) uint8; what a ``DecodePool`` worker
    runs. Undecodable data raises ValueError naming ``field``."""
    try:
        return image.decode_image(base64.b64decode(b64))
    except (binascii.Error, ValueError, TypeError) as e:
        raise ValueError(f"{field} is not decodable base64 image data: {e}")


class DecodePool:
    """Request images decoded in ``workers`` spawned processes. A decoder
    error comes back as the worker raised it (a ValueError: a 400). A worker
    that dies breaks the pool: the requests it held fail with RuntimeError
    (a 500) and a new pool takes its place; nothing decodes in-process."""

    def __init__(self, workers: int):
        self.workers = workers
        self.replaced = 0
        self._lock = threading.Lock()
        self._pool = self._new_pool()

    def _new_pool(self) -> ProcessPoolExecutor:
        # spawn, never fork: the parent holds a CUDA context and threads
        return ProcessPoolExecutor(
            self.workers, mp_context=multiprocessing.get_context("spawn"))

    def decode(self, items: Sequence[Tuple[str, str]]) -> List[np.ndarray]:
        """[(base64 data, field name), ...] -> the decoded images, decoded
        in parallel."""
        with self._lock:
            pool = self._pool
        try:
            futures = [pool.submit(_decode_image, b64, field)
                       for b64, field in items]
            return [f.result() for f in futures]
        except BrokenProcessPool as e:
            with self._lock:
                if self._pool is pool:
                    pool.shutdown(wait=False, cancel_futures=True)
                    self._pool = self._new_pool()
                    self.replaced += 1
            raise RuntimeError(f"an image decoder process died ({e}); the "
                               "pool was replaced") from e

    def start(self) -> float:
        """Bring every worker up (each imports the package, torch with it)
        by one small decode apiece; -> seconds."""
        t0 = time.perf_counter()
        tiny = base64.b64encode(png.encode_png(
            np.zeros((1, 1, 3), np.uint8))).decode()
        self.decode([(tiny, "warmup")] * self.workers)
        return time.perf_counter() - t0

    def close(self):
        with self._lock:
            self._pool.shutdown(wait=True, cancel_futures=True)


def _encode_image(arr: np.ndarray) -> str:
    return _encode_u8_png(np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8))


def _encode_u8_png(arr: np.ndarray) -> str:
    return base64.b64encode(png.encode_png(arr)).decode("ascii")


class _BatchItem:
    """One queued request awaiting a micro-batch slot."""

    __slots__ = ("group", "per", "shared", "event", "images", "nsfw",
                 "error", "batch_size", "seconds")

    def __init__(self, group, per, shared):
        self.group, self.per, self.shared = group, per, shared
        self.event = threading.Event()
        self.images = None
        self.nsfw = None
        self.error: Optional[Exception] = None
        self.batch_size = 0
        self.seconds = 0.0


class EditService:
    """The pipeline with the serving policy: one edit at a time on the
    card, request validation, optional startup warmup, and (opt-in) dynamic
    micro-batching: concurrent compatible requests coalesce into one
    ``pipeline.edit_batch`` run, which launches each step's kernels once
    for all of them."""

    MAX_BODY_BYTES = 16 * 1024 * 1024   # base64 images + embeds fit in ~4 MB
    MAX_SAMPLES = 4
    MAX_STEPS = 200
    BATCH_WAIT_TIMEOUT_S = 1800.0       # queued request gives up (500)
    IMAGES_PER_REQUEST = 2              # fg and bg, decoded in parallel

    def __init__(self, pipeline, size: int = 512, strict_shapes: bool = True,
                 max_body_bytes: Optional[int] = None,
                 max_batch: int = 1, batch_window_ms: float = 25.0,
                 preview_every: int = 0):
        self.pipeline = pipeline
        self.size = size
        self.max_batch = max(1, int(max_batch))
        self.decoder = DecodePool(self.IMAGES_PER_REQUEST * self.max_batch)
        self.decoder_start_s: Optional[float] = None
        # the handler thread's CPU seconds and the wall seconds of the last
        # request's image decode
        self.last_decode: Optional[Tuple[float, float]] = None
        self.lock = threading.Lock()
        self.warm = False
        self.requests_served = 0
        # in-flight progress: one edit holds the card at a time, so one dict
        # is the whole state; step counts come from preview-mode edits only
        self.preview_every = max(0, int(preview_every))
        self.progress = {"active": False, "step": None, "total": None}
        self.strict_shapes = strict_shapes
        self.max_body_bytes = max_body_bytes or self.MAX_BODY_BYTES
        # set by warmup(); None = no warm-shape pinning yet
        self.warm_steps: Optional[int] = None
        # dynamic micro-batching (off at max_batch=1); batches pad up to
        # the next warm size: powers of two, and max_batch itself
        self.batch_window_s = batch_window_ms / 1000.0
        self.warm_batch_sizes = []
        s = 1
        while s < self.max_batch:
            self.warm_batch_sizes.append(s)
            s *= 2
        self.warm_batch_sizes.append(self.max_batch)
        self.batches_run = 0
        self.batched_requests = 0
        self._queue: collections.deque = collections.deque()
        self._queue_cv = threading.Condition()
        self._closed = False
        if self.max_batch > 1:
            threading.Thread(target=self._batch_loop, daemon=True,
                             name="edit-batcher").start()

    def warmup(self, steps: int = 50):
        """Run the standard edit, its preview variant, the remove-mode edit
        and a batch at each warm size before accepting traffic (on the
        card: the kernels' build, the libraries' first-call heuristics, the
        allocator's growth), then pin the warm shapes. The image decoders
        come up first."""
        from blobctrl_torch.blob import math as blob_math
        self.decoder_start_s = self.decoder.start()
        size = self.size
        blank = np.full((size, size, 3), 255, np.uint8)
        gs = blob_math.blob_score_from_ellipse(
            ((size * 0.5, size * 0.5), (size * 0.3, size * 0.4), 0.0),
            size, size, (size // 8, size // 8)).numpy()
        kw = dict(fg_image=blank, bg_image=blank, gs_score=gs, height=size,
                  width=size, num_inference_steps=steps, guidance_scale=7.5,
                  seed=0, blobnet_conditioning_scale=1.2)
        if getattr(self.pipeline, "clip_params", None) is not None:
            kw["prompt"] = ""          # tokenizes fine; runs CLIP too
        else:
            rng = np.random.RandomState(0)
            ctx = self.pipeline.unet_cfg.cross_attention_dim
            kw["prompt_embeds"] = rng.randn(1, 77, ctx).astype(np.float32)
            kw["negative_prompt_embeds"] = kw["prompt_embeds"]
        if getattr(self.pipeline, "dino_params", None) is None:
            dc = self.pipeline.blobnet_cfg.conditioning_channels - 1
            kw["fg_dino_feats"] = np.zeros((1, dc), np.float32)
        with self.lock:
            self.pipeline(**kw)
            if self.preview_every > 0:
                self.pipeline(callback_on_step_end=lambda *a: None,
                              callback_interval=self.preview_every, **kw)
            # remove mode: strength 0 + bg-only score (see edit())
            kw_rm = dict(kw, blobnet_conditioning_scale=0.0,
                         gs_score=blob_math.removal_score(
                             (size // 8, size // 8)).numpy())
            self.pipeline(**kw_rm)
            if self.max_batch > 1:
                per = {k: kw[k] for k in ("fg_image", "bg_image", "gs_score")}
                per["seed"] = 0
                for k in ("prompt", "prompt_embeds",
                          "negative_prompt_embeds", "fg_dino_feats"):
                    if k in kw:
                        per[k] = kw[k]
                for s in self.warm_batch_sizes[1:]:
                    self.pipeline.edit_batch(
                        [per] * s, height=size, width=size,
                        num_inference_steps=steps, guidance_scale=7.5,
                        blobnet_conditioning_scale=1.2)
        self.warm_steps = steps
        self.warm = True

    def _validate_limits(self, req: dict, size: int, steps: int,
                         num_samples: int):
        """400 on requests beyond the resource caps, or at a size or step
        count other than the warm ones."""
        if not 1 <= num_samples <= self.MAX_SAMPLES:
            raise ValueError(
                f"num_samples must be in [1, {self.MAX_SAMPLES}]")
        if not 1 <= steps <= self.MAX_STEPS:
            raise ValueError(
                f"num_inference_steps must be in [1, {self.MAX_STEPS}]")
        if self.strict_shapes and self.warm_steps is not None:
            if size != self.size:
                raise ValueError(
                    f"size={size} is not warm-compiled (serving size "
                    f"{self.size}); cold shapes are rejected so that no "
                    "request allocates an unwarmed working set under the "
                    "serving lock")
            if steps != self.warm_steps:
                raise ValueError(
                    f"num_inference_steps={steps} is not warm-compiled "
                    f"(serving steps {self.warm_steps})")

    def _validate_cold_graph(self, req: dict):
        """A scheduler, sample count, encoder cache or preview+remove other
        than the warmed ones is refused under strict_shapes."""
        if not (self.strict_shapes and self.warm_steps is not None):
            return
        cold = []
        if str(req.get("scheduler", "unipc")) != "unipc":
            cold.append("scheduler")
        if int(req.get("num_samples", 1)) != 1:
            cold.append("num_samples")
        if int(req.get("encoder_cache_interval", 0)) != 0:
            cold.append("encoder_cache_interval")
        if bool(req.get("preview")) and bool(req.get("remove")):
            cold.append("preview+remove")
        if cold:
            raise ValueError(
                f"non-default {'/'.join(cold)} selects a graph that was not "
                "warm-compiled; start the server with strict_shapes=False "
                "or extend warmup to cover it")

    def _parse(self, req: dict):
        """Validate a request and split it into the per-request payload,
        the shared sampler configuration (everything a micro-batch must
        agree on), and extras that force the solo path."""
        from blobctrl_torch.blob import math as blob_math
        from blobctrl_torch.pipeline.blobnet_pipeline import normalize_gs
        size = int(req.get("size", self.size))
        steps = int(req.get("num_inference_steps", 50))
        num_samples = int(req.get("num_samples", 1))
        self._validate_limits(req, size, steps, num_samples)
        self._validate_cold_graph(req)
        if "fg_image" not in req or "bg_image" not in req:
            raise ValueError("fg_image and bg_image (base64) are required")
        t0, c0 = time.perf_counter(), time.thread_time()
        fg, bg = self.decoder.decode([(req["fg_image"], "fg_image"),
                                      (req["bg_image"], "bg_image")])
        self.last_decode = (time.thread_time() - c0,
                            time.perf_counter() - t0)

        lh, lw = size // 8, size // 8
        remove = bool(req.get("remove"))
        if remove:
            gs = blob_math.removal_score((lh, lw)).numpy()
            strength = 0.0
        elif "gs_score" in req:
            gs = np.asarray(req["gs_score"], np.float32)
            strength = float(req.get("blobnet_conditioning_scale", 1.2))
        elif "ellipse" in req:
            e = [float(v) for v in req["ellipse"]]
            if len(e) != 5:
                raise ValueError("ellipse must be [cx, cy, d1, d2, angle]")
            gs = blob_math.blob_score_from_ellipse(
                ((e[0], e[1]), (e[2], e[3]), e[4]), size, size,
                (lh, lw)).numpy()
            strength = float(req.get("blobnet_conditioning_scale", 1.2))
        else:
            raise ValueError("one of ellipse / gs_score / remove is required")
        # NHWC now, so the batch group key sees the true blob count
        gs = normalize_gs(gs, lh, lw).numpy()

        per = dict(fg_image=fg, bg_image=bg, gs_score=gs,
                   seed=req.get("seed"))
        # embed shapes are checked per request, so a malformed request
        # 400s alone instead of failing the micro-batch it joined
        ctx = self.pipeline.unet_cfg.cross_attention_dim
        if "prompt_embeds" in req:
            for k in ("prompt_embeds", "negative_prompt_embeds"):
                if k not in req:
                    continue
                v = np.asarray(req[k], np.float32)
                if v.ndim not in (2, 3) or v.shape[-1] != ctx:
                    raise ValueError(
                        f"{k} must be (seq, {ctx}) or (1, seq, {ctx}); "
                        f"got {v.shape}")
                per[k] = v
        else:
            per["prompt"] = req.get("prompt", "")
            if req.get("negative_prompt") is not None:
                per["negative_prompt"] = req["negative_prompt"]
        if "fg_dino_feats" in req:
            dc = self.pipeline.blobnet_cfg.conditioning_channels - 1
            v = np.asarray(req["fg_dino_feats"], np.float32)
            num_blobs = gs.shape[-1] - 1
            if (v.ndim not in (1, 2) or v.shape[-1] != dc
                    or (v.ndim == 2 and v.shape[0] not in (1, num_blobs))):
                raise ValueError(
                    f"fg_dino_feats must be (M={num_blobs}, {dc}); "
                    f"got {v.shape}")
            per["fg_dino_feats"] = v

        shared = dict(
            height=size, width=size, num_inference_steps=steps,
            guidance_scale=float(req.get("guidance_scale", 7.5)),
            blobnet_conditioning_scale=strength,
            blobnet_control_guidance_start=float(
                req.get("blobnet_control_guidance_start", 0.0)),
            blobnet_control_guidance_end=float(
                req.get("blobnet_control_guidance_end", 1.0)),
            scheduler=str(req.get("scheduler", "unipc")))
        preview = bool(req.get("preview"))
        if preview and self.preview_every == 0:
            raise ValueError(
                "preview requested but the server was started without "
                "preview support (preview_every=0 / no --preview_every)")
        extras = dict(num_samples=num_samples,
                      encoder_cache_interval=int(
                          req.get("encoder_cache_interval", 0)),
                      remove=remove, gs_channels=int(gs.shape[-1]),
                      preview=preview)
        return per, shared, extras

    def edit(self, req: dict) -> dict:
        per, shared, extras = self._parse(req)
        # micro-batching covers the standard serving request; multi-sample,
        # encoder-cache, remove and preview requests run solo under the
        # same lock
        eligible = (self.max_batch > 1 and extras["num_samples"] == 1
                    and extras["encoder_cache_interval"] == 0
                    and not extras["remove"] and not extras["preview"])
        if not eligible:
            return self._edit_solo(per, shared, extras)
        pe = per.get("prompt_embeds")
        group = (tuple(sorted(shared.items())), extras["gs_channels"],
                 # embeds batch only with embeds of the same length (one
                 # stacked array); string prompts tokenize to a fixed length
                 None if pe is None else pe.shape[-2],
                 "negative_prompt_embeds" in per)
        item = _BatchItem(group, per, shared)
        with self._queue_cv:
            if self._closed:  # no batcher is left to take it
                raise RuntimeError("the edit service is closed")
            self._queue.append(item)
            self._queue_cv.notify_all()
        if not item.event.wait(self.BATCH_WAIT_TIMEOUT_S):
            raise RuntimeError("timed out waiting for a batch slot")
        if item.error is not None:
            raise item.error
        resp = {"images": [_encode_image(im) for im in item.images],
                "seconds": round(item.seconds, 4),
                "batch_size": item.batch_size}
        if item.nsfw is not None:
            resp["nsfw_content_detected"] = [
                bool(v) for v in np.asarray(item.nsfw).ravel()]
        return resp

    def _edit_solo(self, per: dict, shared: dict, extras: dict) -> dict:
        kw = dict(shared)
        kw.update(fg_image=per["fg_image"], bg_image=per["bg_image"],
                  gs_score=per["gs_score"], seed=per.get("seed"),
                  num_images_per_prompt=extras["num_samples"],
                  encoder_cache_interval=extras["encoder_cache_interval"])
        for k in ("prompt", "negative_prompt", "prompt_embeds",
                  "negative_prompt_embeds", "fg_dino_feats"):
            if k in per:
                kw[k] = per[k]
        previews: List[str] = []
        preview_steps: List[int] = []
        if extras.get("preview"):
            from blobctrl_torch.pipeline import preview as preview_lib
            total = int(kw["num_inference_steps"])

            def on_step(_pipe, i, _t, tensors):
                # first sample only: previews are a UX aid, not output
                rgb = preview_lib.latent_to_rgb(
                    tensors["latents"][:1], upscale=2)[0]
                previews.append(_encode_u8_png(rgb))
                preview_steps.append(int(i))
                # the published step count stays monotone
                self.progress.update(
                    step=max(self.progress.get("step") or 0, int(i) + 1),
                    total=total)

            kw["callback_on_step_end"] = on_step
            kw["callback_interval"] = self.preview_every
        t0 = time.perf_counter()
        with self.lock:
            self.progress.update(
                active=True, step=None,
                total=int(kw["num_inference_steps"]))
            try:
                out = self.pipeline(**kw)
            finally:
                self.progress.update(active=False, step=None, total=None)
            self.requests_served += 1
        sec = time.perf_counter() - t0
        resp = {"images": [_encode_image(im) for im in out.images],
                "seconds": round(sec, 4)}
        if extras.get("preview"):
            # the callbacks arrive in step order here; sorted all the same,
            # as the JAX package's server sorts them
            order = np.argsort(preview_steps)
            resp["previews"] = [previews[i] for i in order]
            resp["preview_steps"] = [preview_steps[i] for i in order]
        if out.nsfw_content_detected is not None:
            resp["nsfw_content_detected"] = [
                bool(v) for v in np.asarray(out.nsfw_content_detected).ravel()]
        return resp

    # -- dynamic micro-batching ---------------------------------------

    def _batch_loop(self):
        """Dispatcher: wait for the queue head, give compatible requests
        ``batch_window_s`` to pile up (or until max_batch arrive), then run
        them as one edit_batch. Requests in other groups stay queued for
        the next iteration (FIFO by group of the current head)."""
        while True:
            with self._queue_cv:
                while not self._queue and not self._closed:
                    self._queue_cv.wait()
                if self._closed:  # ends the thread and its hold on the pipe
                    for it in self._queue:
                        it.error = RuntimeError("the edit service is closed")
                        it.event.set()
                    self._queue.clear()
                    return
                head_group = self._queue[0].group
            deadline = time.monotonic() + self.batch_window_s
            while time.monotonic() < deadline:
                with self._queue_cv:
                    n = sum(1 for it in self._queue
                            if it.group == head_group)
                if n >= self.max_batch:
                    break
                time.sleep(0.002)
            with self._queue_cv:
                batch: List[_BatchItem] = []
                rest: collections.deque = collections.deque()
                for it in self._queue:
                    if (it.group == head_group
                            and len(batch) < self.max_batch):
                        batch.append(it)
                    else:
                        rest.append(it)
                self._queue = rest
            self._run_batch(batch)

    def _run_batch(self, batch: List[_BatchItem]):
        try:
            reqs = [it.per for it in batch]
            # pad to the next warm size by repeating the last request: only
            # the warmed batch sizes ever run
            target = next(s for s in self.warm_batch_sizes
                          if s >= len(reqs))
            padded = reqs + [reqs[-1]] * (target - len(reqs))
            t0 = time.perf_counter()
            with self.lock:
                self.progress.update(
                    active=True, step=None,
                    total=int(batch[0].shared["num_inference_steps"]))
                try:
                    out = self.pipeline.edit_batch(padded, **batch[0].shared)
                finally:
                    self.progress.update(active=False, step=None, total=None)
                self.requests_served += len(batch)
            sec = time.perf_counter() - t0
            self.batches_run += 1
            self.batched_requests += len(batch)
            nsfw = out.nsfw_content_detected
            for i, it in enumerate(batch):
                it.images = out.images[i:i + 1]
                it.nsfw = None if nsfw is None else nsfw[i:i + 1]
                it.batch_size = len(batch)
                it.seconds = sec
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for it in batch:
                it.error = e
        finally:
            for it in batch:
                it.event.set()

    def info(self) -> dict:
        from blobctrl_torch.pipeline.blobnet_pipeline import SCHEDULER_NAMES
        dev = torch.device(getattr(self.pipeline, "device", "cpu"))
        return {
            "model": "blobctrl-torch (SD-1.5 + BlobNet)",
            "size": self.size,
            "schedulers": list(SCHEDULER_NAMES),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "warm": self.warm,
            "warm_steps": self.warm_steps,
            "strict_shapes": self.strict_shapes,
            "max_body_bytes": self.max_body_bytes,
            "max_samples": self.MAX_SAMPLES,
            "requests_served": self.requests_served,
            "max_batch": self.max_batch,
            "batch_window_ms": round(self.batch_window_s * 1000.0, 3),
            "batches_run": self.batches_run,
            "batched_requests": self.batched_requests,
            "preview_every": self.preview_every,
            "mesh": (None if getattr(self.pipeline, "mesh", None) is None
                     else dict(self.pipeline.mesh.shape)),
            "hybrid_cfg_data": bool(
                getattr(self.pipeline, "_hybrid_cfg_data", False)),
        }

    def close(self):
        """Stop the micro-batcher thread (queued requests fail), the image
        decoders and, on a mesh, the follower ranks; the service then holds
        the pipeline only through its own references."""
        with self._queue_cv:
            self._closed = True
            self._queue_cv.notify_all()
        self.decoder.close()
        if isinstance(self.pipeline, multihost.LeaderPipeline):
            self.pipeline.close()


def make_handler(service: EditService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload, content_type="application/json"):
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200 if service.warm else 503,
                           b"ok" if service.warm else b"warming up",
                           content_type="text/plain")
            elif self.path == "/v1/info":
                self._send(200, service.info())
            elif self.path == "/v1/progress":
                self._send(200, dict(service.progress))
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/edit":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > service.max_body_bytes:
                    self._send(413, {"error": (
                        f"body of {n} bytes exceeds the "
                        f"{service.max_body_bytes}-byte limit")})
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                self._send(200, service.edit(req))
            except (ValueError, KeyError, AssertionError, TypeError) as e:
                # wrong or missing fields, undecodable images, wrong JSON
                # types: client mistakes. Server-side errors are 500s.
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — survive bad requests
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # structured logging instead
            from blobctrl_torch.utils import observability
            observability.log_event("http", path=self.path,
                                    msg=fmt % args)
    return Handler


def serve(pipeline, host: str = "0.0.0.0", port: int = 8000,
          size: int = 512, warmup_steps: Optional[int] = 50,
          strict_shapes: bool = True,
          max_body_bytes: Optional[int] = None,
          max_batch: int = 1, batch_window_ms: float = 25.0,
          preview_every: int = 0):
    """-> (EditService, ThreadingHTTPServer); the caller runs
    ``serve_forever``. With warmup_steps the warmup runs in a background
    thread while /healthz answers 503."""
    service = EditService(pipeline, size=size, strict_shapes=strict_shapes,
                          max_body_bytes=max_body_bytes,
                          max_batch=max_batch,
                          batch_window_ms=batch_window_ms,
                          preview_every=preview_every)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    if warmup_steps:
        threading.Thread(target=service.warmup, args=(warmup_steps,),
                         daemon=True).start()
    else:
        service.warm = True
    return service, httpd


def _load_sharded(rank, world, address, models_root, device, spec, hybrid,
                  dtype, timeout_s):
    from blobctrl_torch.params import io as io_lib
    from blobctrl_torch.parallel import mesh as mesh_lib
    cpu = torch.device(device).type == "cpu"
    dev = multihost.initialize(address, world, rank, device=device,
                               backend="gloo" if cpu else "nccl",
                               timeout_s=timeout_s)
    pipe = io_lib.load_pipeline(models_root, dtype=dtype, device=dev)
    mesh_lib.shard_pipeline_from_flags(pipe, spec, hybrid)
    return pipe


def _follower(rank, world, address, conn, *load_args):
    """A follower rank: load and shard as rank 0 does, then run each edit
    rank 0 sends until it sends None. An edit refused by its arguments is
    dropped (rank 0 answers it); one that fails out of step ends the
    process: rank 0's edit then fails at its next collective."""
    try:
        pipe = _load_sharded(rank, world, address, *load_args)
        multihost.follow(conn, lambda cmd: multihost.run_followed(pipe, cmd))
    finally:
        multihost.shutdown()


def start_mesh(models_root: str, device: str, mesh_spec: Optional[str],
               hybrid_cfg_data: bool, dtype=torch.bfloat16,
               timeout_s: float = multihost.DEFAULT_TIMEOUT_S
               ) -> multihost.LeaderPipeline:
    """Spawn the follower ranks, load and shard the pipeline as rank 0,
    and return it wrapped so that every edit runs on all ranks. On the
    card one card a rank, rank r on cuda:r (device ``cuda``): a named
    card and more ranks than cards are refused."""
    from blobctrl_torch.parallel import mesh as mesh_lib
    shape = mesh_lib.resolve_mesh_shape(mesh_spec, hybrid_cfg_data, device)
    mesh_lib.check_mesh_device(device, shape)
    world = shape["data"] * shape["model"]
    spec = f"data={shape['data']},model={shape['model']}"
    address = f"127.0.0.1:{multihost.free_port()}"
    load_args = (models_root, device, spec, hybrid_cfg_data, dtype,
                 timeout_s)
    followers = multihost.Followers(_follower, world, address, load_args)
    try:
        pipe = _load_sharded(0, world, address, *load_args)
    except BaseException:
        followers.close()   # leaves the group, then joins them
        raise
    return multihost.LeaderPipeline(pipe, followers)


def main(argv=None):
    p = argparse.ArgumentParser(description="BlobCtrl serving (PyTorch port)")
    p.add_argument("--models_root", default="models")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--allow_cold_shapes", action="store_true",
                   help="accept requests whose size, steps or scheduler "
                        "were not warmed")
    p.add_argument("--max_batch", type=int, default=1,
                   help="dynamic micro-batching: coalesce up to this many "
                        "concurrent compatible requests into one batched "
                        "run (1 = off)")
    p.add_argument("--batch_window_ms", type=float, default=25.0,
                   help="how long the batcher waits for more requests "
                        "before dispatching a partial batch")
    p.add_argument("--preview_every", type=int, default=0,
                   help="enable in-flight latent previews: requests with "
                        '"preview": true get an approximate RGB thumbnail '
                        "every N steps plus live /v1/progress (0 = off)")
    p.add_argument("--mesh", default=None, metavar="data=N,model=M",
                   help="shard edits over data x model ranks: micro-batches "
                        "split over data, weights over model; one card a "
                        "rank")
    p.add_argument("--hybrid_cfg_data", action="store_true",
                   help="single-edit recipe: the CFG pair over the data "
                        "axis, the weights over model (data=2 x "
                        "model=<rest of the cards> when --mesh is not given)")
    args = p.parse_args(argv)
    if args.mesh or args.hybrid_cfg_data:
        pipeline = start_mesh(args.models_root, args.device, args.mesh,
                              args.hybrid_cfg_data)
        print(f"sharded over mesh {dict(pipeline.mesh.shape)}"
              f" (hybrid_cfg_data={args.hybrid_cfg_data})")
    else:
        from blobctrl_torch.params import io as io_lib
        pipeline = io_lib.load_pipeline(args.models_root,
                                        dtype=torch.bfloat16,
                                        device=args.device)
    service, httpd = serve(pipeline, args.host, args.port,
                           warmup_steps=None if args.no_warmup else 50,
                           strict_shapes=not args.allow_cold_shapes,
                           max_batch=args.max_batch,
                           batch_window_ms=args.batch_window_ms,
                           preview_every=args.preview_every)
    print(f"serving on {args.host}:{args.port} (warming up in background)")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
