"""Large photos on one card: the server at 1024^2, and the largest photo one
card edits.

Its parts, in this order, on a full-geometry models root written from a
seed (``chip_smoke.py`` phase 6's: SD-1.5 UNet, BlobNet, the VAE, CLIP
ViT-L/14 text, DINOv2-large, a rank-16 LoRA; fp16 safetensors) and loaded
in bf16:

  serve  ``apps.server.serve(pipe, size=1024, max_batch=4,
         warmup_steps=SERVE_STEPS, batch_window_ms=SERVE_WINDOW_MS)``:
         the seconds until ``/healthz``
         answers 200, then a solo request and four concurrent ones (text
         prompts, ellipses, PNG images; ``chip_smoke.serve_payload``):
         status 200, a batch of 1 and one of 4, and each image >= 40 dB
         from the pipeline's solo ``__call__`` of the same request (the
         server's own parse of it). Seconds on the server and the client,
         and each request's arrival at the service, the wall seconds of
         its image decode and its entry to the batcher's queue.
  sizes  the standard edit (``chip_smoke.photo_edit_kwargs``, exact, bf16,
         EDIT_STEPS steps) at each W x H of SIZES, largest last: its
         seconds and peak memory, every launch on the tensor cores, the
         output finite, of the photo's shape and not all black; or, where
         it does not fit, the error it raised, the allocation that failed
         and where. Before each, the reckoned bytes of the VAE mid-block's
         fp32 attention scores (the fg and bg images encoded in one call,
         one head over (H/8)(W/8) tokens: 2 ((H/8)(W/8))^2 4 bytes).
  cli    ``python -m blobctrl_torch.apps.cli --device cuda`` as a process,
         the pipeline above released first, on ``assets/jpeg_timing``'s
         4032x3024 JPEG (a phone photo) as object and background, which it
         edits at the photo's own size: its exit code, seconds, the device
         memory in use sampled every 0.5 s while it runs, and its PNG;
         where it fails, the error and the allocation from its stderr, and
         no image file in its output directory.

A size that does not fit (``torch.OutOfMemoryError``) is no failure of
the script; any other error is, and so is a failure that is not a raised
error (a partial, black or non-finite image, a CLI exit code 0 without its
PNG, a PNG where the CLI failed), as is any bar above.

Run from the repository root on a machine with one card:

  python scripts/torch_large_photos.py [--out chiprun_out/large_photos.json]

It prints the card's name and power limit and every reading, and writes
them as JSON to --out. Exit code 1 where a check fails."""

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SERVE_SIZE = 1024
SERVE_STEPS = 4         # the server's warm steps, and its requests'
SERVE_BATCH = 4
SERVE_WINDOW_MS = 1500.0  # the micro-batcher's window, chip_smoke.py's
EDIT_STEPS = 10         # chip_smoke.py's STEPS
SIZES = ((1024, 1024), (1536, 1024), (1536, 1536), (1792, 1792),
         (2048, 2048))   # W x H, largest last
PHONE_JPEG = os.path.join(ROOT, "assets", "jpeg_timing",
                          "photo_4032x3024_420.jpg")
PHONE_ELLIPSE = "2016,1512,1400,1000,20"   # xc, yc, d1, d2, degrees
CLI_TIMEOUT_S = 900


def log(*args):
    print(*args, flush=True)


def vae_scores_bytes(w: int, h: int, images: int = 2) -> int:
    """The VAE mid-block's fp32 attention scores for ``images`` images at W
    x H: one head over (H/8)(W/8) tokens."""
    n = (h // 8) * (w // 8)
    return images * n * n * 4


def failure(e: BaseException) -> dict:
    """A raised error: its type, its first line (with the failed
    allocation, for an out-of-memory error) and the innermost frame of the
    port that raised it."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "blobctrl_torch" in f.filename]
    where = (f"{os.path.relpath(frames[-1].filename, ROOT)}:"
             f"{frames[-1].lineno} ({frames[-1].name})" if frames else None)
    return {"error": type(e).__name__, "message": str(e).splitlines()[0],
            "where": where}


# ---------------------------------------------------------------------------
# part serve
# ---------------------------------------------------------------------------

def timed_parse(service) -> list:
    """Time each request that ``service`` parses, on the handler thread that
    parses it: -> a list that gains {"seed", "arrived_s", "decode_s",
    "queued_s"} a request (perf_counter seconds; decode_s the wall seconds
    of its images' decode in the worker processes; the request enters the
    batcher's queue as its parse returns). Per thread, since
    ``EditService.last_decode`` is one slot that concurrent requests
    overwrite."""
    rows, local = [], threading.local()
    parse, decode = service._parse, service.decoder.decode

    def timed_decode(items):
        t = time.perf_counter()
        try:
            return decode(items)
        finally:
            local.decode_s = time.perf_counter() - t

    def timed(req):
        t = time.perf_counter()
        got = parse(req)
        rows.append({"seed": req.get("seed"), "arrived_s": t,
                     "decode_s": local.decode_s,
                     "queued_s": time.perf_counter()})
        return got
    service.decoder.decode = timed_decode
    service._parse = timed
    return rows


def serve(pipe) -> dict:
    from blobctrl_torch.apps import server
    reqs = cs.serving_requests(SERVE_SIZE, SERVE_BATCH)
    payloads = [cs.serve_payload(r, b, SERVE_SIZE, SERVE_STEPS)
                for b, r in enumerate(reqs)]
    t0 = time.perf_counter()
    service, httpd = server.serve(pipe, host="127.0.0.1", port=0,
                                  size=SERVE_SIZE, warmup_steps=SERVE_STEPS,
                                  max_batch=SERVE_BATCH,
                                  batch_window_ms=SERVE_WINDOW_MS)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    got, report = {}, {}
    timeline = timed_parse(service)
    try:
        while cs._http(base + "/healthz")[0] != 200:
            if time.perf_counter() - t0 > 900:
                raise AssertionError("warmup did not finish in 900 s")
            time.sleep(0.25)
        report["warmup_s"] = time.perf_counter() - t0
        log(f"  warmup at {SERVE_SIZE}^2, {SERVE_STEPS} steps (standard, "
            f"preview, remove, batches of 2 and 4): {report['warmup_s']:.2f}"
            f" s until /healthz is 200; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        for part, sent in (("solo", payloads[:1]), ("batch", payloads)):
            timeline.clear()
            t_sent = time.perf_counter()
            rows = report[part] = []
            for b, (c, resp, img, wall) in enumerate(cs.concurrent_edits(
                    base, sent)):
                rows.append({"code": c, "batch_size": resp.get("batch_size"),
                             "server_s": resp.get("seconds"),
                             "client_s": wall})
                got[f"{part} {b}"] = (b, img)
            seeds = [p["seed"] for p in sent]
            for t in timeline:   # seconds from the send
                rows[seeds.index(t["seed"])].update(
                    arrived_s=t["arrived_s"] - t_sent, decode_s=t["decode_s"],
                    queued_s=t["queued_s"] - t_sent)
            for b, row in enumerate(rows):
                log(f"  {part} request {b}: {row}")
            queued = [t["queued_s"] for t in timeline] or [0.0]
            log(f"  {part}: {len(timeline)} requests entered the queue over "
                f"{max(queued) - min(queued):.3f} s (window "
                f"{SERVE_WINDOW_MS / 1e3:.1f} s)")
            want = len(sent)
            bad = [b for b, row in enumerate(rows) if row["code"] != 200
                   or row["batch_size"] != want]
            if bad:
                raise AssertionError(f"{part}: requests {bad} were not "
                                     f"answered in a batch of {want}")
        # the pipeline's solo edit of each request, as the server parses it
        parsed = [service._parse(p)[:2] for p in payloads]
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    want = {}
    for b, (per, shared) in enumerate(parsed):
        want[b] = pipe(**shared, **per).images
    report["psnr"] = {}
    for name, (b, img) in got.items():
        p = cs.psnr(img, want[b])
        report["psnr"][name] = p
        log(f"  {name}: PSNR against the pipeline's solo edit {p:.2f} dB "
            f"(bar 40)")
        if img.shape != (1, SERVE_SIZE, SERVE_SIZE, 3) or not p >= 40.0:
            raise AssertionError(f"{name}: {img.shape}, {p} dB")
    return report


# ---------------------------------------------------------------------------
# part sizes
# ---------------------------------------------------------------------------

def sizes(pipe) -> dict:
    from blobctrl_torch import ops
    report, faults = {}, []
    for w, h in SIZES:
        cell = report[f"{w}x{h}"] = {
            "vae_scores_gb": vae_scores_bytes(w, h) / 1e9}
        log(f"  {w}x{h} (W x H), {EDIT_STEPS} steps, exact, bf16: the VAE "
            f"mid-block's fp32 scores {cell['vae_scores_gb']:.2f} GB "
            f"(fg and bg in one call)")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        kw = cs.photo_edit_kwargs((w, h), EDIT_STEPS)
        out = None
        t0 = time.perf_counter()
        try:
            out = pipe(**kw).images
            torch.cuda.synchronize()
        except RuntimeError as e:   # torch.OutOfMemoryError among them
            cell.update(failure(e))
        cell["seconds"] = time.perf_counter() - t0
        cell["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if out is None:
            log(f"    raised {cell['error']} after {cell['seconds']:.2f} s "
                f"at {cell['where']}, peak memory {cell['peak_gib']:.2f} "
                f"GiB: {cell['message']}")
            if cell["error"] != "OutOfMemoryError":   # not a size limit
                faults.append(f"{w}x{h}: {cell['error']} {cell['message']}")
            continue
        del kw
        counts = cs.launch_counts()
        cell["launches"] = {k: n for k, n in counts.items() if n}
        cs.check_tensor_cores(f"{w}x{h}", counts, cs.EXACT)
        black = not np.any(out)
        cell["ok"] = (out.shape == (1, h, w, 3)
                      and bool(np.isfinite(out).all()) and not black)
        log(f"    {cell['seconds']:.2f} s, peak memory {cell['peak_gib']:.2f}"
            f" GiB, output {out.shape}, finite and not black: {cell['ok']}, "
            f"launches {cell['launches']}")
        if not cell["ok"]:
            faults.append(f"{w}x{h}: {out.shape}, black {black}")
    if faults:
        raise AssertionError("; ".join(faults))
    return report


# ---------------------------------------------------------------------------
# part cli
# ---------------------------------------------------------------------------

def cli(models_root: str, work: str) -> dict:
    """The CLI on the phone photo, the card otherwise empty."""
    from blobctrl_torch.utils import png
    out_dir = os.path.join(work, "cli_out")
    argv = [sys.executable, "-m", "blobctrl_torch.apps.cli",
            "--models_root", models_root, "--device", "cuda",
            "--object_image", PHONE_JPEG, "--edited_background", PHONE_JPEG,
            "--scene_prompt", cs.PROMPT, "--ellipse", PHONE_ELLIPSE,
            "--num_inference_steps", str(EDIT_STEPS), "--output_dir",
            out_dir]
    total = torch.cuda.mem_get_info()[1]
    used, done = [], threading.Event()

    def sample():   # every process's memory on the card
        while not done.wait(0.5):
            used.append(total - torch.cuda.mem_get_info()[0])
    sampler = threading.Thread(target=sample)
    sampler.start()
    t0 = time.perf_counter()
    try:
        run = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT_S)
    finally:
        done.set()
        sampler.join()
    report = {"exit_code": run.returncode,
              "seconds": time.perf_counter() - t0,
              "peak_in_use_gib": max(used, default=0) / 2 ** 30,
              "pngs": sorted(os.listdir(out_dir))
              if os.path.isdir(out_dir) else []}
    err = run.stderr.strip().splitlines()
    report["stderr_tail"] = err[-12:]
    report["error"] = err[-1] if err else None
    frames = [ln.strip() for ln in err
              if ln.strip().startswith("File ") and "blobctrl_torch" in ln]
    report["where"] = frames[-1] if frames else None
    log(f"  the CLI on the 4032x3024 JPEG, {EDIT_STEPS} steps: exit code "
        f"{run.returncode} after {report['seconds']:.1f} s, the card's "
        f"memory in use up to {report['peak_in_use_gib']:.2f} GiB, files "
        f"written {report['pngs']}")
    if run.returncode != 0:
        log(f"    its error: {report['error']}\n    raised at: "
            f"{report['where']}")
        if report["pngs"] or "OutOfMemoryError" not in (report["error"]
                                                        or ""):
            raise AssertionError(f"the CLI failed other than out of memory, "
                                 f"or wrote {report['pngs']}")
        return report
    if report["pngs"] != ["edit_0.png"]:
        raise AssertionError(f"the CLI exited 0 and wrote {report['pngs']}")
    with open(os.path.join(out_dir, "edit_0.png"), "rb") as f:
        img = png.decode_png(f.read())
    report["shape"] = list(img.shape)
    if img.shape != (3024, 4032, 3) or not img.any():
        raise AssertionError(f"the CLI's PNG: {img.shape}, black "
                             f"{not img.any()}")
    return report


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_large_photos: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log(card)
    work = tempfile.mkdtemp(prefix="large_photos_")
    try:
        return run(a, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(a, card, work):
    from blobctrl_torch.ops import _build
    from blobctrl_torch.params import export, io
    from blobctrl_torch.utils import benchkit
    torch.backends.cudnn.allow_tf32 = False   # as chip_smoke.py's edits
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build {time.perf_counter() - t0:.1f} s")
    root = os.path.join(work, "models_root")
    os.makedirs(root)
    cfgs = cs.reference_configs()
    trees, lora = cs.draw_reference_trees(cfgs, 7, "cuda")
    export.write_models_root(
        root, unet=trees["unet"], unet_cfg=cfgs["unet"],
        blobnet=trees["blobnet"], blobnet_cfg=cfgs["blobnet"],
        vae=trees["vae"], vae_cfg=cfgs["vae"], clip=trees["clip"],
        clip_cfg=cfgs["clip"], dino=trees["dino"], dino_cfg=cfgs["dino"],
        lora=lora, lora_alpha=cs.LORA_ALPHA,
        tokenizer=benchkit.byte_level_tokenizer(),
        float_dtype=torch.float16)
    del trees, lora
    torch.cuda.empty_cache()
    pipe = io.load_pipeline(root, dtype=torch.bfloat16, device="cuda")
    log(f"models root written and loaded in bf16: "
        f"{time.perf_counter() - t0:.1f} s")
    report, failed = {"card": card, "parts": {}}, []
    steps = {"serve": lambda: serve(pipe), "sizes": lambda: sizes(pipe)}
    for part in ("serve", "sizes", "cli"):
        log(f"part {part}")
        if part == "cli":   # the card to the CLI's process alone
            del pipe, steps
            gc.collect()
            torch.cuda.empty_cache()
            steps = {"cli": lambda: cli(root, work)}
        t0 = time.perf_counter()
        got = {}
        try:
            got = steps[part]()
        except Exception:  # noqa: BLE001 — the next part runs all the same
            log(traceback.format_exc())
            failed.append(part)
        got["part_seconds"] = time.perf_counter() - t0
        report["parts"][part] = got
        log(f"part {part}: {'FAILED' if part in failed else 'ok'} in "
            f"{got['part_seconds']:.1f} s")
    report["failed"] = failed
    report["ok"] = not failed
    log(json.dumps({"ok": report["ok"], "failed": failed, "card": card}))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1, default=repr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
