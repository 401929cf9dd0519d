"""One-command checkpoint day, a dry run on the port (counterpart of
``blobctrl_tpu/apps/checkpoint_day.py``): every verification the day the
published checkpoints are on disk, in one report.

    python -m blobctrl_torch.apps.checkpoint_day --models_root models \\
        --json_out checkpoint_day.json

Stages (each isolated: a failure is recorded and the run goes on, so the
report shows everything that needs attention):

  1. ``download``   — the port never fetches anything. The stage is
                      skipped with --skip_download or when the layout is
                      on disk; otherwise it fails with an error that names
                      the layout (``params/export.write_models_root``
                      writes it) and the run stops with ``overall`` false.
  2. ``load``       — the loader drill: ``params/io.load_pipeline`` over
                      the reference layout; counts the elements of the
                      port's parameter trees.
  3. ``ui_goldens`` — the weight-independent recorded UI pixels
                      (``apps/ui_render``; needs no checkpoint).
  4. ``exact``      — ``replay.score_all``: PSNR outside the edit ellipses
                      of the generated pixels against the recorded results
                      galleries. Gate: mean >= --exact_gate_db.
  5. fast modes     — the same scoring under each opt-in lossy mode
                      (``int8``, ``cfg_window``, ``encoder_cache``,
                      ``int8_cache`` stacked). Gate: each mode's mean PSNR
                      within --fast_gate_drop_db of the exact mean.

The int8 modes switch the int8 convs and the int8 global-k flash attention
on for their stage and off after it, as the JAX run does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

FAST_MODES = ("int8", "cfg_window", "encoder_cache", "int8_cache")

# provisional gates: fail an obviously broken load loudly, let bf16 sampler
# drift through
DEFAULT_EXACT_GATE_DB = 30.0
DEFAULT_FAST_GATE_DROP_DB = 3.0
DEFAULT_CFG_WINDOW = (0.15, 0.75)
DEFAULT_ENCODER_CACHE_INTERVAL = 3

_LAYOUT = ("stable-diffusion-v1-5/unet", "BlobCtrl/blobnet")


def _checkpoints_present(models_root: str) -> bool:
    return all(os.path.isdir(os.path.join(models_root, d)) for d in _LAYOUT)


def _stage(report: Dict, name: str, fn: Callable[[], Dict]):
    t0 = time.time()
    row: Dict = {"stage": name}
    try:
        row.update(fn() or {})
        row.setdefault("ok", True)
    except BaseException as e:  # noqa: BLE001 — keep auditing later stages
        if isinstance(e, KeyboardInterrupt):
            raise
        row.update(ok=False, error=f"{type(e).__name__}: {e}")
    row["seconds"] = round(time.time() - t0, 2)
    report["stages"].append(row)
    return row


def _mean_psnr(rows: List[Dict]) -> Optional[float]:
    vals = [r["psnr_db"] for r in rows if r.get("psnr_db") is not None]
    return float(sum(vals) / len(vals)) if vals else None


def _int8_mode(on: bool):
    """The int8-everything bundle (the flags ``replay --int8`` sets; the
    int8 linears stay out)."""
    from blobctrl_torch.nn import attention
    from blobctrl_torch.ops import conv3x3 as conv_mod
    attention.set_attention_backend("auto", qk_int8=on, int8_global_k=on)
    conv_mod.set_conv_int8(on)


def _count_elements(tree) -> int:
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_count_elements(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_elements(v) for v in tree)
    return int(tree.numel()) if hasattr(tree, "numel") else 0


def _download_refusal(models_root: str):
    raise FileNotFoundError(
        f"no checkpoints under {models_root!r} and the port downloads "
        f"nothing: lay out {', '.join(_LAYOUT)} (and the rest of the "
        f"reference layout that params/export.write_models_root writes) "
        f"there, or pass --skip_download")


def run_checkpoint_day(models_root: str = "models",
                       demo_root: str = "assets/results/demo",
                       skip_download: bool = False,
                       steps: Optional[int] = None,
                       num_samples: Optional[int] = None,
                       exact_gate_db: float = DEFAULT_EXACT_GATE_DB,
                       fast_gate_drop_db: float = DEFAULT_FAST_GATE_DROP_DB,
                       fast_modes: tuple = FAST_MODES,
                       score_ui: bool = True,
                       names: Optional[List[str]] = None,
                       load_pipeline: Optional[Callable] = None,
                       dtype=None, device="cuda") -> Dict:
    """Run every checkpoint-day stage; returns the report dict.

    ``load_pipeline`` is injectable (defaults to ``params/io.load_pipeline``
    on ``device`` in ``dtype``, bf16 unless given). ``steps``/``num_samples``
    override the recorded state values."""
    report: Dict = {"models_root": models_root, "demo_root": demo_root,
                    "stages": [], "gates": {}}

    # ---- 1. download (never fetched) -----------------------------------
    if skip_download or _checkpoints_present(models_root):
        report["stages"].append(
            {"stage": "download", "ok": True, "skipped": True, "seconds": 0.0,
             "reason": ("--skip_download" if skip_download
                        else "layout already present")})
    else:
        _stage(report, "download", lambda: _download_refusal(models_root))
        report["gates"]["overall"] = False
        return report

    # ---- 2. loader drill ---------------------------------------------
    pipe_box: Dict = {}

    def _load():
        if load_pipeline is not None:
            pipe_box["pipe"] = load_pipeline(models_root)
        else:
            import torch

            from blobctrl_torch.params import io as io_lib
            pipe_box["pipe"] = io_lib.load_pipeline(
                models_root, dtype=torch.bfloat16 if dtype is None else dtype,
                device=device)
        p = pipe_box["pipe"]
        n_params = sum(_count_elements(tree) for tree in (
            p.unet_params, p.blobnet_params, p.vae_params, p.clip_params,
            p.dino_params))
        return {"total_params": n_params}

    if not _stage(report, "load", _load)["ok"]:
        report["gates"]["overall"] = False
        return report
    pipe = pipe_box["pipe"]

    # ---- 3. weight-independent UI goldens -----------------------------
    if score_ui:
        def _ui():
            from blobctrl_torch.apps import ui_render
            results = ui_render.score_ui_all(demo_root)
            arts = [s for r in results.values() for s in r.values()]
            return {"artifacts": len(arts),
                    "bit_exact": sum(int(s["exact"]) for s in arts)}
        _stage(report, "ui_goldens", _ui)

    # ---- 4. exact score + 5. fast-mode gates ---------------------------
    from blobctrl_torch.apps import replay as replay_lib

    def _score(pipe_kwargs=None, setup=None, teardown=None):
        def inner():
            if setup:
                setup()
            try:
                rows = replay_lib.score_all(pipe, demo_root, names=names,
                                            num_inference_steps=steps,
                                            num_samples=num_samples,
                                            pipe_kwargs=pipe_kwargs)
            finally:
                if teardown:
                    teardown()
            return {"mean_psnr_db": _mean_psnr(rows), "rows": rows}
        return inner

    exact_row = _stage(report, "exact", _score())
    exact_psnr = exact_row.get("mean_psnr_db")
    report["gates"]["exact"] = (exact_row["ok"] and exact_psnr is not None
                                and exact_psnr >= exact_gate_db)

    w0, w1 = DEFAULT_CFG_WINDOW
    mode_runs = {
        "int8": _score(setup=lambda: _int8_mode(True),
                       teardown=lambda: _int8_mode(False)),
        "cfg_window": _score({"cfg_guidance_start": w0,
                              "cfg_guidance_end": w1}),
        "encoder_cache": _score(
            {"encoder_cache_interval": DEFAULT_ENCODER_CACHE_INTERVAL}),
        "int8_cache": _score(
            {"encoder_cache_interval": DEFAULT_ENCODER_CACHE_INTERVAL},
            setup=lambda: _int8_mode(True),
            teardown=lambda: _int8_mode(False)),
    }
    for mode in fast_modes:
        row = _stage(report, mode, mode_runs[mode])
        p = row.get("mean_psnr_db")
        row["psnr_drop_db"] = (None if p is None or exact_psnr is None
                               else exact_psnr - p)
        report["gates"][mode] = bool(
            row["ok"] and row["psnr_drop_db"] is not None
            and row["psnr_drop_db"] <= fast_gate_drop_db)

    report["gates"]["overall"] = all(
        report["gates"].get(k, False)
        for k in ("exact", *fast_modes)) and all(
        s["ok"] for s in report["stages"])
    return report


def print_report(report: Dict):
    print(f"{'stage':<14} {'ok':>3} {'s':>8} {'mean PSNR (dB)':>15} "
          f"{'drop':>6}")
    print("-" * 50)
    for s in report["stages"]:
        p = s.get("mean_psnr_db")
        d = s.get("psnr_drop_db")
        note = ("skipped" if s.get("skipped")
                else s.get("error", "")[:40] if not s["ok"] else "")
        print(f"{s['stage']:<14} {'y' if s['ok'] else 'N':>3} "
              f"{s['seconds']:>8.1f} "
              f"{(f'{p:.2f}' if p is not None else '-'):>15} "
              f"{(f'{d:+.2f}' if d is not None else '-'):>6}  {note}")
    print(json.dumps({"gates": report["gates"]}))


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Checkpoint day: load drill -> UI goldens -> replay "
                    "--all --score -> fast-mode gates, one command (never "
                    "downloads)")
    p.add_argument("--models_root", default="models")
    p.add_argument("--demo_root", default="assets/results/demo")
    p.add_argument("--skip_download", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--steps", type=int, default=None,
                   help="override recorded num_inference_steps (debug)")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--exact_gate_db", type=float,
                   default=DEFAULT_EXACT_GATE_DB)
    p.add_argument("--fast_gate_drop_db", type=float,
                   default=DEFAULT_FAST_GATE_DROP_DB)
    p.add_argument("--fast_modes", default=",".join(FAST_MODES),
                   help="comma list from %s; empty to skip" % (FAST_MODES,))
    p.add_argument("--no_ui", action="store_true",
                   help="skip the weight-independent UI golden scoring")
    p.add_argument("--json_out", default=None)
    args = p.parse_args(argv)

    modes = tuple(m for m in args.fast_modes.split(",") if m)
    for m in modes:
        assert m in FAST_MODES, f"unknown fast mode {m!r}"
    report = run_checkpoint_day(
        args.models_root, args.demo_root, skip_download=args.skip_download,
        steps=args.steps, num_samples=args.num_samples,
        exact_gate_db=args.exact_gate_db,
        fast_gate_drop_db=args.fast_gate_drop_db, fast_modes=modes,
        score_ui=not args.no_ui, device=args.device)
    print_report(report)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if report["gates"]["overall"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
