"""Demo-state replay (counterpart of ``blobctrl_tpu/apps/replay.py``): a
state directory (``state/state.json`` plus the input, object, edited
background and, optionally, recorded ``results_gallery`` images, as
``apps/session.BlobCtrlSession.save_state`` writes it and the reference
demo ships it) is replayed through the port's pipeline and scored by the
PSNR outside the edit ellipses against the recorded results.

    python -m blobctrl_torch.apps.replay --models_root models \\
        --demo_root assets/results/demo --all --score

Images are PNG or JPEG (``utils/image.py``). ``--score_ui`` scores the
recorded UI goldens with ``apps/ui_render`` and needs no checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

# the reference's 9 demo states
EXAMPLE_ORDER = ["move_hat", "move_cup", "enlarge_deer", "shrink_dragon",
                 "remove_shit", "remove_cow", "compose_rabbit",
                 "compose_cake", "replace_knife"]


def load_state(demo_dir: str) -> Dict:
    with open(os.path.join(demo_dir, "state", "state.json")) as f:
        return json.load(f)


def _ellipse_from_state(entry) -> tuple:
    (c, axes, ang) = entry
    return ((float(c[0]), float(c[1])), (float(axes[0]), float(axes[1])),
            float(ang))


def _read(path: str) -> np.ndarray:
    from blobctrl_torch.utils import image
    return image.read_image(path)


def load_images(demo_dir: str):
    """-> (object image, edited background or None, input image, [recorded
    results]) as (H, W, 3) uint8 arrays."""
    fg = _read(os.path.join(demo_dir, "object_image_gallery",
                            "validation_object_region_center.png"))
    bg_path = os.path.join(demo_dir, "edited_result_gallery",
                           "edited_result_gallery_0.png")
    bg = _read(bg_path) if os.path.exists(bg_path) else None
    orig = _read(os.path.join(demo_dir, "input_image", "input_image.png"))
    expected_dir = os.path.join(demo_dir, "results_gallery")
    expected = []
    if os.path.isdir(expected_dir):
        for name in sorted(os.listdir(expected_dir)):
            expected.append(_read(os.path.join(expected_dir, name)))
    return fg, bg, orig, expected


def replay(pipeline, demo_dir: str, num_inference_steps: Optional[int] = None,
           num_samples: Optional[int] = None,
           pipe_kwargs: Optional[Dict] = None):
    """-> (images (N, H, W, 3) float, state, final_ellipse). pipe_kwargs:
    extra pipeline kwargs (e.g. cfg_guidance_start/end,
    encoder_cache_interval)."""
    from blobctrl_torch.blob import math as blob_math
    from blobctrl_torch.blob import viz as viz_lib

    state = load_state(demo_dir)
    fg, bg, orig, _ = load_images(demo_dir)
    height, width = fg.shape[:2]
    lh, lw = height // 8, width // 8
    remove = bool(state.get("remove_blob_box"))
    n = num_samples if num_samples is not None else int(state["num_samples"])
    steps = num_inference_steps if num_inference_steps is not None \
        else int(state["num_inference_steps"])

    if not remove:
        final_ellipse = _ellipse_from_state(state["ellipse_lists"][-1][0])
        gs = blob_math.blob_score_from_ellipse(final_ellipse, width, height,
                                               (lh, lw))
        strength = float(state["blobnet_control_strength"])
        assert bg is not None, f"{demo_dir} missing edited background"
        bg_img = bg
    else:
        final_ellipse = _ellipse_from_state(state["ellipse_lists"][0][0])
        gs = blob_math.removal_score((lh, lw))
        strength = 0.0
        start_mask = viz_lib.ellipse_mask(final_ellipse, height, width)
        bg_img = viz_lib.composite_mask_and_image(start_mask, orig,
                                                  (255, 255, 255))

    out = pipeline(
        prompt=[state["scene_prompt"]] * n,
        fg_image=fg, bg_image=bg_img, gs_score=gs.numpy(),
        height=height, width=width, num_inference_steps=steps,
        guidance_scale=float(state["guidance_scale"]),
        seed=int(state["seed"]),
        blobnet_conditioning_scale=strength,
        blobnet_control_guidance_start=float(
            state["blobnet_control_guidance_start"]),
        blobnet_control_guidance_end=float(
            state["blobnet_control_guidance_end"]),
        **(pipe_kwargs or {}))
    return out.images, state, final_ellipse


def outside_mask_psnr(images: np.ndarray, expected: np.ndarray,
                      ellipses, height: int = 512, width: int = 512) -> float:
    """PSNR over the pixels outside the union of the edit ellipses."""
    from blobctrl_torch.blob import viz as viz_lib
    mask = np.zeros((height, width), bool)
    for e in ellipses:
        mask |= viz_lib.ellipse_mask(e, height, width) > 0
    outside = ~mask
    a = np.asarray(images, np.float32)
    b = np.asarray(expected, np.float32)
    if b.max() > 1.5:
        b = b / 255.0
    mse = float(np.mean((a[..., outside, :] - b[..., outside, :]) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(1.0 / mse)


def score_state(pipeline, demo_dir: str,
                num_inference_steps: Optional[int] = None,
                num_samples: Optional[int] = None,
                pipe_kwargs: Optional[Dict] = None) -> Dict:
    """Replay one state and score it against its recorded results_gallery
    pixels, outside the union of every ellipse of the state."""
    images, state, final_ellipse = replay(pipeline, demo_dir,
                                          num_inference_steps, num_samples,
                                          pipe_kwargs)
    _, _, _, expected = load_images(demo_dir)
    row: Dict = {"name": os.path.basename(demo_dir.rstrip("/")),
                 "seed": int(state["seed"]),
                 "steps": (num_inference_steps
                           or int(state["num_inference_steps"])),
                 "num_scored": 0, "psnr_db": None}
    if not expected:
        row["note"] = "no recorded results_gallery"
        return row
    ellipses = [_ellipse_from_state(e[0]) for e in state["ellipse_lists"]]
    ellipses.append(final_ellipse)
    h, w = images.shape[1:3]
    k = min(len(images), len(expected))
    per = [outside_mask_psnr(images[i], expected[i], ellipses, h, w)
           for i in range(k)]
    row.update(num_scored=k, psnr_db=float(np.mean(per)),
               per_sample=[float(p) for p in per])
    return row


def score_all(pipeline, demo_root: str, names: Optional[List[str]] = None,
              num_inference_steps: Optional[int] = None,
              num_samples: Optional[int] = None,
              pipe_kwargs: Optional[Dict] = None) -> List[Dict]:
    if names is None:
        names = [n for n in EXAMPLE_ORDER
                 if os.path.isfile(os.path.join(demo_root, n, "state",
                                                "state.json"))]
    return [score_state(pipeline, os.path.join(demo_root, n),
                        num_inference_steps, num_samples, pipe_kwargs)
            for n in names]


def print_score_table(rows: List[Dict]) -> Dict:
    header = (f"{'state':<16} {'steps':>5} {'n':>2} "
              f"{'outside-mask PSNR (dB)':>24}")
    print(header)
    print("-" * len(header))
    scored = []
    for r in rows:
        p = r["psnr_db"]
        ptxt = f"{p:.2f}" if p is not None else r.get("note", "-")
        print(f"{r['name']:<16} {r['steps']:>5} {r['num_scored']:>2} "
              f"{ptxt:>24}")
        if p is not None:
            scored.append(p)
    summary = {"metric": "outside_mask_psnr_db_vs_reference_goldens",
               "mean_psnr_db": float(np.mean(scored)) if scored else None,
               "min_psnr_db": float(np.min(scored)) if scored else None,
               "states_scored": len(scored), "states_total": len(rows)}
    print(json.dumps(summary))
    return summary


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Replay recorded demo states and score the PSNR outside "
                    "their ellipses against their results_gallery pixels")
    p.add_argument("--models_root", default="models")
    p.add_argument("--demo_root", default="assets/results/demo")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--all", action="store_true",
                   help="replay every available state (default if no --name)")
    p.add_argument("--name", action="append", default=None,
                   help="state name (repeatable); default: all")
    p.add_argument("--score", action="store_true",
                   help="score against the recorded pixels (otherwise just "
                        "replay)")
    p.add_argument("--steps", type=int, default=None,
                   help="override num_inference_steps")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--json_out", default=None,
                   help="write the per-state rows to this JSON file")
    p.add_argument("--int8", action="store_true",
                   help="score under the opt-in int8-everything mode (int8 "
                        "global-k flash + int8 convs)")
    p.add_argument("--cfg_window", default=None, metavar="START,END",
                   help="score under guidance-interval CFG, e.g. 0.15,0.75")
    p.add_argument("--score_ui", action="store_true",
                   help="score the weight-independent recorded UI goldens "
                        "(blob view, edited backgrounds, ellipse masks); "
                        "needs no checkpoint")
    args = p.parse_args(argv)

    if args.score_ui:
        from blobctrl_torch.apps import ui_render
        ui_render.print_ui_score_table(
            ui_render.score_ui_all(args.demo_root, args.name))
        if not args.score:
            return

    if args.int8:
        # the int8-everything bundle (the int8 linears stay out, as in the
        # JAX package)
        from blobctrl_torch.nn import attention
        from blobctrl_torch.ops import conv3x3 as conv_mod
        attention.set_attention_backend("auto", qk_int8=True,
                                        int8_global_k=True)
        conv_mod.set_conv_int8(True)

    pipe_kwargs = {}
    if args.cfg_window:
        w0, w1 = (float(x) for x in args.cfg_window.split(","))
        pipe_kwargs.update(cfg_guidance_start=w0, cfg_guidance_end=w1)

    import torch

    from blobctrl_torch.params import io as io_lib
    pipeline = io_lib.load_pipeline(args.models_root, dtype=torch.bfloat16,
                                    device=args.device)
    names = args.name  # None -> all available
    if args.score:
        rows = score_all(pipeline, args.demo_root, names,
                         args.steps, args.num_samples, pipe_kwargs)
        print_score_table(rows)
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(rows, f, indent=1)
    else:
        for n in (names or EXAMPLE_ORDER):
            d = os.path.join(args.demo_root, n)
            if not os.path.isfile(os.path.join(d, "state", "state.json")):
                continue
            images, state, _ = replay(pipeline, d, args.steps,
                                      args.num_samples, pipe_kwargs)
            print(f"{n}: replayed {images.shape[0]} sample(s), "
                  f"seed {state['seed']}")


if __name__ == "__main__":
    main()
