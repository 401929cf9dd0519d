"""Interactive Gradio demo of the port: a thin UI over
``apps/session.BlobCtrlSession`` (counterpart of
``blobctrl_tpu/apps/gradio_app.py``, with its event graph and the same
outputs for each handler). All edit logic lives in the session and
``blob/editor.py``; this file only wires widgets:

  * click-to-segment through an attached predictor, with undo;
  * Generate Blob -> the editable-blob view with click-to-move tracking
    points, the in-ellipse guard, polyline and arrow overlays;
  * per-axis resize (aspect / long / short), START-blob resize, rotation;
    sliders snap back to neutral after applying, so repeated releases do
    not compound;
  * Object Image / Original Preview / Edited Preview / Results galleries;
  * compositional add: a manual init ellipse (parsed, never eval'd) and an
    object upload;
  * remove mode with start-blob inflation;
  * the example replay gallery driven by saved demo states.

Launch: python -m blobctrl_torch.apps.gradio_app --models_root models
Requires ``gradio``, imported only inside ``build_demo``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from blobctrl_torch.apps.replay import EXAMPLE_ORDER
from blobctrl_torch.blob import raster

RESIZE_AR, RESIZE_LONG, RESIZE_SHORT = 0, 1, 2


def parse_init_ellipse(text: str):
    """'[0.5, 0.5, 0.2, 0.2, 180]' -> 5 floats (a parser, never eval)."""
    vals = [float(v) for v in text.strip().strip("[]()").split(",")]
    if len(vals) != 5:
        raise ValueError("expected [xc, yc, d1, d2, angle] (normalized)")
    return vals


def list_examples(examples_root: str):
    out = []
    for name in EXAMPLE_ORDER:
        d = os.path.join(examples_root, name)
        if os.path.isdir(os.path.join(d, "state")):
            out.append((name, d))
    return out


def build_demo(session, examples_root: str = "assets/results/demo"):
    import gradio as gr

    examples = list_examples(examples_root)

    with gr.Blocks(title="BlobCtrl") as demo:
        gr.Markdown("## BlobCtrl — element-level image editing "
                    "(upload → click object → Generate Blob → click to move "
                    "/ sliders to resize-rotate → Run)")

        with gr.Row():
            with gr.Column():
                input_image = gr.Image(type="numpy", label="Input (click the object to segment)",
                                       interactive=True)
                with gr.Row():
                    undo_seg_btn = gr.Button("🔙 Undo Seg")
                    gen_blob_btn = gr.Button("🎩 Generate Blob", variant="secondary")
                scene_prompt = gr.Textbox(
                    label="Scene Prompt",
                    value="Fill image using foreground and background.")
                strength = gr.Slider(0.0, 2.5, 1.6, step=0.01,
                                     label="🎚️ Control Strength")
                with gr.Row():
                    cg_start = gr.Slider(0, 1, 0.0, step=0.01,
                                         label="Blobnet Control Start")
                    cg_end = gr.Slider(0, 1, 0.9, step=0.01,
                                       label="Blobnet Control End")
                with gr.Accordion("Diffusion Options", open=False):
                    seed = gr.Slider(0, 2**31 - 1, 1248464818, step=1,
                                     label="Seed")
                    num_samples = gr.Slider(1, 4, 1, step=1, label="Samples")
                    with gr.Row():
                        guidance = gr.Slider(1, 12, 7.5, step=0.1, label="CFG scale")
                        steps = gr.Slider(1, 100, 50, step=1, label="NFE")
                    fast_mode = gr.Checkbox(
                        label="Fast mode (encoder caching, ~1.5x faster, "
                              "approximate)", value=False)
                with gr.Accordion("Compositional Add", open=False):
                    init_ellipse_box = gr.Textbox(
                        label="Init ellipse [xc, yc, d1, d2, angle] (normalized)",
                        value="[0.5, 0.5, 0.2, 0.2, 180]")
                    set_ellipse_btn = gr.Button("Set Init Ellipse")
                    object_upload = gr.Image(type="numpy",
                                             label="Object image (white background)")
                remove_box = gr.Checkbox(label="Remove mode")
                run_btn = gr.Button("💫 Run Generation", variant="primary")

            with gr.Column():
                with gr.Accordion("More Previews", open=False):
                    with gr.Row():
                        object_gallery = gr.Gallery(label="Object Image",
                                                    height=220, preview=True)
                        ori_gallery = gr.Gallery(label="Original Preview",
                                                 height=220, preview=True)
                with gr.Row():
                    editable_blob = gr.Image(
                        label="Editable Blob (click to select, click again to move)",
                        interactive=False)
                    edited_gallery = gr.Gallery(label="Edited Preview",
                                                height=320, preview=True)
                with gr.Row():
                    undo_pts_btn = gr.Button("🔙 Undo Point")
                    reset_pts_btn = gr.Button("🆕 Reset Points")
                with gr.Row():
                    resize_ar_s = gr.Slider(0.3, 3.0, 1.0, step=0.05,
                                            label="Resize (aspect kept)")
                    resize_long_s = gr.Slider(0.3, 3.0, 1.0, step=0.05,
                                              label="Resize long axis")
                    resize_short_s = gr.Slider(0.3, 3.0, 1.0, step=0.05,
                                               label="Resize short axis")
                with gr.Row():
                    resize_start_s = gr.Slider(0.3, 3.0, 1.0, step=0.05,
                                               label="Resize START blob (background)")
                    rotate_s = gr.Slider(-180, 180, 0, step=1,
                                         label="Rotate (degrees)")
                results = gr.Gallery(label="Results", height=380, preview=True)

        # ------------------------------------------------------------------
        # segmentation flow
        # ------------------------------------------------------------------

        def on_upload(img):
            if img is None:
                return None, None, None, None
            session.set_image(np.asarray(img))
            session.tracking_points = []
            return session.original_image, None, None, None

        def seg_view():
            """Input image with the mask + click markers overlaid."""
            img = session.original_image.copy()
            if session.mask is not None:
                m = session.mask > 0
                img[m] = (0.5 * img[m] + 0.5 * np.asarray([255, 60, 60])).astype(np.uint8)
            for (x, y, lb) in session.selected_points:
                raster.draw_marker(img, (int(x), int(y)),
                                   (0, 255, 0) if lb else (255, 0, 0),
                                   raster.MARKER_CROSS, 20, 5)
            return img

        def on_click(evt: gr.SelectData):
            session.click(evt.index[0], evt.index[1])
            return seg_view()

        def on_undo_seg():
            if session.selected_points:
                session.selected_points.pop()
                if session.selected_points:
                    pts = session.selected_points[:]
                    session.selected_points = []
                    for (x, y, lb) in pts:
                        session.click(x, y, lb)
                else:
                    session.mask = None
            return seg_view() if session.original_image is not None else None

        # ------------------------------------------------------------------
        # blob generation + tracking-point editing
        # ------------------------------------------------------------------

        def on_gen_blob():
            session.generate_blob()
            session.tracking_points = []
            return (session.tracking_overlay(), [session.fg_image],
                    session.ori_preview_gallery(),
                    session.edited_preview_gallery())

        def on_blob_click(evt: gr.SelectData):
            overlay, warning = session.add_tracking_point(evt.index[0],
                                                          evt.index[1])
            if warning:
                gr.Warning(warning)
            gallery = (session.edited_preview_gallery()
                       if session.editor.entries else None)
            return overlay, gallery

        def on_undo_point():
            if not session.editor.entries:
                return None, None
            overlay = session.undo_tracking_point()
            return overlay, session.edited_preview_gallery()

        def on_reset_points():
            if not session.editor.entries:
                return None, None
            overlay = session.reset_tracking_points()
            return overlay, session.edited_preview_gallery()

        # ------------------------------------------------------------------
        # slider edits — apply on release, then snap back to neutral so
        # repeated releases don't compound
        # ------------------------------------------------------------------

        def _after_edit():
            return (session.tracking_overlay(),
                    session.edited_preview_gallery())

        def on_resize(f, rtype):
            if not session.editor.entries:
                gr.Warning("Please generate the blob first")
                return None, None, gr.update(value=1.0)
            _, warn = session.resize(float(f), int(rtype))
            for w in warn:
                gr.Warning(w)
            return (*_after_edit(), gr.update(value=1.0))

        def on_resize_start(f):
            if not session.editor.entries:
                gr.Warning("Please generate the blob first")
                return None, None, None, gr.update(value=1.0)
            _, _, warn = session.resize_start_blob(float(f))
            for w in warn:
                gr.Warning(w)
            return (*_after_edit(), session.ori_preview_gallery(),
                    gr.update(value=1.0))

        def on_rotate(d):
            if not session.editor.entries:
                gr.Warning("Please generate the blob first")
                return None, None, gr.update(value=0.0)
            session.rotate(float(d))
            return (*_after_edit(), gr.update(value=0.0))

        # ------------------------------------------------------------------
        # compositional add + remove mode
        # ------------------------------------------------------------------

        def on_set_ellipse(text):
            try:
                params = parse_init_ellipse(text)
            except ValueError as e:
                gr.Warning(str(e))
                return None, None, None
            session.set_init_ellipse(params)
            return (session.tracking_overlay(),
                    session.edited_preview_gallery(),
                    session.ori_preview_gallery())

        def on_object_upload(obj):
            if obj is None:
                return None
            try:
                fg = session.set_object_image(obj)
            except AssertionError as e:
                gr.Warning(str(e))
                return None
            return [fg]

        def on_remove_toggle(flag):
            if not session.editor.entries:
                return None, None
            session.set_remove_mode(bool(flag))
            return session.tracking_overlay(), session.ori_preview_gallery()

        # ------------------------------------------------------------------
        # generation
        # ------------------------------------------------------------------

        def on_run(p, st, cgs, cge, sd, n, g, n_steps, remove, fast):
            res = session.run(
                p, num_samples=int(n), seed=int(sd),
                guidance_scale=float(g), num_inference_steps=int(n_steps),
                blobnet_control_strength=float(st),
                blobnet_control_guidance_start=float(cgs),
                blobnet_control_guidance_end=float(cge),
                remove=bool(remove),
                encoder_cache_interval=3 if fast else 0)
            imgs = [(im * 255).astype(np.uint8) for im in res.images]
            return imgs + res.images_with_ellipse

        # ------------------------------------------------------------------
        # example replay
        # ------------------------------------------------------------------

        def load_example(name_dir):
            name, d = name_dir
            state = session.load_state(d)

            def g(sub):
                p = os.path.join(d, sub)
                if not os.path.isdir(p):
                    return None
                return [os.path.join(p, f) for f in sorted(os.listdir(p))]

            return (session.original_image,
                    g("object_image_gallery"),
                    g("ori_result_gallery"),
                    session.tracking_overlay(),
                    g("edited_result_gallery") or
                    session.edited_preview_gallery(),
                    g("results_gallery"),
                    state.get("scene_prompt", ""),
                    state.get("blobnet_control_strength", 1.0),
                    state.get("blobnet_control_guidance_start", 0.0),
                    state.get("blobnet_control_guidance_end", 1.0),
                    state.get("seed", 1248464818),
                    state.get("remove_blob_box", False))

        if examples:
            with gr.Row():
                ex_dropdown = gr.Dropdown([n for n, _ in examples],
                                          label="Quick Examples")
                ex_btn = gr.Button("Load Example")

            def on_example(name):
                d = dict(examples)[name]
                return load_example((name, d))

            ex_btn.click(on_example, [ex_dropdown],
                         [input_image, object_gallery, ori_gallery,
                          editable_blob, edited_gallery, results,
                          scene_prompt, strength, cg_start, cg_end, seed,
                          remove_box])

        # wiring
        input_image.upload(on_upload, [input_image],
                           [input_image, editable_blob, edited_gallery, results])
        input_image.select(on_click, [], [input_image])
        undo_seg_btn.click(on_undo_seg, [], [input_image])
        gen_blob_btn.click(on_gen_blob, [],
                           [editable_blob, object_gallery, ori_gallery,
                            edited_gallery])
        editable_blob.select(on_blob_click, [], [editable_blob, edited_gallery])
        undo_pts_btn.click(on_undo_point, [], [editable_blob, edited_gallery])
        reset_pts_btn.click(on_reset_points, [], [editable_blob, edited_gallery])
        resize_ar_s.release(lambda f: on_resize(f, RESIZE_AR), [resize_ar_s],
                            [editable_blob, edited_gallery, resize_ar_s])
        resize_long_s.release(lambda f: on_resize(f, RESIZE_LONG),
                              [resize_long_s],
                              [editable_blob, edited_gallery, resize_long_s])
        resize_short_s.release(lambda f: on_resize(f, RESIZE_SHORT),
                               [resize_short_s],
                               [editable_blob, edited_gallery, resize_short_s])
        resize_start_s.release(on_resize_start, [resize_start_s],
                               [editable_blob, edited_gallery, ori_gallery,
                                resize_start_s])
        rotate_s.release(on_rotate, [rotate_s],
                         [editable_blob, edited_gallery, rotate_s])
        set_ellipse_btn.click(on_set_ellipse, [init_ellipse_box],
                              [editable_blob, edited_gallery, ori_gallery])
        object_upload.upload(on_object_upload, [object_upload], [object_gallery])
        remove_box.change(on_remove_toggle, [remove_box],
                          [editable_blob, ori_gallery])
        run_btn.click(on_run,
                      [scene_prompt, strength, cg_start, cg_end, seed,
                       num_samples, guidance, steps, remove_box, fast_mode],
                      [results])
    return demo


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--models_root", default="models")
    p.add_argument("--examples_root", default="assets/results/demo")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from blobctrl_torch.apps.session import BlobCtrlSession
    from blobctrl_torch.params import io as params_io

    pipe = params_io.load_pipeline(args.models_root, dtype=torch.bfloat16,
                                   device=args.device)
    sam_pred = None
    sam_path = f"{args.models_root}/sam/sam_vit_h_4b8939.pth"
    if os.path.exists(sam_path):
        # a present checkpoint that cannot be loaded fails loudly instead of
        # degrading the demo to no-SAM silently
        from blobctrl_torch.models import sam as sam_lib
        sam_pred = sam_lib.SamPredictor(
            params_io.load_sam(sam_path, device=args.device),
            device=args.device)
    else:
        print(f"SAM checkpoint not found at {sam_path}; "
              "mask-from-click disabled")

    session = BlobCtrlSession(pipe, sam_predictor=sam_pred)
    build_demo(session, args.examples_root).launch(server_port=args.port)


if __name__ == "__main__":
    main()
