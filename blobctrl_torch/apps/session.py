"""Headless interactive editing session: the demo's state machine
decoupled from any UI (counterpart of ``blobctrl_tpu/apps/session.py``).

Flow:
  1. set_image(img)             — aspect check, resize + center-crop to 512^2
  2. click(x, y) / set_mask     — point-click segmentation through an
                                  attached predictor, or the object's mask
  3. generate_blob()            — mask -> ellipse (1.05x inflate), object crop
                                  on white canvas, blob viz
  4. move/resize/rotate/...     — multi-round edits (BlobEditor), or the
                                  click-to-move tracking points
                                  (add_tracking_point, undo/reset,
                                  tracking_overlay)
  5. run(prompt, ...)           — build edited background (start region white,
                                  target region black), splat score, pipeline
Remove mode: run(remove=True) — bg = original with start region white,
  score forced to [bg=1, fg=0], control strength 0.

The blob view splats on the session's device (the pipeline's, or
``device``; the hand-written splat kernel on the card). The tracking
overlay renders on the host in float64 through ``apps/ui_render``, bit for
bit what the JAX session draws. ``pipeline`` may be None for the UI-only
flows. The predictor is ``models.sam.SamPredictor`` (SAM ViT-H, whose
image embedding stays on the device between clicks), or any object with
``set_image(img)`` and ``predict(points, labels, multimask_output=False)``
returning (masks, scores, logits), as SAM's. ``save_state`` / ``load_state`` write and read
the reference demo's replayable state directories (``state/state.json``
and images, PNG written, PNG or JPEG read through ``utils/image.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from blobctrl_torch.blob import editor as editor_lib
from blobctrl_torch.blob import math as blob_math
from blobctrl_torch.blob import viz as viz_lib
from blobctrl_torch.utils import image, png, resample


def initialize_image(img: np.ndarray, size: int = 512) -> np.ndarray:
    """Resize the shortest side to ``size`` (cv2's INTER_LINEAR, the port's
    bit-exact copy) and center crop; the aspect ratio must be <= 2."""
    h, w = img.shape[:2]
    if max(h, w) / min(h, w) > 2.0:
        raise ValueError("image aspect ratio cannot be larger than 2.0")
    scale = size / min(h, w)
    # round (not truncate): int() can yield a 511-px short side for some
    # inputs, making the center crop degenerate
    nw, nh = max(round(w * scale), size), max(round(h * scale), size)
    if w <= h:
        nw = size
    else:
        nh = size
    img = resample.cv2_resize_linear(img, (nw, nh))
    h, w = img.shape[:2]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return img[y0:y0 + size, x0:x0 + size].copy()


@dataclasses.dataclass
class SessionResult:
    images: np.ndarray                    # (N, H, W, 3) float [0,1]
    images_with_ellipse: List[np.ndarray]
    final_ellipse: tuple


class BlobCtrlSession:
    def __init__(self, pipeline, sam_predictor=None, size: int = 512,
                 device=None):
        self.pipeline = pipeline
        self.sam = sam_predictor
        if device is None:
            device = getattr(pipeline, "device", None) or "cuda"
        self.device = device
        self.size = size
        self.original_image: Optional[np.ndarray] = None
        self.mask: Optional[np.ndarray] = None
        self.fg_image: Optional[np.ndarray] = None
        self.editor = editor_lib.BlobEditor(height=size, width=size)
        self.selected_points: List[Tuple[float, float, int]] = []
        # click-to-move tracking points, [[x, y], ...]
        self.tracking_points: List[List[int]] = []
        self._remove_inflated = False
        self._pre_remove_start = None

    # ------------------------------------------------------------------
    # steps 1-2: image + segmentation
    # ------------------------------------------------------------------

    def set_image(self, img: np.ndarray) -> np.ndarray:
        self.original_image = initialize_image(np.asarray(img), self.size)
        self.mask = None
        self.fg_image = None
        self.selected_points = []
        self.editor = editor_lib.BlobEditor(height=self.size, width=self.size)
        if self.sam is not None:
            self.sam.set_image(self.original_image)
        return self.original_image

    def click(self, x: float, y: float, label: int = 1) -> np.ndarray:
        """Add a point and re-run the predictor over all points so far."""
        assert self.sam is not None, "no SAM predictor attached"
        self.selected_points.append((x, y, label))
        pts = np.asarray([(p[0], p[1]) for p in self.selected_points],
                         np.float32)
        lbs = np.asarray([p[2] for p in self.selected_points], np.int32)
        masks, _, _ = self.sam.predict(pts, lbs, multimask_output=False)
        self.mask = (masks[0] * 255).astype(np.uint8)
        return self.mask

    def set_mask(self, mask: np.ndarray):
        """The object's segmentation mask."""
        self.mask = (np.asarray(mask) > 0).astype(np.uint8) * 255

    # ------------------------------------------------------------------
    # step: blob initialization
    # ------------------------------------------------------------------

    def generate_blob(self, inflate: float = 1.05) -> tuple:
        assert self.mask is not None, "segment first"
        ellipse = self.editor.init_from_mask(self.mask, inflate=inflate)
        self.fg_image = editor_lib.object_region_on_canvas(
            self.original_image, self.mask, canvas=self.size)
        return ellipse

    def compositional_add(self, object_image: np.ndarray, target_ellipse):
        """Paste a user-supplied object at ``target_ellipse``."""
        self.editor.init_compositional(target_ellipse)
        obj = np.asarray(object_image)
        mask = (obj.sum(-1) < 255 * 3 - 10).astype(np.uint8) * 255 \
            if obj.ndim == 3 else np.full(obj.shape[:2], 255, np.uint8)
        self.fg_image = editor_lib.object_region_on_canvas(obj, mask, canvas=self.size)
        self.mask = viz_lib.ellipse_mask(self.editor.initial, self.size, self.size)

    # edit ops -----------------------------------------------------------

    def move(self, dx: float, dy: float):
        return self.editor.move((dx, dy))

    def resize(self, factor: float, resize_type: int = 0):
        return self.editor.resize(factor, resize_type)

    def rotate(self, degrees: float):
        return self.editor.rotate(degrees)

    def resize_start_blob(self, factor: float, resize_type: int = 0):
        """Resize the start ellipse: widens/shrinks the removal/white-out
        region of the edited background."""
        if self._remove_inflated:
            # the pre-remove snapshot no longer reflects the user's intent:
            # restoring it on uncheck would silently discard this resize.
            # Drop it so set_remove_mode(False) inverts only the inflation.
            self._pre_remove_start = None
        return self.editor.resize_start(factor, resize_type)

    def undo(self):
        return self.editor.undo()

    def reset(self):
        return self.editor.reset()

    def blob_visualization(self) -> np.ndarray:
        return viz_lib.blob_vis_from_ellipse(self.editor.current, self.size,
                                             self.size, device=self.device)

    # ------------------------------------------------------------------
    # click-to-move tracking points
    # ------------------------------------------------------------------

    def add_tracking_point(self, x: float, y: float):
        """The first valid click selects the blob (it must land inside the
        start ellipse; the point kept is the start ellipse's center, not
        the click); each later click moves the blob by the delta between
        the last two points. Returns (overlay_image, warning_or_None)."""
        if not self.editor.entries:
            return None, "Please generate the blob first"
        if not self.tracking_points:
            if not editor_lib.is_point_in_ellipse((x, y), self.editor.initial):
                return (viz_lib.blob_vis_from_ellipse(
                    self.editor.initial, self.size, self.size,
                    device=self.device),
                    "Please click a point inside the blob first")
            xc, yc = self.editor.initial[0]
            self.tracking_points.append([int(xc), int(yc)])
        else:
            self.tracking_points.append([int(x), int(y)])
            last, prev = self.tracking_points[-1], self.tracking_points[-2]
            self.editor.move((last[0] - prev[0], last[1] - prev[1]))
        return self.tracking_overlay(), None

    def undo_tracking_point(self):
        """Pop the last point and its move."""
        if len(self.tracking_points) > 1:
            self.tracking_points.pop()
            self.editor.undo()
        elif self.tracking_points:
            self.tracking_points.pop()
        else:
            return self.reset_tracking_points()
        return self.tracking_overlay()

    def reset_tracking_points(self):
        """Clear the points and truncate the edits to the start."""
        self.tracking_points = []
        self.editor.reset()
        return self.tracking_overlay()

    def tracking_overlay(self) -> np.ndarray:
        """The 'Editable Blob' view: blob splat + start marker + move
        polyline/arrow + current-ellipse outline, from the pixel-exact
        renderer (host float64)."""
        from blobctrl_torch.apps import ui_render
        return ui_render.render_editable_blob(
            self.tracking_points, self.editor.entries, self.size, self.size)

    # ------------------------------------------------------------------
    # preview galleries (the demo's 'Original Preview' / 'Edited Preview')
    # ------------------------------------------------------------------

    def ori_preview_gallery(self) -> List[np.ndarray]:
        """[image+ellipse overlay, mask-blacked image, mask, start-ellipse
        mask, start-ellipse-blacked image]."""
        assert self.original_image is not None and self.editor.entries
        e0 = self.editor.initial
        emask = viz_lib.ellipse_mask(e0, self.size, self.size)
        out = [viz_lib.draw_ellipse(self.original_image.copy(), e0),
               viz_lib.composite_mask_and_image(
                   self.mask if self.mask is not None else emask,
                   self.original_image),
               np.asarray(self.mask if self.mask is not None else emask),
               emask,
               viz_lib.composite_mask_and_image(emask, self.original_image)]
        return out

    def edited_preview_gallery(self) -> List[np.ndarray]:
        """[edited background (start white, target black), target mask]."""
        assert self.original_image is not None and self.editor.entries
        return [self.build_edited_background(),
                viz_lib.ellipse_mask(self.editor.current, self.size, self.size)]

    # ------------------------------------------------------------------
    # compositional add + remove-mode toggle
    # ------------------------------------------------------------------

    def set_init_ellipse(self, params) -> tuple:
        """Manual target ellipse for compositional add. ``params`` is
        (nxc, nyc, nd1, nd2, angle): center/axes normalized by width/height/
        image diagonal."""
        assert self.original_image is not None, "set an image first"
        nxc, nyc, nd1, nd2, ang = [float(v) for v in params]
        diag = float(np.hypot(self.size, self.size))
        target = ((nxc * self.size, nyc * self.size),
                  (nd1 * diag, nd2 * diag), ang)
        self.editor.init_compositional(target)
        self.mask = viz_lib.ellipse_mask(target, self.size, self.size)
        self.tracking_points = [
            [int(self.editor.initial[0][0]), int(self.editor.initial[0][1])],
            [int(target[0][0]), int(target[0][1])]]
        return target

    def set_object_image(self, object_image: np.ndarray):
        """Upload a foreground object for compositional add: center-crop to
        the canvas, extract the non-white region onto a white canvas."""
        assert self.editor.entries, "set the target ellipse first"
        obj = initialize_image(np.asarray(object_image), self.size)
        mask = (obj.astype(np.int32).sum(-1) < 255 * 3 - 10).astype(np.uint8) * 255
        self.fg_image = editor_lib.object_region_on_canvas(obj, mask, canvas=self.size)
        self._remove_inflated = False
        return self.fg_image

    def set_remove_mode(self, remove: bool):
        """Remove mode inflates the start blob 1.2x so the white-out region
        surrounds the object. Toggling is idempotent: unchecking restores the
        EXACT pre-inflation start ellipse from a snapshot — an inverse resize
        cannot restore it when the bounds/min-area constraints clamped the
        inflation (or would clamp the shrink)."""
        if remove and not self._remove_inflated:
            self._pre_remove_start = self.editor.entries[0]
            _, applied, _ = self.editor.resize_start(1.2, 0)
            self._remove_applied_factor = applied
            self._remove_inflated = True
        elif not remove and self._remove_inflated:
            if self._pre_remove_start is not None:
                self.editor.entries[0] = self._pre_remove_start
            else:
                # no snapshot (the user resized the start blob while remove
                # was on): invert only the applied inflation, keeping any
                # newer start-blob edits
                inv = 1.0 / getattr(self, "_remove_applied_factor", 1.2)
                self.editor.resize_start(inv, 0)
            self._remove_inflated = False
        return self.editor.initial

    # ------------------------------------------------------------------
    # backgrounds + generation
    # ------------------------------------------------------------------

    def build_edited_background(self) -> np.ndarray:
        """Start-ellipse region -> white, current-ellipse region -> black."""
        start_mask = viz_lib.ellipse_mask(self.editor.initial, self.size, self.size)
        cur_mask = viz_lib.ellipse_mask(self.editor.current, self.size, self.size)
        bg = viz_lib.composite_mask_and_image(start_mask, self.original_image,
                                              (255, 255, 255))
        return viz_lib.composite_mask_and_image(cur_mask, bg, (0, 0, 0))

    def build_removal_background(self) -> np.ndarray:
        start_mask = viz_lib.ellipse_mask(self.editor.initial, self.size, self.size)
        return viz_lib.composite_mask_and_image(start_mask, self.original_image,
                                                (255, 255, 255))

    # ------------------------------------------------------------------
    # multi-blob composition (M blobs in one pass)
    # ------------------------------------------------------------------

    def run_multi(self, prompt: str, blobs, num_samples: int = 1,
                  seed: int = 1248464818, guidance_scale: float = 7.5,
                  num_inference_steps: int = 50,
                  blobnet_control_strength: float = 1.2,
                  blobnet_control_guidance_start: float = 0.0,
                  blobnet_control_guidance_end: float = 1.0,
                  bg_image: Optional[np.ndarray] = None,
                  scheduler: str = "unipc") -> SessionResult:
        """Edit M blobs jointly. ``blobs`` is a list of
        (ellipse, object_image) pairs, back-to-front (later = on top).
        The background must mask all edit regions (pass bg_image, or the
        current image with each target region blacked out is built here)."""
        size = self.size
        lh, lw = size // 8, size // 8
        m = len(blobs)
        assert m >= 1

        xs = np.zeros((1, m), np.float32)
        ys = np.zeros((1, m), np.float32)
        covs = np.zeros((1, m, 2, 2), np.float32)
        for j, (ellipse, _) in enumerate(blobs):
            mean, cov = blob_math.gaussian_from_ellipse(ellipse)
            nmean, ncov = blob_math.normalize_gaussian(mean, cov, size, size)
            xs[0, j], ys[0, j] = nmean
            covs[0, j] = ncov
        gs = blob_math.splat_scores(
            torch.as_tensor(xs), torch.as_tensor(ys), torch.as_tensor(covs),
            torch.ones(1, m), (lh, lw)).numpy()

        if bg_image is None:
            assert self.original_image is not None, "set_image first"
            bg = self.original_image
            for ellipse, _ in blobs:
                emask = viz_lib.ellipse_mask(ellipse, size, size)
                bg = viz_lib.composite_mask_and_image(emask, bg, (0, 0, 0))
        else:
            bg = bg_image

        # VAE left-half conditioning sees ALL objects: composite every object
        # canvas onto one (non-white pixels overwrite, back-to-front);
        # DINOv2 still embeds each object separately.
        fg_images = [np.asarray(obj) for _, obj in blobs]
        canvas = fg_images[0].copy()
        for obj in fg_images[1:]:
            non_white = (obj.astype(np.int32).sum(-1) < 255 * 3 - 10)
            canvas = np.where(non_white[..., None], obj, canvas)
        out = self.pipeline(
            prompt=[prompt] * num_samples,
            fg_image=fg_images, fg_vae_image=canvas,
            bg_image=bg, gs_score=gs,
            height=size, width=size,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed,
            blobnet_conditioning_scale=float(blobnet_control_strength),
            blobnet_control_guidance_start=float(blobnet_control_guidance_start),
            blobnet_control_guidance_end=float(blobnet_control_guidance_end),
            scheduler=scheduler)
        plots = []
        for img in out.images:
            arr = (img * 255).astype(np.uint8)
            for ellipse, _ in blobs:
                arr = viz_lib.draw_ellipse(arr, ellipse)
            plots.append(arr)
        return SessionResult(images=out.images, images_with_ellipse=plots,
                             final_ellipse=blobs[-1][0])

    # ------------------------------------------------------------------
    # replayable state (the reference demo's state.json schema)
    # ------------------------------------------------------------------

    def save_state(self, out_dir: str, prompt: str = "", **params):
        """Write ``out_dir/state/state.json`` and the images beside it
        (input_image, object_image_gallery, edited_result_gallery), in the
        layout and schema the JAX package's session writes."""
        os.makedirs(os.path.join(out_dir, "state"), exist_ok=True)
        state = {
            "scene_prompt": prompt,
            "ellipse_lists": [[[list(e[0]), list(e[1]), e[2]], list(p), t]
                              for e, p, t in self.editor.entries],
            "remove_blob_box": bool(params.get("remove", False)),
            "num_samples": int(params.get("num_samples", 1)),
            "seed": int(params.get("seed", 1248464818)),
            "guidance_scale": float(params.get("guidance_scale", 7.5)),
            "num_inference_steps": int(params.get("num_inference_steps",
                                                  50)),
            "blobnet_control_strength": float(
                params.get("blobnet_control_strength", 1.2)),
            "blobnet_control_guidance_start": float(
                params.get("blobnet_control_guidance_start", 0.0)),
            "blobnet_control_guidance_end": float(
                params.get("blobnet_control_guidance_end", 1.0)),
            "tracking_points": params.get(
                "tracking_points", [list(p) for p in self.tracking_points]),
        }
        with open(os.path.join(out_dir, "state", "state.json"), "w") as f:
            json.dump(state, f)

        def write(sub, name, arr):
            d = os.path.join(out_dir, sub)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, name), "wb") as f:
                f.write(png.encode_png(np.asarray(arr, np.uint8)))

        if self.original_image is not None:
            write("input_image", "input_image.png", self.original_image)
        if self.fg_image is not None:
            write("object_image_gallery",
                  "validation_object_region_center.png", self.fg_image)
        if self.editor.entries and not params.get("remove", False):
            write("edited_result_gallery", "edited_result_gallery_0.png",
                  self.build_edited_background())
        return out_dir

    def load_state(self, demo_dir: str):
        """Restore the editor entries, tracking points and images from a
        state directory (``save_state``'s, or the JAX package's)."""
        with open(os.path.join(demo_dir, "state", "state.json")) as f:
            state = json.load(f)

        def read(sub, name):
            path = os.path.join(demo_dir, sub, name)
            if not os.path.exists(path):
                return None
            return image.read_image(path)

        img = read("input_image", "input_image.png")
        if img is not None:
            self.original_image = img
        obj = read("object_image_gallery",
                   "validation_object_region_center.png")
        if obj is not None:
            self.fg_image = obj
        self.editor.entries = [
            (((e[0][0][0], e[0][0][1]), (e[0][1][0], e[0][1][1]), e[0][2]),
             tuple(e[1]), e[2])
            for e in state["ellipse_lists"]]
        self.tracking_points = [list(p)
                                for p in state.get("tracking_points", [])]
        # the saved ellipses already hold any remove-mode inflation: mark
        # it applied, so a later set_remove_mode(True) does not inflate the
        # restored geometry again ("remove_blob_box", the reference's key)
        self._remove_inflated = bool(state.get("remove_blob_box",
                                               state.get("remove", False)))
        self._pre_remove_start = None
        return state

    def run(self, prompt: str, num_samples: int = 1, seed: int = 1248464818,
            guidance_scale: float = 7.5, num_inference_steps: int = 50,
            blobnet_control_strength: float = 1.2,
            blobnet_control_guidance_start: float = 0.0,
            blobnet_control_guidance_end: float = 1.0,
            remove: bool = False, scheduler: str = "unipc",
            bg_image: Optional[np.ndarray] = None,
            fg_image: Optional[np.ndarray] = None,
            encoder_cache_interval: int = 0) -> SessionResult:
        assert self.editor.entries, "generate a blob first"
        size = self.size
        lh, lw = size // 8, size // 8
        fg = fg_image if fg_image is not None else self.fg_image
        assert fg is not None, "no foreground object image"

        if not remove:
            bg = bg_image if bg_image is not None else self.build_edited_background()
            final_ellipse = self.editor.current
            gs = blob_math.blob_score_from_ellipse(final_ellipse, size, size, (lh, lw))
            strength = blobnet_control_strength
        else:
            bg = bg_image if bg_image is not None else self.build_removal_background()
            final_ellipse = self.editor.initial
            gs = blob_math.removal_score((lh, lw))
            strength = 0.0

        out = self.pipeline(
            prompt=[prompt] * num_samples,
            fg_image=fg, bg_image=bg, gs_score=gs.numpy(),
            height=size, width=size,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed,
            blobnet_conditioning_scale=float(strength),
            blobnet_control_guidance_start=float(blobnet_control_guidance_start),
            blobnet_control_guidance_end=float(blobnet_control_guidance_end),
            scheduler=scheduler,
            encoder_cache_interval=encoder_cache_interval)

        plots = [viz_lib.draw_ellipse((img * 255).astype(np.uint8), final_ellipse)
                 for img in out.images]
        return SessionResult(images=out.images, images_with_ellipse=plots,
                             final_ellipse=final_ellipse)
