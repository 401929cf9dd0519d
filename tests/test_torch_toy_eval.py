"""The toy's evaluation half in the port (``blobctrl_torch.train.toy``:
``edit_kwargs``, ``compose_kwargs``, ``remove_kwargs``, ``psnr``,
``color_error_inside``) against the JAX package's on seeded held-out
scenes at 128² and 256², and the quality gate of
``tests/test_toy_quality_gate.py`` run on the port: the trained 128²
checkpoint's held-out move edit, 20 steps on the CPU.

The kwargs' images and the remove mode's score are bit-equal to JAX's;
the splatted scores (``blob_math``'s Gaussian splat in fp32) agree within
1e-6, where the two packages round differently."""

import os

import numpy as np
import pytest
import torch

from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.train import toy as ttoy

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-6   # blob_math's fp32 splat, rounded differently by each


def _move_scene(size):
    rng = np.random.RandomState(10_000)  # held out: training used seed 0
    scene = jtoy.make_scene(rng, size)
    return scene, jtoy._random_ellipse(rng, size)


def _compose_scene(size):
    """The 2-object scene and target of test_toy_quality_gate_256.py."""
    rng = np.random.RandomState(20_000)
    for _ in range(50):
        cand = jtoy.make_scene(rng, size, n_objects=2)
        if len(cand["objects"]) != 2:
            continue
        t = jtoy._distractor_ellipse(
            rng, size, [o["ellipse"] for o in cand["objects"]])
        if t is not None:
            return cand, t
    raise AssertionError("no 2-object scene admits a target")


def _assert_kwargs_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == "gs_score":
            w = np.asarray(w)
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=SCORE_TOL)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.mark.parametrize("size", [128, 256])
def test_edit_and_remove_kwargs_match_jax(size):
    scene, target = _move_scene(size)
    _assert_kwargs_equal(
        ttoy.edit_kwargs(scene, target, size=size, steps=20),
        jtoy.edit_kwargs(scene, target, size=size, steps=20))
    got = ttoy.remove_kwargs(scene, size=size, steps=20)
    want = jtoy.remove_kwargs(scene, size=size, steps=20)
    np.testing.assert_array_equal(got["gs_score"], want["gs_score"])
    _assert_kwargs_equal(got, want)


@pytest.mark.parametrize("size", [128, 256])
def test_compose_kwargs_match_jax(size):
    scene, target = _compose_scene(size)
    got = ttoy.compose_kwargs(scene, target, size=size, steps=20)
    want = jtoy.compose_kwargs(scene, target, size=size, steps=20)
    assert got["gs_score"].shape == (1, size // 8, size // 8, 3)
    assert got["fg_dino_feats"].shape == (2, 16)
    _assert_kwargs_equal(got, want)
    with pytest.raises(ValueError, match="2-object"):
        ttoy.compose_kwargs(_move_scene(size)[0], target, size=size)


def test_psnr_and_color_error_match_jax():
    rng = np.random.RandomState(3)
    a = rng.rand(128, 128, 3).astype(np.float32)
    b = np.clip(a + rng.randn(128, 128, 3).astype(np.float32) * 0.01, 0, 1)
    assert ttoy.psnr(a, b) == jtoy.psnr(a, b)
    assert ttoy.psnr(a, a) == jtoy.psnr(a, a) == 120.0
    scene, target = _move_scene(128)
    img = scene["image"].astype(np.float32) / 255.0
    for ell in (target, scene["ellipse"]):
        for cls in range(len(ttoy.COLORS)):
            assert ttoy.color_error_inside(img, ell, cls, 128) == \
                jtoy.color_error_inside(img, ell, cls, 128)
    assert ttoy.color_error_inside(img, target, 1, 128, erode_frac=0.5) == \
        jtoy.color_error_inside(img, target, 1, 128, erode_frac=0.5)


def test_trained_move_edit_passes_the_gate_on_the_port():
    """tests/test_toy_quality_gate.py's bars on the port's 20-step edit of
    the trained 128² checkpoint: the object's colour at the target (<
    0.05), the other classes more than twice as far, the source region
    inpainted (> 0.1)."""
    pipe, meta = ttoy.load_toy(os.path.join(ROOT, "assets", "toy_ckpt"),
                               device="cpu")
    size = meta["size"]
    scene, target = _move_scene(size)
    scene = {k: scene[k] for k in ("image", "mask", "cls", "ellipse")}
    out = pipe(**ttoy.edit_kwargs(scene, target, size=size,
                                  steps=20)).images[0]
    err = ttoy.color_error_inside(out, target, scene["cls"], size)
    assert err < 0.05, err
    wrong = min(ttoy.color_error_inside(out, target, c, size)
                for c in range(len(ttoy.COLORS)) if c != scene["cls"])
    assert wrong > 2 * err, (err, wrong)
    src = ttoy.color_error_inside(out, scene["ellipse"], scene["cls"], size)
    assert src > 0.1, src
