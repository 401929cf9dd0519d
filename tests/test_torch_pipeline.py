"""End-to-end parity of the port's edit against the JAX pipeline on the
trained toy checkpoints, fp32 on the CPU: each side loads the checkpoint
with its own loader and runs the same move and remove edits (kwargs from
``train/toy``, explicit seeded latents, 6 UniPC steps)."""

import numpy as np
import pytest
import torch

from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.train import toy as ttoy

torch.set_num_threads(2)

STEPS = 6


def _edits(size):
    rng = np.random.RandomState(11)
    scene = jtoy.make_scene(rng, size=size)
    (xc, yc), axes, ang = scene["ellipse"]
    target = ((size - xc, yc), axes, ang)  # mirror the object left-right
    lat = np.random.RandomState(5).randn(1, size // 8, size // 8, 4)
    move = jtoy.edit_kwargs(scene, target, size=size, steps=STEPS)
    remove = jtoy.remove_kwargs(scene, size=size, steps=STEPS)
    for kw in (move, remove):
        kw["latents"] = lat.astype(np.float32)
    return {"move": move, "remove": remove}


def _assert_u8_close(a, b, name):
    """uint8 images (from the float [0, 1] outputs): <= 1 level at >= 99.9 %
    of pixels and <= 2 levels everywhere. The two sides sum in other orders
    in fp32; a rounding tie can flip one level."""
    qa = np.round(np.asarray(a) * 255).astype(np.int32)
    qb = np.round(np.asarray(b) * 255).astype(np.int32)
    diff = np.abs(qa - qb)
    assert diff.max() <= 2, (name, int(diff.max()))
    assert (diff <= 1).mean() >= 0.999, (name, float((diff <= 1).mean()))


def check_edits(ckpt, size, names):
    jpipe, _ = jtoy.load_toy(ckpt)
    tpipe, _ = ttoy.load_toy(ckpt, device="cpu")
    edits = _edits(size)
    for name in names:
        want = jpipe(**edits[name]).images
        got = tpipe(**edits[name]).images
        assert got.shape == want.shape == (1, size, size, 3)
        _assert_u8_close(got, want, f"{ckpt}:{name}")


@pytest.mark.parametrize("name", ["move", "remove"])
def test_toy_128_edit_matches_jax(name):
    check_edits("assets/toy_ckpt", 128, [name])
