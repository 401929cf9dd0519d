"""The port's edit against the JAX package's at a photo's own size, not
512^2 and not square: fp32 on the CPU, on the trained 128^2 toy
(``assets/toy_ckpt``), the move and the remove edit of
``chip_smoke.toy_edits`` (the edits ``chip_smoke.py`` phase 3 runs on the
card at its own photo sizes) at W x H = 96 x 128 and 128 x 96: the
double-width latent's levels are then neither square nor powers of two.
Each side loads the checkpoint with its own loader. Bar: the uint8 bar of
``test_torch_pipeline`` (<= 1 level at >= 99.9 % of pixels, <= 2
everywhere). The JAX side traces and compiles its edit once a size, about
8-12 s of the ~10-15 s each case takes; so the other sizes are cases in
``test_torch_pipeline_sizes_ragged`` and the batch and the CLI in
``test_torch_pipeline_sizes_apps``, each file ~30 s or less."""

import pytest
import torch

import chip_smoke
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.train import toy as ttoy
from tests.test_torch_pipeline import _assert_u8_close

torch.set_num_threads(2)

STEPS = 3
CKPT = "assets/toy_ckpt"


@pytest.fixture(scope="module")
def pipes():
    return jtoy.load_toy(CKPT)[0], ttoy.load_toy(CKPT, device="cpu")[0]


def check_photo_edits(pipes, w, h):
    """The move and remove edits at W x H against JAX's; both outputs
    (1, H, W, 3) floored to multiples of 8."""
    jpipe, tpipe = pipes
    edits = chip_smoke.toy_edits(h, STEPS, width=w)
    for name, kw in edits.items():
        want = jpipe(**kw).images
        got = tpipe(**kw).images
        assert got.shape == want.shape == (1, h // 8 * 8, w // 8 * 8, 3)
        _assert_u8_close(got, want, f"{w}x{h} {name}")


@pytest.mark.parametrize("w, h", [(96, 128), (128, 96)],
                         ids=lambda v: str(v))
def test_toy_edits_at_a_photo_size_match_jax(pipes, w, h):
    check_photo_edits(pipes, w, h)
