"""The sharded toy edit at a photo's own size: fp32 on the CPU, gloo ranks,
on the trained 128^2 toy checkpoint (``assets/toy_ckpt``), the move edit
of ``chip_smoke.toy_edits`` (3 UniPC steps, explicit latents) at W x H =
120 x 88: a 15 x 11 latent, odd at every level of the double-width grid,
and h % 8 != 0 below the latent. ``chip_smoke.py`` phase 9 runs the same
recipes on the card at 320 x 256.

  * model=2 (Megatron over two ranks) and hybrid 2 x 2 (the CFG pair over
    the data axis): the single edit against the JAX package's unsharded
    edit at the same size.

Every rank holds the image, within the uint8 bar of PERF.md §2 (<= 1 level
at >= 99.9 % of pixels, <= 2 everywhere) of JAX's; every rank's
collective log equals ``collectives.expected_counts``; the 3x3 convs ran
at local channel counts (the VAE's here: no level of the 11 x 30 latent
grid has h % 8 == 0, so the UNet's and BlobNet's convs route to plain
torch, as the JAX package routes them). ``edit_batch`` at data=2 is in
``test_torch_parallel_sizes_batch``: a file each, so that neither passes
~60 s under tier-1's xdist."""

import pytest
import torch

import chip_smoke
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.parallel import collectives
from blobctrl_torch.train import toy as ttoy
from tests import torch_ranks
from tests.test_torch_parallel_pipeline import _local_convs
from tests.test_torch_pipeline import _assert_u8_close

torch.set_num_threads(2)

CFGS = ttoy.toy_configs(size=128)
STEPS = 3
W, H = 120, 88


@pytest.fixture(scope="module")
def reference():
    """(the move edit's kwargs at W x H, seeded as phase 9's, so that no
    rank draws a seed of its own; JAX's image)."""
    move = dict(chip_smoke.toy_edits(H, STEPS, width=W)["move"], seed=0)
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt")
    return move, jpipe(**move).images


@pytest.mark.parametrize("recipe,shape", [
    ("model", {"data": 1, "model": 2}),
    ("hybrid", {"data": 2, "model": 2})])
def test_sharded_edit_at_a_photo_size_matches_jax(reference, recipe, shape):
    move, want = reference
    world = shape["data"] * shape["model"]
    res = torch_ranks.run_ranks(torch_ranks.edit_rank, world, shape, "128",
                                "__call__", move, recipe)
    expected = collectives.expected_counts(*CFGS, shape, recipe, STEPS)
    for rank, r in enumerate(res):
        assert r["images"].shape == want.shape == (1, H, W, 3)
        _assert_u8_close(r["images"], want, f"{recipe} rank {rank}")
        assert r["counts"] == expected, (rank, r["counts"], expected)
        assert _local_convs(r["shapes"]), r["shapes"]
    if recipe == "hybrid":
        # BlobNet's residuals the same bits on all four ranks at every step
        assert len(res[0]["digests"]) == STEPS
        assert all(r["digests"] == res[0]["digests"] for r in res)
