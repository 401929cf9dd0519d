"""The sharded toy edit (``BlobNetPipeline.shard_to_mesh``) on gloo ranks on
the CPU against the JAX package's unsharded edit, fp32, on the trained
128^2 toy checkpoint (the move edit of ``test_torch_pipeline``, 6 UniPC
steps, explicit latents):

  * model=2 (Megatron over two ranks): the single edit;
  * hybrid 2 x 2: the CFG pair over the data axis, the UNet's weights over
    model, BlobNet's over both; its residuals bit-equal on all four ranks;
  * data=2: ``edit_batch`` of two requests, one row on each rank, the
    images gathered.

Every rank holds the images, within the uint8 bar of PERF.md §2 (<= 1
level at >= 99.9 % of pixels, <= 2 everywhere) of JAX's; every rank's
collective log equals ``collectives.expected_counts``; the 3x3 convs ran
at local channel counts. The hybrid recipe refuses a guidance interval.
The full trees stay apart from the local slices, and the int8 weights
are derived from the full tree, sliced, and put beside the local leaves
themselves."""

import numpy as np
import pytest
import torch

from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.parallel import collectives
from blobctrl_torch.parallel import mesh as tmesh
from blobctrl_torch.train import toy as ttoy
from blobctrl_torch.utils import benchkit
from tests import torch_ranks
from tests.test_torch_pipeline import _assert_u8_close, _edits

torch.set_num_threads(2)

CFGS = ttoy.toy_configs(size=128)
STEPS = 6


@pytest.fixture(scope="module")
def reference():
    """(the move edit's kwargs, a second latents array, JAX's images for
    both latents)."""
    move = _edits(128)["move"]
    other = np.random.RandomState(9).randn(
        *move["latents"].shape).astype(np.float32)
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt")
    want = jpipe(**move).images
    want_other = jpipe(**dict(move, latents=other)).images
    return move, other, want, want_other


def _local_convs(shapes, full_out=(32, 64)):
    """Conv launches whose output channels are a slice of a level's."""
    return [s for s in shapes["conv3x3"] if s[1][3] not in full_out
            and any(c % s[1][3] == 0 for c in full_out)]


@pytest.mark.parametrize("recipe,shape", [
    ("model", {"data": 1, "model": 2}),
    ("hybrid", {"data": 2, "model": 2})])
def test_sharded_edit_matches_jax(reference, recipe, shape):
    move, _, want, _ = reference
    world = shape["data"] * shape["model"]
    res = torch_ranks.run_ranks(torch_ranks.edit_rank, world, shape, "128",
                                "__call__", move, recipe)
    expected = collectives.expected_counts(*CFGS, shape, recipe, STEPS)
    for rank, r in enumerate(res):
        assert r["images"].shape == want.shape == (1, 128, 128, 3)
        _assert_u8_close(r["images"], want, f"{recipe} rank {rank}")
        assert r["counts"] == expected, (rank, r["counts"], expected)
        assert _local_convs(r["shapes"]), r["shapes"]
    if recipe == "hybrid":
        # BlobNet at the edit batch over all four ranks: its residuals are
        # the same bits everywhere before each UNet row adds them
        assert len(res[0]["digests"]) == STEPS
        assert all(r["digests"] == res[0]["digests"] for r in res)
        # each data rank ran one CFG row through the UNet (batch 1) at the
        # double-width latent grid (16 x 32), as BlobNet does
        grid = [s for r in res for s in r["shapes"]["conv3x3"]
                if s[0][1:3] == (16, 32)]
        assert grid and all(s[0][0] == 1 for s in grid)


def test_data_parallel_edit_batch_matches_jax(reference):
    move, other, want, want_other = reference
    per = {k: move[k] for k in ("fg_image", "bg_image", "gs_score",
                                "prompt_embeds", "negative_prompt_embeds",
                                "fg_dino_feats")}
    kwargs = dict(requests=[dict(per, seed=1), dict(per, seed=2)],
                  height=128, width=128, num_inference_steps=STEPS,
                  guidance_scale=move["guidance_scale"])
    shape = {"data": 2, "model": 1}
    res = torch_ranks.run_ranks(
        torch_ranks.edit_rank, 2, shape, "128", "edit_batch", kwargs,
        "data", (), {1: move["latents"], 2: other})
    expected = collectives.expected_counts(*CFGS, shape, "data", STEPS,
                                           data_split=True)
    assert expected == {"pipeline": {"all_gather": 1}}
    for rank, r in enumerate(res):
        assert r["images"].shape == (2, 128, 128, 3)
        _assert_u8_close(r["images"][:1], want, f"row 0 on rank {rank}")
        _assert_u8_close(r["images"][1:], want_other, f"row 1 on {rank}")
        assert r["counts"] == expected
        # one request on each rank: the UNet's CFG pair and the VAE's
        # fg + bg at batch 2 at most (both requests would be 4)
        assert max(s[0][0] for s in r["shapes"]["conv3x3"]) == 2


def test_hybrid_refuses_a_guidance_interval():
    pipe, _ = ttoy.load_toy("assets/toy_ckpt", device="cpu")
    pipe.shard_to_mesh(tmesh.Mesh({"data": 1, "model": 1}),
                       hybrid_cfg_data=True)
    move = _edits(128)["move"]
    with pytest.raises(ValueError, match="incompatible with the hybrid"):
        pipe(**dict(move, cfg_guidance_end=0.5))
    assert pipe._kernel_profiles["blobnet"].model == ("data", "model")


def test_int8_weights_come_from_the_full_tree_beside_the_slices():
    pipe, _ = ttoy.load_toy("assets/toy_ckpt", device="cpu")
    full = pipe.unet_params
    # rank 1's view of a model=2 mesh: slicing needs no process group
    pipe.shard_to_mesh(tmesh.Mesh({"data": 1, "model": 2}, rank=1),
                       model_parallel=True)
    local = pipe.unet_params
    assert pipe._full_trees["unet_params"] is not local
    conv1 = (local["down_blocks"][0]["resnets"][0]["conv1"]["kernel"],
             full["down_blocks"][0]["resnets"][0]["conv1"]["kernel"])
    assert conv1[0].shape[3] * 2 == conv1[1].shape[3]
    with benchkit.int8_everything():
        got = pipe._conv_params("unet_params")
    want = pipe._shard("unet_params", tconv.quantize_conv_tree(full))
    n_derived = 0

    def walk(g, w, loc):
        nonlocal n_derived
        if isinstance(g, dict):
            assert g.keys() == w.keys()
            for k in g:
                walk(g[k], w[k], None if loc is None else loc.get(k))
        elif isinstance(g, (list, tuple)):
            for a, b, c in zip(g, w, loc):
                walk(a, b, c)
        else:
            assert torch.equal(g, w)
            if loc is None:
                n_derived += 1
            else:
                assert g is loc   # no second copy of a local leaf
    walk(got, want, local)
    assert n_derived > 0
