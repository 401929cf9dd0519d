"""``edit_batch`` at data=2 at a photo's own size: fp32 on the CPU, two
gloo ranks, on the trained 128^2 toy checkpoint, the two requests of
``test_torch_pipeline_sizes_apps``' batch at W x H = 128 x 96 (their own
ellipses and seeds; each package draws a request's noise from its seed),
one request on each rank and the images gathered, against the JAX
package's unsharded ``edit_batch`` at the uint8 bar of PERF.md §2. Every
rank's collective log equals ``collectives.expected_counts`` (one
all-gather); each rank's convs ran at one request's batch. The sharded
single edit at a photo's size is in ``test_torch_parallel_sizes``."""

import numpy as np
import torch

from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.parallel import collectives
from blobctrl_torch.train import toy as ttoy
from tests import torch_ranks
from tests.test_torch_pipeline import _assert_u8_close
from tests.test_torch_pipeline_sizes import STEPS
from tests.test_torch_pipeline_sizes_apps import photo_batch

torch.set_num_threads(2)

CFGS = ttoy.toy_configs(size=128)
W, H = 128, 96


def test_data_parallel_edit_batch_at_a_photo_size_matches_jax():
    reqs, shared = photo_batch(W, H)
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt")
    want = jpipe.edit_batch([dict(r) for r in reqs], **shared).images
    shape = {"data": 2, "model": 1}
    res = torch_ranks.run_ranks(torch_ranks.edit_rank, 2, shape, "128",
                                "edit_batch", dict(shared, requests=reqs),
                                "data")
    expected = collectives.expected_counts(*CFGS, shape, "data", STEPS,
                                           data_split=True)
    assert expected == {"pipeline": {"all_gather": 1}}
    for rank, r in enumerate(res):
        assert r["images"].shape == want.shape == (2, H, W, 3)
        _assert_u8_close(r["images"], want, f"edit_batch rank {rank}")
        assert not np.array_equal(r["images"][0], r["images"][1])
        assert r["counts"] == expected
        # one request on each rank: the UNet's CFG pair and the VAE's
        # fg + bg at batch 2 at most (both requests would be 4)
        assert max(s[0][0] for s in r["shapes"]["conv3x3"]) == 2
