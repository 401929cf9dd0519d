"""``test_torch_pipeline_sizes``' check at the ragged photo sizes, in a
file of its own so that neither file passes ~30 s under xdist (the JAX
side compiles its edit once a size): the move and remove edits of the
trained 128^2 toy, port against JAX, fp32, at W x H = 120 x 88 (a 15 x 11
latent: odd at every level) and 100 x 76 (no multiple of 8: both packages
floor the output to 96 x 72), at the uint8 bar of ``test_torch_pipeline``.
About 20-30 s."""

import pytest
import torch

from tests.test_torch_pipeline_sizes import check_photo_edits, pipes  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("w, h", [(120, 88), (100, 76)],
                         ids=lambda v: str(v))
def test_toy_edits_at_a_ragged_size_match_jax(pipes, w, h):  # noqa: F811
    check_photo_edits(pipes, w, h)
