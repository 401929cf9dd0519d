"""The move edit of ``test_torch_pipeline`` on the 3-level 256^2 toy
checkpoint (its remove edit runs in ``chip_smoke.py``)."""

import torch

from tests.test_torch_pipeline import check_edits

torch.set_num_threads(2)


def test_toy_256_move_edit_matches_jax():
    check_edits("assets/toy_ckpt_256", 256, ["move"])
