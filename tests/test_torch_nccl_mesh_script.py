"""What ``scripts/torch_nccl_mesh.py`` adds to the helpers it runs
(``chip_smoke.py``'s phase 9 and 10d, ``tests/torch_ranks.py``), on the
CPU: the uint8 bar it holds the apps' images to, its count of the
collectives staged through host memory (on 2 gloo ranks: CPU tensors are
never staged), the spawner's results and refusal of a failed rank, and
the training flags of its spawned form. About 10 s."""

import os
import sys

import numpy as np
import pytest

from tests import torch_ranks

sys.path.insert(0, os.path.join(torch_ranks.ROOT, "scripts"))
import torch_nccl_mesh as nccl_mesh  # noqa: E402


@pytest.mark.parametrize("levels, pixels, ok", [
    (0, 0, True), (1, 4096, True), (2, 12, True), (2, 13, False),
    (3, 1, False)])
def test_the_uint8_bar(levels, pixels, ok):
    """<= 1 level at >= 99.9 % of the pixels, <= 2 everywhere (the bar of
    ``tests/test_torch_parallel_apps.py``)."""
    a = np.full((64, 64, 3), 100 / 255.0)
    b = a.copy().reshape(-1)
    b[:pixels] += levels / 255.0
    got = nccl_mesh.u8_distance(a, b.reshape(a.shape))
    assert got["ok"] == ok
    assert got["max"] == (levels if pixels else 0)


def test_staging_is_counted_on_gloo_ranks():
    assert torch_ranks.run_ranks(torch_ranks.staging_rank, 2) == [[3, 0]] * 2


def test_spawn_returns_rank_order_and_refuses_a_failed_rank(monkeypatch):
    """The one spawner, ``chip_smoke.spawn``, which the script's parts
    call."""
    monkeypatch.setattr(nccl_mesh.cs, "PARALLEL_TIMEOUT_S", 60.0)
    assert nccl_mesh.cs.spawn(torch_ranks.spawned_rank, 2, (None,)) == [
        0, 10]
    with pytest.raises(AssertionError, match="rank 1 failed"):
        nccl_mesh.cs.spawn(torch_ranks.spawned_rank, 2, (1,))


def test_the_spawned_training_flags():
    """10d's roots and flags, its 2 hosts' global batch as one host's
    --batch_size, over 4 spawned ranks."""
    argv = nccl_mesh.train_argv("/r", "/c", "cuda")
    assert argv[argv.index("--batch_size") + 1] == "4"
    assert argv[-4:] == ["--data_parallel", "4", "--device", "cuda"]
    assert argv[argv.index("--ckpt_dir") + 1] == "/c"


def test_free_ports_are_distinct_and_below_the_ephemeral_range():
    ports = nccl_mesh.free_ports(4)
    assert len(set(ports)) == 4 and all(20000 <= p < 30000 for p in ports)
