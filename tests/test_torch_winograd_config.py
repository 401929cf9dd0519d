"""The bf16 Winograd kernel's launch configuration, chosen in the wrapper
(``ops.winograd.launch_config``), at every shape a 512^2 edit launches it:
the fused-kernel edit's UNet (batch 2), BlobNet (batch 1) and VAE convs, as
``chip_smoke.py`` records them from a one-step edit on the card. Pure
Python: runs on the CPU."""

import os
import re

import pytest

from blobctrl_torch.ops import _split
from blobctrl_torch.ops import winograd as twg

# (b, h, w, c, co) of every Winograd launch of a 512^2 fused edit
MAIN_PATH_SHAPES = [
    (1, 8, 16, 1280, 1280), (1, 8, 16, 2560, 1280), (1, 16, 32, 640, 1280),
    (1, 16, 32, 1280, 1280), (1, 16, 32, 1920, 1280), (1, 16, 32, 2560, 1280),
    (1, 32, 64, 320, 640), (1, 32, 64, 640, 640), (1, 32, 64, 960, 640),
    (1, 32, 64, 1280, 640), (1, 32, 64, 1280, 1280), (1, 32, 64, 1920, 640),
    (1, 64, 64, 512, 512), (1, 64, 128, 320, 320), (1, 64, 128, 640, 320),
    (1, 64, 128, 640, 640), (1, 64, 128, 960, 320), (1, 64, 128, 1029, 320),
    (1, 128, 128, 512, 512), (1, 256, 256, 256, 256), (1, 256, 256, 512, 256),
    (1, 256, 256, 512, 512), (1, 512, 512, 128, 128), (1, 512, 512, 256, 128),
    (1, 512, 512, 256, 256), (2, 8, 16, 1280, 1280), (2, 8, 16, 2560, 1280),
    (2, 16, 32, 640, 1280), (2, 16, 32, 1280, 1280), (2, 16, 32, 1920, 1280),
    (2, 16, 32, 2560, 1280), (2, 32, 64, 320, 640), (2, 32, 64, 640, 640),
    (2, 32, 64, 960, 640), (2, 32, 64, 1280, 640), (2, 32, 64, 1280, 1280),
    (2, 32, 64, 1920, 640), (2, 64, 64, 512, 512), (2, 64, 128, 320, 320),
    (2, 64, 128, 640, 320), (2, 64, 128, 640, 640), (2, 64, 128, 960, 320),
    (2, 128, 128, 256, 512), (2, 128, 128, 512, 512), (2, 256, 256, 128, 256),
    (2, 256, 256, 256, 256), (2, 512, 512, 128, 128),
]
MAX_SMEM = 232448  # what one block may use on the H100 (227 KB)


@pytest.mark.parametrize("b,h,w,c,co", MAIN_PATH_SHAPES)
def test_launch_config_fills_the_card(b, h, w, c, co):
    cfg = twg.launch_config(b, h, w, c, co)
    blocks, n_blocks, splits = cfg["grid"]
    assert cfg["smem_bytes"] <= MAX_SMEM
    assert blocks * n_blocks * splits >= _split.NUM_SMS, cfg
    assert splits == cfg["splits"] >= 1
    slices = -(-c // twg.BLOCK_K)
    per = -(-slices // splits)
    assert -(-slices // per) == splits  # no split is empty
    if splits > 1:
        assert per >= _split.MIN_SLICES_PER_SPLIT
        # a split only where it cuts the waves' work: waves x slices a block
        def work(s, per):
            return -(-blocks * n_blocks * s // _split.NUM_SMS) * (
                per + _split.SPLIT_OVERHEAD_SLICES)
        assert work(splits, per) < work(1, slices)


def test_launch_config_mirrors_the_kernel():
    """The wrapper's block constants and shared memory are the kernel's."""
    path = os.path.join(os.path.dirname(twg.__file__), "..", "csrc",
                        "winograd.cu")
    src = open(path).read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    ph, pw, tn, tk = const("TP_H"), const("TP_W"), const("TN"), const("TK")
    assert (ph, pw, tn, tk) == (twg.PATCH_H, twg.PATCH_W, twg.BLOCK_N,
                                twg.BLOCK_K)
    halo = (2 * ph + 2) * (2 * pw + 2) * (tk + 16)
    u = 16 * tk * (tn + 8)
    v = 16 * ph * pw * (tk + 8)
    scale_shift = 2 * 2 * tk  # two stages of the slice's scale and shift
    assert 2 * (2 * u + 2 * halo + v) + 4 * scale_shift == twg.SMEM_BYTES


def test_launch_config_splits_where_waves_are_short():
    # 4096 blocks: 32 waves, nothing to gain
    assert twg.launch_config(2, 512, 512, 128, 128)["splits"] == 1
    # 20 blocks: 10 splits of 4 slices, 200 blocks in two waves
    cfg = twg.launch_config(1, 8, 16, 1280, 1280)
    assert cfg["splits"] == 10 and cfg["grid"] == (1, 20, 10)
    # 160 blocks would take two waves, the second one 28 blocks
    assert twg.launch_config(2, 16, 32, 1280, 1280)["splits"] > 1
