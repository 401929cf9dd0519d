"""The launch configurations of the bf16 kernels on the shared tensor-core
GEMM mainloop (``csrc/gemm_bf16.cuh``), chosen in their wrappers: the
direct conv3x3 (``ops.conv3x3.launch_config``) at every shape a 512^2 edit
launches it, and the normalize-prologue GEMM (``ops.gn_matmul.
launch_config``, shared by ``ops.ln_matmul``) at every (m, c, n) of the
fused-kernel edit, as ``chip_smoke.py`` records them from a one-step edit
on the card. Pure Python: runs on the CPU."""

import os
import re

import pytest

from blobctrl_torch.ops import _split
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.ops import gn_matmul as tgn
from tests.test_torch_winograd_config import MAIN_PATH_SHAPES as CONV_SHAPES

# (m, c, n) of every GroupNorm -> proj_in GEMM (K10, m = b * h * w, n = c)
# and LayerNorm -> projection GEMM (K11: n = c for the cross-attention
# to_q, 3c for the fused QKV, 8c for GEGLU's proj_in) of a 512^2 fused edit
AFFINE_SHAPES = [(m, c, c) for m, c in (
    (128, 1280), (256, 1280), (512, 1280), (1024, 1280), (2048, 640),
    (4096, 640), (8192, 320), (16384, 320))]
LN_SHAPES = [
    (128, 1280, 3840), (128, 1280, 10240), (256, 1280, 1280),
    (256, 1280, 3840), (256, 1280, 10240), (512, 1280, 3840),
    (512, 1280, 10240), (1024, 1280, 1280), (1024, 1280, 3840),
    (1024, 1280, 10240), (2048, 640, 1920), (2048, 640, 5120),
    (4096, 640, 640), (4096, 640, 1920), (4096, 640, 5120),
    (8192, 320, 960), (8192, 320, 2560), (16384, 320, 320),
    (16384, 320, 960), (16384, 320, 2560),
]
MAX_SMEM = 232448     # what one block may use on the H100 (227 KB)
SM_SMEM = 233472      # an SM's shared memory (228 KB), 1 KB of it per block reserved
CSRC = os.path.join(os.path.dirname(tconv.__file__), "..", "csrc")


def _check(cfg, grid, slices, blocks_per_sm):
    """The split of a launch whose output blocks number ``grid``, each with
    ``slices`` K slices unsplit."""
    splits = cfg["splits"]
    assert cfg["grid"][2] == splits >= 1
    # blocks_per_sm blocks share an SM (the kernel's __launch_bounds__),
    # within 227 KB each
    assert cfg["smem_bytes"] <= MAX_SMEM
    assert blocks_per_sm * (cfg["smem_bytes"] + 1024) <= SM_SMEM
    # at least one full wave, or a split of K where the waves are short
    assert grid * splits >= _split.NUM_SMS or splits > 1, cfg
    per = -(-slices // splits)
    assert -(-slices // per) == splits  # no split is empty
    if splits > 1:
        assert per >= _split.MIN_SLICES_PER_SPLIT

        def work(s, per):  # waves x slices a block
            return -(-grid * s // _split.NUM_SMS) * (
                per + _split.SPLIT_OVERHEAD_SLICES)
        # a grid that fills the SMs splits only where that cuts the work
        assert grid < _split.NUM_SMS or work(splits, per) < work(1, slices)


@pytest.mark.parametrize("b,h,w,c,co", CONV_SHAPES)
def test_conv3x3_launch_config(b, h, w, c, co):
    cfg = tconv.launch_config(b, h, w, c, co)
    blocks, n_blocks, _ = cfg["grid"]
    assert blocks == b * -(-h // tconv.PATCH_H) * -(-w // tconv.PATCH_W)
    assert n_blocks == -(-co // tconv.BLOCK_N)
    _check(cfg, blocks * n_blocks, -(-c // tconv.BLOCK_K), 2)


@pytest.mark.parametrize("m,c,n", AFFINE_SHAPES + LN_SHAPES)
def test_gemm_launch_config(m, c, n):
    cfg = tgn.launch_config(m, c, n)
    m_blocks, n_blocks, _ = cfg["grid"]
    wide = n % tgn.WIDE_N == 0
    assert cfg["block_n"] == (tgn.WIDE_N if wide else tgn.NARROW_N)
    assert (m_blocks, n_blocks) == (-(-m // tgn.BLOCK_M),
                                    -(-n // cfg["block_n"]))
    assert cfg["smem_bytes"] == tgn.smem_bytes(cfg["block_n"])
    _check(cfg, m_blocks * n_blocks, -(-c // tgn.SLICES[cfg["block_n"]][0]),
           1 if wide else 2)


def _consts(name, *names):
    src = open(os.path.join(CSRC, name)).read()
    return tuple(int(re.search(rf"\b{n} = (\d+)", src).group(1))
                 for n in names)


def test_launch_configs_mirror_the_kernels():
    """The wrappers' block constants and shared memory are the kernels'."""
    (bm,) = _consts("gemm_bf16.cuh", "BM")
    conv = open(os.path.join(CSRC, "conv3x3.cu")).read()
    bn = int(re.search(r"using CT = gemm::Tile<(\d+)>", conv).group(1))
    ph, pw, bk, stages = _consts("conv3x3.cu", "PATCH_H", "PATCH_W", "TC_BK",
                                 "TC_STAGES")
    assert ph * pw == bm
    assert (ph, pw, bn, bk, stages) == (tconv.PATCH_H, tconv.PATCH_W,
                                        tconv.BLOCK_N, tconv.BLOCK_K,
                                        tconv.B_STAGES)
    halo = (ph + 2) * (pw + 2) * (bk + 8)
    assert 2 * (2 * halo + stages * bk * (bn + 8)) == tconv.SMEM_BYTES
    wide, narrow, wbk, wst, nbk, nst = _consts(
        "norm_matmul.cu", "WIDE_BN", "NARROW_BN", "WIDE_BK", "WIDE_STAGES",
        "NARROW_BK", "NARROW_STAGES")
    assert (bm, wide, narrow) == (tgn.BLOCK_M, tgn.WIDE_N, tgn.NARROW_N)
    assert tgn.SLICES == {wide: (wbk, wst), narrow: (nbk, nst)}
    for bn, (bk, stages) in tgn.SLICES.items():
        # per stage x and w; the rows' fp32 mean and rstd
        assert (2 * stages * (bm * (bk + 8) + bk * (bn + 8)) + 8 * bm
                == tgn.smem_bytes(bn))


def test_launch_configs_split_where_waves_are_short():
    # 4096 patches: 32 waves, nothing to gain
    assert tconv.launch_config(2, 512, 512, 128, 128)["splits"] == 1
    # one 8 x 16 patch x 10 Co blocks: C = 1280 in 20 slices, split 10 ways
    assert tconv.launch_config(1, 8, 16, 1280, 1280)["grid"] == (1, 10, 10)
    # M = 128 rows x 5 column blocks of 256: C = 1280 in 20 slices, split
    assert tgn.launch_config(128, 1280, 1280)["grid"] == (1, 5, 10)
    # 8 x 40 blocks fill the SMs: no split, whatever a last wave leaves
    assert tgn.launch_config(1024, 1280, 10240)["splits"] == 1
    # 128 x 3 blocks at C = 320: no split
    assert tgn.launch_config(16384, 320, 320)["splits"] == 1
