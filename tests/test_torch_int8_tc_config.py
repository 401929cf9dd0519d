"""The launches of the int8 tensor-core kernels, chosen in their wrappers:
the int8 conv (``ops.conv3x3.launch_config_int8``, its K-major weights
``kmajor_weights``) at every conv shape of a 512^2 edit, and the int8 flash
attention (``ops.flash_attention.launch_config_int8``, its padded int8 rows
``int8_rows``) at the int8 edit's two self-attention shapes. Pure Python:
runs on the CPU."""

import os
import re

import numpy as np
import pytest
import torch

from blobctrl_torch.ops import _split
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.ops import flash_attention as tfa
from tests.test_torch_gemm_config import MAX_SMEM, SM_SMEM, _check
from tests.test_torch_winograd_config import MAIN_PATH_SHAPES as CONV_SHAPES

CSRC = os.path.join(os.path.dirname(tconv.__file__), "..", "csrc")
# (bh, sq, skv, d) of the int8 edit's flash launches: the top level (UNet
# batch 2 x 8 heads, BlobNet 8 heads, D = 40) and the level below (D = 80)
FLASH_SHAPES = [(16, 8192, 8192, 40), (8, 8192, 8192, 40),
                (16, 2048, 2048, 80), (8, 2048, 2048, 80)]


def _consts(name, *names):
    src = open(os.path.join(CSRC, name)).read()
    return tuple(int(re.search(rf"\b{n} = (\d+)", src).group(1))
                 for n in names)


@pytest.mark.parametrize("b,h,w,c,co", CONV_SHAPES)
def test_conv3x3_int8_launch_config(b, h, w, c, co):
    cfg = tconv.launch_config_int8(b, h, w, c, co)
    blocks, n_blocks, _ = cfg["grid"]
    assert blocks == b * -(-h // tconv.PATCH_H) * -(-w // tconv.PATCH_W)
    assert n_blocks == -(-co // tconv.BLOCK_N)
    # two blocks an SM (the kernel's __launch_bounds__), a wave or a split,
    # no empty split
    _check(cfg, blocks * n_blocks, -(-c // tconv.INT8_BLOCK_K), 2)


@pytest.mark.parametrize("bh,sq,skv,d", FLASH_SHAPES)
def test_flash_int8_launch_config(bh, sq, skv, d):
    cfg = tfa.launch_config_int8(bh, sq, skv, d)
    assert cfg["row_bytes"] % 16 == 0 and d <= cfg["row_bytes"] < d + 16
    assert cfg["row_bytes"] <= cfg["dk"] and d <= cfg["dn"] <= cfg["dk"]
    assert cfg["dk"] % 16 == 0 and cfg["dn"] % 8 == 0
    assert cfg["smem_bytes"] <= MAX_SMEM
    assert cfg["grid"] == (-(-sq // tfa.INT8_BLOCK_Q), bh)
    # a block on (nearly) every SM: BlobNet's level below (bh 8 at 2048
    # tokens) gives 128 blocks for the 132 SMs; the kernel has no split of
    # the keys
    assert cfg["grid"][0] * cfg["grid"][1] >= 128
    # the wrapper hands over exactly that row length
    q8 = torch.zeros(1, 3, d, dtype=torch.int8)
    assert tfa.int8_rows(q8).shape == (1, 3, cfg["row_bytes"])


def test_flash_int8_specialisations():
    """Every D the kernel takes maps to the smallest specialisation that
    holds it: (48, 40), (80, 80) or (160, 160)."""
    seen = {}
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        cfg = tfa.launch_config_int8(1, 128, 128, d)
        seen.setdefault((cfg["dk"], cfg["dn"]), []).append(d)
        assert cfg["smem_bytes"] <= MAX_SMEM
    assert {k: (v[0], v[-1]) for k, v in seen.items()} == {
        (48, 40): (1, 40), (80, 80): (41, 80), (160, 160): (81, 160)}


def test_int8_launch_configs_mirror_the_kernels():
    """The wrappers' block constants and shared memory are the kernels'."""
    ph, pw, bn, bk, stages, qs = _consts(
        "conv3x3_int8.cu", "PATCH_H", "PATCH_W", "BN", "BK", "STAGES",
        "Q_STAGES")
    conv = open(os.path.join(CSRC, "conv3x3_int8.cu")).read()
    assert re.search(r"\bQ_LD = BK \+ 16;", conv)
    assert re.search(r"\bB_LD = BK \+ 16;", conv)
    assert (ph, pw, bn, bk, stages) == (tconv.PATCH_H, tconv.PATCH_W,
                                        tconv.BLOCK_N, tconv.INT8_BLOCK_K,
                                        tconv.INT8_B_STAGES)
    assert tconv.INT8_ROW_LD == bk + 16
    halo = (ph + 2) * (pw + 2)
    assert (qs * halo * (bk + 16) + stages * bn * (bk + 16)
            == tconv.INT8_SMEM_BYTES)
    assert 2 * (tconv.INT8_SMEM_BYTES + 1024) <= SM_SMEM
    warps, bkv, fst = _consts("flash_attention_int8.cu", "TC_WARPS", "TC_BKV",
                              "TC_STAGES")
    assert (16 * warps, bkv, fst) == (tfa.INT8_BLOCK_Q, tfa.INT8_BLOCK_KV,
                                      tfa.INT8_STAGES)
    flash = open(os.path.join(CSRC, "flash_attention_int8.cu")).read()
    specs = re.findall(r"launch_tc_d<GLOBAL_K, (\d+), (\d+)>\(", flash)
    assert sorted({(int(a), int(b)) for a, b in specs}) == [
        (48, 40), (80, 80), (160, 160)]


@pytest.mark.parametrize("c,co", [(37, 40), (1029, 3), (64, 130)])
def test_kmajor_weights_layout(c, co):
    rng = np.random.RandomState(c)
    kq = torch.tensor(rng.randint(-127, 128, (3, 3, c, co)), dtype=torch.int8)
    wt = tconv.kmajor_weights(kq)
    cp = -(-c // 16) * 16
    assert wt.shape == (9, co, cp) and wt.dtype == torch.int8
    assert wt.is_contiguous()
    # wt[kh * 3 + kw, n, c] = kernel_q[kh, kw, c, n], zeros past C
    want = kq.numpy().reshape(9, c, co).transpose(0, 2, 1)
    np.testing.assert_array_equal(wt[:, :, :c].numpy(), want)
    assert not wt[:, :, c:].any()
    # made once per kernel_q and dropped with it
    assert tconv.kmajor_weights(kq) is wt
    key = id(kq)
    del kq
    assert key not in tconv._KMAJOR


def test_int8_rows_pad_with_zeros():
    rng = np.random.RandomState(0)
    for d in (16, 20, 40, 80, 160):
        t8 = torch.tensor(rng.randint(-127, 128, (2, 5, d)), dtype=torch.int8)
        got = tfa.int8_rows(t8)
        assert got.shape == (2, 5, -(-d // 16) * 16) and got.is_contiguous()
        assert torch.equal(got[..., :d], t8) and not got[..., d:].any()
        # zeros add nothing to the integer scores
        s = torch.matmul(t8[0].int(), t8[1].int().T)
        assert torch.equal(torch.matmul(got[0].int(), got[1].int().T), s)
