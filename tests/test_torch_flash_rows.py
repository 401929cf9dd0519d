"""The row-sliced plain flash versions ``chip_smoke.py`` phase 2 holds the
flash kernels to where the whole plain version would not fit on the card
(more than ``flash_attention.PLAIN_MAX_ROWS`` query rows or
``PLAIN_MAX_SCORES`` score elements: 32,768 rows at a 1024^2 edit, whose
(16, Sq, Skv) fp32 scores are 68.7 GB). On the CPU at small shapes, with
the row limit lowered: each case of phase 2 (fixed max,
running max, exp2-folded, int8 with a global and with per-row k scales),
through ``chip_smoke.kernel_and_plain``, gives at ``query_rows``' tiles
(the first, the middle one and a ragged last one) the rows of the whole
plain version, which the wrappers run for CPU tensors, up to the order in
which a product of fewer rows sums (the CPU's BLAS blocks it otherwise):
fp32 within 1e-6 of max |whole|, bf16 within one bf16 rounding (2^-8
relative), each far inside phase 2's bars (1e-4, 2e-2)."""

import pytest
import torch

import chip_smoke
from blobctrl_torch.ops import flash_attention as fa

# (phase 2's case, its mode)
TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}
CASES = {"fixed max": (chip_smoke.flash_case, 20.0),
         "running max": (chip_smoke.flash_case, None),
         "exp2-folded": (chip_smoke.flash_exp2_case, None),
         "int8, global k": (chip_smoke.flash_int8_case, True),
         "int8, per-row k": (chip_smoke.flash_int8_case, False)}


@pytest.fixture
def on_the_cpu(monkeypatch):
    """Phase 2's inputs drawn on the CPU, the plain versions limited to
    256 query rows."""
    monkeypatch.setattr(chip_smoke, "_rnd", lambda gen, *shape, s=1.0:
                        torch.randn(*shape, generator=gen) * s)
    monkeypatch.setattr(fa, "PLAIN_MAX_ROWS", 256)
    monkeypatch.setattr(chip_smoke, "EXP_RATE", 1e12)   # set from the card
    return torch.Generator().manual_seed(0)


def test_query_rows_are_the_first_middle_and_last_tiles(monkeypatch):
    monkeypatch.setattr(fa, "PLAIN_MAX_ROWS", 256)
    assert fa.query_rows(3, 256, 136) == [slice(0, 256)]
    assert fa.query_rows(3, 600, 136) == [slice(0, 128), slice(256, 384),
                                          slice(512, 600)]
    assert fa.query_rows(3, 1024, 136) == [slice(0, 128), slice(512, 640),
                                           slice(896, 1024)]
    # with the card's limits: a 1024^2 edit's top level, a 768x512 edit's,
    # a batch of four 512^2 edits (2^32 scores) and of four 768x512 edits
    monkeypatch.undo()
    assert (fa.PLAIN_MAX_ROWS, fa.PLAIN_MAX_SCORES) == (16384, 2 ** 32)
    assert fa.query_rows(16, 32768, 32768) == [
        slice(0, 128), slice(16384, 16512), slice(32640, 32768)]
    assert fa.query_rows(16, 12288, 12288) == [slice(0, 12288)]
    assert fa.query_rows(64, 8192, 8192) == [slice(0, 8192)]
    assert fa.query_rows(64, 12288, 12288) == [
        slice(0, 128), slice(6144, 6272), slice(12160, 12288)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("name", list(CASES))
def test_sliced_rows_equal_the_whole_plain_version(on_the_cpu, name, dtype):
    make, mode = CASES[name]
    bh, sq, skv, d = 3, 600, 136, 40
    case = make((bh, sq, skv, d, str(dtype), mode), dtype, on_the_cpu)
    assert case["rows"] == fa.query_rows(bh, sq, skv) and len(case["rows"]) == 3
    got, ref = chip_smoke.kernel_and_plain(case, mode)
    assert ref.shape == got.shape == (bh, 128 + 128 + 88, d)
    assert ref.dtype == dtype
    _, rel = chip_smoke.rel_err(got, ref)
    assert rel <= TOL[dtype], rel


def test_up_to_the_limit_the_whole_output_is_compared(on_the_cpu):
    case = chip_smoke.flash_case((2, 256, 128, 40, "torch.float32", True),
                                 torch.float32, on_the_cpu)
    got, ref = chip_smoke.kernel_and_plain(case, 20.0)
    assert case["rows"] == [slice(0, 256)]
    assert got.shape == ref.shape == (2, 256, 40) and torch.equal(got, ref)
