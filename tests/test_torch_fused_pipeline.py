"""The fused-kernel edit end to end: the port on the CPU against the JAX
pipeline, fp32, on the trained 256^2 toy checkpoint (the move edit of
``test_torch_pipeline``, 6 UniPC steps), with the four opt-in kernels on
both sides: the exp2-folded flash attention, GroupNorm -> proj_in, each
pre-LayerNorm fused into its projection, and Winograd F(2x2, 3x3) for every
routed 3x3 conv.

The JAX package routes to its Pallas kernels only on a TPU. Here its
``_route_conv`` and ``_use_flash`` are replaced by the rule it applies on the
card (the rule the port applies everywhere), with the kernels in interpret
mode. The fused edit computes the exact edit another way, so it is held to
the exact path's bar."""

import torch

from blobctrl_tpu.nn import attention as jattn
from blobctrl_tpu.nn import resnet as jres
from blobctrl_tpu.nn import transformer_2d as jt2d
from blobctrl_tpu.ops import conv3x3 as jconv
from blobctrl_tpu.ops import flash_attention as jfa
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.train import toy as ttoy
from blobctrl_torch.utils import benchkit as tbench
from tests.test_torch_fused_ops import FUSED
from tests.test_torch_int8_ops import _spy
from tests.test_torch_int8_pipeline import _card_route_conv, _card_use_flash
from tests.test_torch_pipeline import _assert_u8_close, _edits

torch.set_num_threads(2)


def test_toy_256_fused_move_edit_matches_jax(monkeypatch):
    edit = _edits(256)["move"]
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt_256")
    monkeypatch.setattr(jres, "_route_conv", _card_route_conv)
    monkeypatch.setattr(jattn, "_use_flash", _card_use_flash)
    saved = (jattn.get_attention_backend(), jfa._EXP2_FOLD,
             jt2d._GN_PROJ_FUSE, jattn._LN_MATMUL_FUSE,
             jconv.winograd_enabled())
    jattn.set_attention_backend("interpret")
    jfa.set_exp2_fold(True)
    jt2d.set_gn_proj_fuse(True)
    jattn.set_ln_matmul_fuse("interpret")
    jconv.set_winograd(True)
    try:
        want = jpipe(**edit).images
    finally:
        jattn.set_attention_backend(saved[0])
        jfa.set_exp2_fold(saved[1])
        jt2d.set_gn_proj_fuse(saved[2])
        jattn.set_ln_matmul_fuse(saved[3])
        jconv.set_winograd(saved[4])

    tpipe, _ = ttoy.load_toy("assets/toy_ckpt_256", device="cpu")
    calls = [_spy(monkeypatch, mod, name) for mod, name in FUSED]
    with tbench.fused_kernels():
        got = tpipe(**edit).images
    assert got.shape == want.shape == (1, 256, 256, 3)
    assert all(calls), [len(c) for c in calls]
    _assert_u8_close(got, want, "toy_ckpt_256:move fused")
