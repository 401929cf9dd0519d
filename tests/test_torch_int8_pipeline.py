"""The int8-everything edit end to end: the port on the CPU against the JAX
pipeline, fp32, on the trained 256^2 toy checkpoint (the move edit of
``test_torch_pipeline``, 6 UniPC steps).

The JAX package routes to its Pallas kernels only on a TPU. Here its
``_route_conv`` and ``_use_flash`` are replaced by the rule it applies on the
card (the rule the port applies everywhere), with the kernels in interpret
mode, so both sides take the int8 conv at every routed conv and the int8
global-k flash attention at every long self-attention.

The int8 edit is chaotic in its inputs: an activation that lands within an
ulp of a rounding boundary of the int8 grid flips by one step, the step
spreads through the following convs and attentions and flips more, so two
implementations that differ only in fp32 rounding drift apart by far more
than fp32 rounding. The bound is therefore measured on the JAX package
itself: the port must be as close to the JAX int8 edit as that edit is to
itself when its initial latents move by one ulp (about 49 dB here, while
int8 sits about 46 dB from the exact edit), less 1 dB, and never needs more
than 50 dB."""

import numpy as np
import torch

from blobctrl_tpu.nn import attention as jattn
from blobctrl_tpu.nn import resnet as jres
from blobctrl_tpu.ops import conv3x3 as jconv
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.ops import conv3x3 as tconv
from blobctrl_torch.ops import flash_attention as tfa
from blobctrl_torch.train import toy as ttoy
from blobctrl_torch.utils import benchkit as tbench
from tests.test_torch_int8_ops import _spy
from tests.test_torch_pipeline import _edits

torch.set_num_threads(2)


def _card_route_conv(x, role="column"):
    _, h, w, c = x.shape
    return h % 8 == 0 and w >= 8 and c >= 32, True


def _card_use_flash(q_seq, kv_seq, head_dim, has_mask):
    return (not has_mask and kv_seq % 128 == 0 and q_seq >= 1024
            and kv_seq >= 1024)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def test_toy_256_int8_move_edit_matches_jax(monkeypatch):
    edit = _edits(256)["move"]
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt_256")
    monkeypatch.setattr(jres, "_route_conv", _card_route_conv)
    monkeypatch.setattr(jattn, "_use_flash", _card_use_flash)
    jattn.set_attention_backend("interpret", qk_int8=True, int8_global_k=True)
    jconv.set_conv_int8(True)
    try:
        want = jpipe(**edit).images
        nudged = jpipe(**dict(edit, latents=np.nextafter(
            edit["latents"], np.float32(np.inf)))).images
    finally:
        jattn.set_attention_backend("auto", qk_int8=False,
                                    int8_global_k=False)
        jconv.set_conv_int8(False)

    tpipe, _ = ttoy.load_toy("assets/toy_ckpt_256", device="cpu")
    calls = [_spy(monkeypatch, tconv, "conv3x3_int8_reference"),
             _spy(monkeypatch, tfa, "flash_attention_int8_reference")]
    with tbench.int8_everything():
        got = tpipe(**edit).images
    assert got.shape == want.shape == (1, 256, 256, 3)
    assert np.isfinite(got).all()
    assert all(calls), [len(c) for c in calls]
    floor = _psnr(nudged, want)  # the JAX int8 edit against itself
    print(f"int8 toy-256 move edit: port vs JAX {_psnr(got, want):.2f} dB; "
          f"JAX vs JAX with one-ulp latents {floor:.2f} dB")
    assert _psnr(got, want) >= min(50.0, floor - 1.0), (_psnr(got, want),
                                                       floor)
