"""The int8-everything edit sharded over two model ranks on the CPU, against
the JAX package's SHARDED int8 edit, fp32, on the trained 256^2 toy
checkpoint (the move edit of ``test_torch_pipeline``, 6 UniPC steps).

In the int8 modes the int8 flash's global k scale is taken over the heads a
call sees: the local heads, inside JAX's shard_map body and in the port's
call on its local q, k, v. So the reference is JAX's edit under
``shard_to_mesh(model_parallel=True)`` on two of the conftest's virtual CPU
devices, its Pallas kernels in interpret mode under the rule the JAX
package applies on its card (``_route_conv`` on the channels a device
sees, ``_use_flash`` on the sequences), as ``test_torch_int8_pipeline``
runs it unsharded; nothing in the JAX package changes. The bar is that
file's: as close as JAX's sharded int8 edit is to itself with its initial
latents moved by one ulp, less 1 dB, and never more than 50 dB needed.
Every rank must hold the same image, have launched the int8 flash on one
local head (of the toy's two) and the int8 conv at local channels, and
logged the derived collective count."""

import numpy as np
import torch

from blobctrl_tpu.nn import attention as jattn
from blobctrl_tpu.nn import resnet as jres
from blobctrl_tpu.ops import conv3x3 as jconv
from blobctrl_tpu.parallel import kernel_sharding as jks
from blobctrl_tpu.parallel import mesh as jmesh
from blobctrl_tpu.train import toy as jtoy
from blobctrl_torch.parallel import collectives
from blobctrl_torch.train import toy as ttoy
from tests import torch_ranks
from tests.test_torch_int8_pipeline import _card_use_flash, _psnr
from tests.test_torch_pipeline import _edits

torch.set_num_threads(2)


def _card_route_conv_local(x, role="column"):
    """The JAX package's card rule on the channels this device sees."""
    _, h, w, _ = x.shape
    return (h % 8 == 0 and w >= 8
            and jks.local_channels(x, role) >= 32), True


def test_toy_256_int8_edit_at_model_2_matches_jax_sharded(monkeypatch):
    edit = _edits(256)["move"]
    jpipe, _ = jtoy.load_toy("assets/toy_ckpt_256")
    jpipe.shard_to_mesh(jmesh.make_mesh(data=1, model=2),
                        model_parallel=True)
    monkeypatch.setattr(jres, "_route_conv", _card_route_conv_local)
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

    shape = {"data": 1, "model": 2}
    res = torch_ranks.run_ranks(torch_ranks.edit_rank, 2, shape, "256",
                                "__call__", edit, "model", ("int8",))
    floor = _psnr(nudged, want)  # JAX's sharded int8 edit against itself
    cfgs = ttoy.toy_configs(size=256)
    expected = collectives.expected_counts(*cfgs, shape, "model", 6)
    for rank, r in enumerate(res):
        got = r["images"]
        assert got.shape == want.shape == (1, 256, 256, 3)
        assert np.array_equal(got, res[0]["images"])
        print(f"rank {rank}: port vs JAX sharded int8 {_psnr(got, want):.2f}"
              f" dB; JAX vs JAX with one-ulp latents {floor:.2f} dB")
        assert _psnr(got, want) >= min(50.0, floor - 1.0), (
            _psnr(got, want), floor)
        assert r["counts"] == expected, (r["counts"], expected)
        # the toy's 2 heads over 2 ranks: one local head a call (B*H = 2
        # for the CFG pair, 1 for BlobNet); int8 convs at local channels
        assert r["shapes"]["flash_int8"]
        assert {q[0] for q, _ in r["shapes"]["flash_int8"]} <= {1, 2}
        assert {q[0] for q, _ in r["shapes"]["flash_int8"]} >= {1}
        assert any(w[3] in (16, 32, 48) for _, w in
                   r["shapes"]["conv3x3_int8"])
