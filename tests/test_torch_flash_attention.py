"""The port's flash attention (plain version and the wrapper's CPU route)
against the JAX package's Pallas kernel in interpret mode, fp32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blobctrl_tpu.ops import flash_attention as jfa
from blobctrl_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

CASES = [(1, 2, 256, 40), (2, 2, 512, 64), (1, 1, 384, 80),
         (1, 2, 128, 160), (1, 2, 256, 16)]


def _qkv(b, h, s, d, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("fixed_max", [20.0, None])
@pytest.mark.parametrize("b,h,s,d", CASES)
def test_flash_matches_pallas_interpret(b, h, s, d, fixed_max):
    q, k, v = _qkv(b, h, s, d)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        block_q=128, block_kv=128, interpret=True, fixed_max=fixed_max))

    def flat(x):
        return torch.from_numpy(x.reshape(b * h, s, d))

    before = tfa.launches
    got = tfa.flash_attention(flat(q), flat(k), flat(v), scale,
                              fixed_max=fixed_max)
    ref = tfa.flash_attention_reference(flat(q), flat(k), flat(v), scale)
    assert tfa.launches == before  # the CPU route launches no kernel
    # the JAX package's own tolerance for its kernel (test_flash_attention)
    for out in (got, ref):
        np.testing.assert_allclose(out.numpy().reshape(b, h, s, d), want,
                                   atol=1e-5, rtol=1e-4)
