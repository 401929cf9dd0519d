"""The port's nn primitives, timestep embedding and blob math against
``blobctrl_tpu``, fp32 on the CPU, same seeded numpy inputs and params."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blobctrl_tpu.blob import math as jbm
from blobctrl_tpu.nn import embeddings as jemb
from blobctrl_tpu.nn import layers as jl
from blobctrl_tpu.utils import benchkit as jbench
from blobctrl_torch.blob import math as tbm
from blobctrl_torch.nn import embeddings as temb
from blobctrl_torch.nn import layers as tl
from blobctrl_torch.params.from_jax import from_jax
from blobctrl_torch.utils import benchkit as tbench

torch.set_num_threads(2)

RNG = np.random.RandomState(7)
# fp32, the same math in another summation order
TOL = dict(atol=1e-5, rtol=1e-5)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


def _params(tree):
    return tree, from_jax(tree, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_linear():
    p = {"kernel": RNG.randn(12, 20).astype(np.float32),
         "bias": RNG.randn(20).astype(np.float32)}
    (jx,), (tx,) = _both(RNG.randn(3, 5, 12).astype(np.float32))
    jp, tp = _params(p)
    _close(tl.linear(tp, tx), jl.linear(jp, jx))


@pytest.mark.parametrize("k,stride,padding", [
    (1, 1, 0), (3, 1, 1), (3, 2, 1), (3, 2, ((0, 1), (0, 1))), (3, 1, (1, 2))])
def test_conv2d(k, stride, padding):
    p = {"kernel": (RNG.randn(k, k, 6, 10) * 0.2).astype(np.float32),
         "bias": RNG.randn(10).astype(np.float32)}
    (jx,), (tx,) = _both(RNG.randn(2, 9, 12, 6).astype(np.float32))
    jp, tp = _params(p)
    _close(tl.conv2d(tp, tx, stride=stride, padding=padding),
           jl.conv2d(jp, jx, stride=stride, padding=padding))


def _norm_params(c):
    return {"scale": (1 + 0.2 * RNG.randn(c)).astype(np.float32),
            "bias": RNG.randn(c).astype(np.float32)}


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_and_scale_shift(eps):
    jp, tp = _params(_norm_params(16))
    (jx,), (tx,) = _both((3 + 2 * RNG.randn(2, 5, 7, 16)).astype(np.float32))
    _close(tl.group_norm(tp, tx, 4, eps), jl.group_norm(jp, jx, 4, eps))
    js, jsh = jl.group_norm_scale_shift(jp, jx, 4, eps)
    ts, tsh = tl.group_norm_scale_shift(tp, tx, 4, eps)
    _close(ts, js)
    _close(tsh, jsh)
    # the fold reproduces the norm: x * scale + shift == group_norm(x)
    _close(tx * ts[:, None, None] + tsh[:, None, None],
           jl.group_norm(jp, jx, 4, eps))


def test_layer_norm():
    jp, tp = _params(_norm_params(24))
    (jx,), (tx,) = _both(RNG.randn(2, 9, 24).astype(np.float32))
    _close(tl.layer_norm(tp, tx), jl.layer_norm(jp, jx))
    _close(tl.layer_norm(None, tx), jl.layer_norm(None, jx))


@pytest.mark.parametrize("name", ["silu", "gelu", "nearest_upsample_2x"])
def test_elementwise_and_resample(name):
    (jx,), (tx,) = _both(RNG.randn(2, 3, 5, 4).astype(np.float32) * 3)
    _close(getattr(tl, name)(tx), getattr(jl, name)(jx))


@pytest.mark.parametrize("flip,shift", [(True, 0.0), (False, 1.0)])
def test_timestep_embedding(flip, shift):
    t = np.array([0, 17, 999], np.float32)
    (jt,), (tt,) = _both(t)
    je = jemb.sinusoidal_timestep_embedding(jt, 32, flip, shift)
    te = temb.sinusoidal_timestep_embedding(tt, 32, flip, shift)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=2e-5)
    p = {"linear_1": {"kernel": RNG.randn(32, 48).astype(np.float32) * 0.2,
                      "bias": RNG.randn(48).astype(np.float32)},
         "linear_2": {"kernel": RNG.randn(48, 48).astype(np.float32) * 0.2,
                      "bias": RNG.randn(48).astype(np.float32)}}
    jp, tp = _params(p)
    _close(temb.timestep_embedding(tp, te), jemb.timestep_embedding(jp, je))


@pytest.mark.parametrize("ellipse", [((30.0, 40.0), (20.0, 36.0), 30.0),
                                     ((70.0, 20.0), (50.0, 52.0), 145.0)])
def test_blob_score_from_ellipse(ellipse):
    want = jbm.blob_score_from_ellipse(ellipse, 96, 128, (12, 16))
    got = tbm.blob_score_from_ellipse(ellipse, 96, 128, (12, 16))
    assert got.shape == (1, 12, 16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_multi_blob_scores_and_standard_inputs():
    ells = [((30.0, 40.0), (20.0, 36.0), 30.0),
            ((60.0, 50.0), (30.0, 40.0), 100.0)]
    np.testing.assert_allclose(
        tbm.blob_scores_from_ellipses(ells, 96, 96, (12, 12)).numpy(),
        np.asarray(jbm.blob_scores_from_ellipses(ells, 96, 96, (12, 12))),
        atol=1e-6)
    want, got = jbench.standard_edit_kwargs(64, 3), tbench.standard_edit_kwargs(64, 3)
    assert set(want) == set(got)
    for k, v in want.items():
        if isinstance(v, np.ndarray) or hasattr(v, "shape"):
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                       atol=1e-6, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("before", [True, False])
def test_strict_fp32_is_scoped_to_its_block(before):
    """TF32 is off inside the block for a CUDA device and both switches
    come back as they were, after an exception too; for the CPU the block
    changes nothing. Only torch's flags are touched, so no card is needed."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = before
        with tl.strict_fp32("cpu"):
            assert [f.allow_tf32 for f in flags] == [before, before]
        with pytest.raises(RuntimeError):
            with tl.strict_fp32("cuda"):
                assert [f.allow_tf32 for f in flags] == [False, False]
                raise RuntimeError
        assert [f.allow_tf32 for f in flags] == [before, before]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
