"""The blob splat (K9) of the port against the JAX package, on the CPU:
the op's plain version against the Pallas kernel in interpret mode and
against the pure-JAX splat, the view mode's plain version against the JAX
``blob_vis_image``, the blob view's shape routing, and the blob math
around it. Inputs are made with numpy
from a seed and handed to both sides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blobctrl_tpu.blob import math as jmath
from blobctrl_tpu.blob import viz as jviz
from blobctrl_tpu.ops import blob_splat as jsplat
from blobctrl_torch.blob import math as tmath
from blobctrl_torch.blob import viz as tviz
from blobctrl_torch.ops import blob_splat as tsplat

torch.set_num_threads(2)

# the cases of tests/test_blob_splat_kernel.py: one blob, a gated blob,
# a wide grid, and M = 11 (the TPU kernel's fori_loop path)
CASES = [(1, 1, (64, 128)), (2, 3, (128, 128)), (1, 5, (64, 256)),
         (1, 11, (64, 128))]


def random_blobs(n, m, seed=21):
    rng = np.random.RandomState(seed)
    xs = rng.uniform(0.2, 0.8, (n, m)).astype(np.float32)
    ys = rng.uniform(0.2, 0.8, (n, m)).astype(np.float32)
    covs = np.zeros((n, m, 2, 2), np.float32)
    for i in range(n):
        for j in range(m):
            _, c = jmath.ellipse_to_gaussian(
                0, 0, rng.uniform(0.05, 0.2), rng.uniform(0.05, 0.3),
                rng.uniform(0, np.pi))
            covs[i, j] = c
    sizes = np.ones((n, m), np.float32)
    if m >= 2:
        sizes[0, 1] = 0.0  # gated blob
    return xs, ys, covs, sizes


def _both(args):
    return ([jnp.asarray(a) for a in args], [torch.from_numpy(a) for a in args])


@pytest.mark.parametrize("n,m,hw", CASES)
def test_plain_matches_pallas_kernel_in_interpret_mode(n, m, hw):
    """atol 1e-6: the same fp32 operations in the same order; only the
    sigmoid's formulation differs, by an ulp."""
    j, t = _both(random_blobs(n, m))
    want = np.asarray(jsplat.splat_scores_pallas(*j, hw, interpret=True))
    got = tsplat.splat_scores(*t, hw).numpy()
    assert got.shape == want.shape == (n,) + hw + (m + 1,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# A fresh interpreter that imports the port, then makes its first parallel
# exp (8192 floats over two threads): the splat's plain version did so in
# its first case, and without the port's serial first call (blobctrl_torch/
# __init__.py) about one process in fifty got a second half ~1e-4 off.
FIRST_EXP = """
import numpy as np, torch
import blobctrl_torch
torch.set_num_threads(2)
x = torch.linspace(0.5, 6.0, 8192, dtype=torch.float32)
want = np.exp(x.double().numpy()).astype(np.float32).view(np.int32)
print(int(np.abs(torch.exp(x).numpy().view(np.int32) - want).max()))
"""


def test_first_parallel_exp_after_the_port_import_is_accurate():
    """32 fresh processes, 8 at a time: every one within 1 ulp of the
    correctly rounded exp (MKL's accurate mode), where the race put
    thousands of ulps into half of the tensor."""
    import os
    import pathlib
    import subprocess
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    ulps = []
    for _ in range(4):
        procs = [subprocess.Popen([sys.executable, "-c", FIRST_EXP], cwd=root,
                                  env=env, stdout=subprocess.PIPE, text=True)
                 for _ in range(8)]
        for proc in procs:
            out, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0
            ulps.append(int(out.split()[-1]))
    assert max(ulps) <= 1, ulps


@pytest.mark.parametrize("n,m,hw", CASES)
def test_plain_matches_jax_splat(n, m, hw):
    """atol 1e-5: the pure-JAX splat divides by W and H where the kernel
    multiplies by their fp32 reciprocals, and composites by a cumprod."""
    j, t = _both(random_blobs(n, m))
    want = np.asarray(jmath.splat_scores(*j, hw))
    np.testing.assert_allclose(tsplat.splat_scores(*t, hw).numpy(), want,
                               atol=1e-5, rtol=0)
    # the port's own pure splat, the route below the kernel's shapes
    np.testing.assert_allclose(tmath.splat_scores(*t, hw).numpy(), want,
                               atol=1e-5, rtol=0)


def test_params_rows_match_the_pallas_wrapper():
    """The rows the kernel reads, built in plain torch as the JAX wrapper
    builds them in XLA: bit-equal."""
    xs, ys, covs, sizes = random_blobs(2, 3)
    h, w = 64, 128
    cov = covs.astype(np.float32)
    a, b, c, d = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 0], cov[..., 1, 1]
    det = a * d - b * c
    want = np.stack([xs * np.float32(w), ys * np.float32(h), d / det,
                     -(b + c) / det, a / det,
                     (sizes >= 0.5).astype(np.float32), 0 * a, 0 * a], -1)
    got = tsplat.splat_params(*[torch.from_numpy(v) for v in
                                (xs, ys, covs, sizes)], (h, w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_routing_by_shape(monkeypatch):
    """``blob_vis_image`` reaches the view op at 512^2 (h*w >= 128^2, w %
    128 == 0) and not at 64^2; on the CPU the op takes its plain version
    and launches nothing."""
    calls = []
    real = tsplat.blob_view

    def spy(*a, **k):
        calls.append(a[4])
        return real(*a, **k)

    monkeypatch.setattr(tsplat, "blob_view", spy)
    xs, ys, covs, sizes = random_blobs(1, 1)
    before = tsplat.launches
    out = tviz.blob_vis_image(xs, ys, covs, sizes, (512, 512), device="cpu")
    assert out.shape == (512, 512, 3) and calls == [(512, 512)]
    tviz.blob_vis_image(xs, ys, covs, sizes, (64, 64), device="cpu")
    tviz.blob_vis_image(xs, ys, covs, sizes, (128, 200), device="cpu")
    assert calls == [(512, 512)]
    assert tsplat.launches == before


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: here, with no
    card, asking for the kernel raises instead of falling back."""
    from blobctrl_torch.ops import _build

    def no_kernel(name):
        raise RuntimeError(f"no kernel {name}")

    monkeypatch.setattr(_build, "entry", no_kernel)
    t = [torch.from_numpy(a).to("meta") for a in random_blobs(1, 2)]
    with pytest.raises((RuntimeError, ValueError)):
        tsplat.splat_scores(*t, (128, 128))


@pytest.mark.parametrize("size", [None, 32])
def test_splat_features_from_scores(size):
    rng = np.random.RandomState(3)
    scores = rng.rand(2, 16, 16, 3).astype(np.float32)
    feats = rng.randn(2, 3, 5).astype(np.float32)
    want = np.asarray(jmath.splat_features_from_scores(
        jnp.asarray(scores), jnp.asarray(feats), size))
    got = tmath.splat_features_from_scores(
        torch.from_numpy(scores), torch.from_numpy(feats), size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_removal_score():
    np.testing.assert_array_equal(tmath.removal_score((8, 6)).numpy(),
                                  np.asarray(jmath.removal_score((8, 6))))


@pytest.mark.parametrize("hw,m", [((512, 512), 1), ((256, 384), 2),
                                  ((64, 96), 3)])
def test_blob_vis_image_matches_jax(hw, m):
    """uint8 views: <= 1 level (the float truncation to uint8 can flip
    where the two sides round an ulp apart), equal almost everywhere."""
    xs, ys, covs, sizes = random_blobs(1, m, seed=4)
    sizes[:] = 1.0
    want = jviz.blob_vis_image(xs, ys, covs, sizes, hw)
    got = tviz.blob_vis_image(xs, ys, covs, sizes, hw, device="cpu")
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape == hw + (3,)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_blob_vis_from_ellipse_matches_jax():
    e = ((300.0, 200.0), (120.0, 260.0), 35.0)
    want = jviz.blob_vis_from_ellipse(e, 512, 512)
    got = tviz.blob_vis_from_ellipse(e, 512, 512, device="cpu")
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# the view mode: (hw, m, gated); M = 5 gates its second blob
VIEW_CASES = [((512, 512), 1, False), ((256, 384), 2, False),
              ((128, 256), 5, True)]


def _view_inputs(m, gated, seed=8):
    xs, ys, covs, sizes = random_blobs(1, m, seed=seed)
    if not gated:
        sizes[:] = 1.0
    colors = tviz.default_palette()[:m + 1]
    return xs, ys, covs, sizes, colors


@pytest.mark.parametrize("hw,m,gated", VIEW_CASES)
def test_blob_view_plain_matches_jax(hw, m, gated):
    """The view's plain version (rows, scores back to front, the colour sum
    over channels M..0, clamp, x255, truncation) against the JAX
    ``blob_vis_image``: <= 1 uint8 level, equal at >= 99.9 % of pixels (the
    two sides sum the colours in different orders, so a truncation can
    flip where they round an ulp apart)."""
    xs, ys, covs, sizes, colors = _view_inputs(m, gated)
    want = jviz.blob_vis_image(xs, ys, covs, sizes, hw)
    got = tsplat.blob_view_plain(*[torch.from_numpy(a) for a in
                                   (xs, ys, covs, sizes)], hw,
                                 torch.from_numpy(colors)).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.dtype == np.uint8 and got.shape == want.shape == hw + (3,)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def _rows_in_kernel_order(xs, ys, covs, sizes, h, w):
    """The kernel's prologue, operation by operation in numpy fp32 (IEEE
    rounding, no fused multiply-add): det = a*d - b*c, then true
    divisions."""
    f = np.float32
    a, b, c, d = (covs[..., i, j] for i, j in ((0, 0), (0, 1), (1, 0),
                                              (1, 1)))
    det = a * d - b * c
    zero = np.zeros_like(a)
    return np.stack([xs * f(w), ys * f(h), d / det, -(b + c) / det, a / det,
                     (sizes >= f(0.5)).astype(f), zero, zero], -1)


@pytest.mark.parametrize("n,m,hw", CASES + [(1, 1100, (16, 16))])
def test_splat_rows_bit_equal_to_splat_params(n, m, hw):
    """The rows entry (on the CPU ``splat_params``) bit-equal to the
    kernel's prologue in its order of operations, a gated blob and more
    blobs than one shared-memory chunk included."""
    xs, ys, covs, sizes = random_blobs(n, m, seed=m)
    got = tsplat.splat_rows(*[torch.from_numpy(a) for a in
                              (xs, ys, covs, sizes)], hw).numpy()
    want = _rows_in_kernel_order(xs, ys, covs, sizes, *hw)
    assert got.dtype == np.float32 and got.shape == (n, m, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(512, 512), (1024, 1024), (256, 384),
                                (128, 256), (128, 128), (64, 256), (64, 64),
                                (128, 200), (200, 128), (96, 96)])
def test_view_routing_matches_jax(monkeypatch, hw):
    """The blob view takes the view op exactly where the JAX package takes
    its Pallas splat on a TPU (h*w >= 128^2 and w % 128 == 0); elsewhere
    both take their pure splat. The JAX side runs with its backend
    reported as a TPU and the Pallas call replaced by a spy."""
    from blobctrl_tpu.blob import math as jblob_math
    jax_calls, port_calls = [], []

    def jax_spy(*a, **k):
        jax_calls.append(a[4])
        return jblob_math.splat_scores(*a[:5])

    real = tsplat.blob_view

    def port_spy(*a, **k):
        port_calls.append(a[4])
        return real(*a, **k)

    monkeypatch.setattr(jsplat.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jsplat, "splat_scores_pallas", jax_spy)
    monkeypatch.setattr(tsplat, "blob_view", port_spy)
    xs, ys, covs, sizes = random_blobs(1, 1, seed=2)
    want = jviz.blob_vis_image(xs, ys, covs, sizes, hw)
    got = tviz.blob_vis_image(xs, ys, covs, sizes, hw, device="cpu")
    assert port_calls == jax_calls
    assert bool(port_calls) == (hw[0] * hw[1] >= 128 * 128
                                and hw[1] % 128 == 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cuda_tensor_never_reaches_blob_view_plain(monkeypatch):
    """A tensor that is not on the CPU goes to the view kernel: here, with
    no card, asking for it raises, and the plain version is never run."""
    from blobctrl_torch.ops import _build

    def no_kernel(name):
        raise RuntimeError(f"no kernel {name}")

    plain = []
    monkeypatch.setattr(_build, "entry", no_kernel)
    monkeypatch.setattr(tsplat, "blob_view_plain",
                        lambda *a, **k: plain.append(a))
    xs, ys, covs, sizes, colors = _view_inputs(2, False)
    t = [torch.from_numpy(a).to("meta") for a in (xs, ys, covs, sizes)]
    with pytest.raises((RuntimeError, ValueError)):
        tsplat.blob_view(*t, (128, 128), torch.from_numpy(colors).to("meta"))
    assert plain == []
