"""The four host helpers of the port's ``blob/math.py`` against the JAX
package's: ``rotation_matrix``, ``gaussian_to_ellipse`` and
``ellipse_from_normalized_gaussian`` bit-equal in float64 over seeded
ellipses (round trips through ``ellipse_to_gaussian`` included), the
near-degenerate covariance ``[[1, e], [-e, 1]]`` real and warning-free on
its own, and ``pyramid_resize`` (the port's ``nn.layers.bilinear_resize``,
NHWC on the tensor's device) against JAX's within fp32 rounding."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_tpu.blob import math as jmath
from blobctrl_torch.blob import math as tmath


def _ellipses(seed, n=40):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        d1, d2 = sorted(rs.uniform(1, 300, 2))
        yield ((float(rs.uniform(0, 512)), float(rs.uniform(0, 512))),
               (float(d1), float(d2)), float(rs.uniform(0, 180)))


def test_rotation_matrix_bit_equal():
    for theta in np.random.RandomState(0).uniform(-7, 7, 20):
        np.testing.assert_array_equal(tmath.rotation_matrix(theta),
                                      jmath.rotation_matrix(theta))


def test_gaussian_to_ellipse_bit_equal_and_round_trip():
    for e in _ellipses(1):
        mean, cov = tmath.gaussian_from_ellipse(e)
        got = tmath.gaussian_to_ellipse(mean, cov)
        assert got == jmath.gaussian_to_ellipse(mean, cov)
        x, y, a, b, _ = got
        assert (x, y) == e[0]
        np.testing.assert_allclose((2 * a, 2 * b), e[1], rtol=1e-9)


def test_ellipse_from_normalized_gaussian_bit_equal():
    for w, h in ((512, 512), (640, 480)):
        for e in _ellipses(2):
            mean, cov = tmath.gaussian_from_ellipse(e)
            nm, nc = tmath.normalize_gaussian(mean, cov, w, h)
            assert tmath.ellipse_from_normalized_gaussian(nm, nc, w, h) == \
                jmath.ellipse_from_normalized_gaussian(nm, nc, w, h)


def test_gaussian_to_ellipse_near_degenerate_cov_stays_real():
    cov = np.array([[1.0, 1e-8], [-1e-8, 1.0]])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tmath.gaussian_to_ellipse(np.zeros(2), cov)
    assert got == jmath.gaussian_to_ellipse(np.zeros(2), cov)
    for v in got:
        assert isinstance(v, float) and np.isfinite(v)
    assert abs(got[2] - 1.0) < 1e-6 and abs(got[3] - 1.0) < 1e-6


@pytest.mark.parametrize("size,cutoff", [(64, 16), (48, 8), (32, 32)])
def test_pyramid_resize_matches_jax(size, cutoff):
    img = np.random.RandomState(size).rand(2, size, size, 3).astype(
        np.float32)
    got = tmath.pyramid_resize(torch.from_numpy(img), cutoff)
    want = jmath.pyramid_resize(jnp.asarray(img), cutoff)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-6, rtol=0)
