"""``blobctrl_torch.utils.threefry`` against ``jax.random`` (threefry2x32,
x64 off, partitionable): key data, ``fold_in``, ``split``, ``random_bits``,
``uniform`` and ``randint`` bit-equal; ``normal`` within 4 ulp (bit-equal
on every draw here, 0 of 299,388 elements differ); a block of rows drawn
alone equal to that block of the whole draw; R keys drawing R rows as
``jax.vmap`` does; the uniform's multiply-add rounded once at float32
ties, against exact rationals. About 10 s, most of it JAX's compiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blobctrl_torch.utils import threefry as tf

SEEDS = [0, 1, 42, 1248464818, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, -1,
         12345678901]
SHAPES = [(), (5,), (2, 5, 7), (1, 64, 64, 4)]
BOUND = 1 / np.sqrt(320)   # an init-like uniform bound, not a power of two


def jkey(seed):
    return jax.random.PRNGKey(seed)


def ulps(a, b):
    """|a - b| in float32 units in the last place (ordered bit patterns)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data(seed):
    want = np.asarray(jax.random.key_data(jkey(seed)))
    np.testing.assert_array_equal(tf.key(seed), want)
    assert tf.key(seed).dtype == torch.int64


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_fold_in_and_split(seed):
    k, jk = tf.key(seed), jkey(seed)
    for data in (0, 1, 0x5DE, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            tf.fold_in(k, data), np.asarray(jax.random.fold_in(jk, data)))
    for num in (2, 3, 64):
        np.testing.assert_array_equal(
            tf.split(k, num), np.asarray(jax.random.split(jk, num)))
    # a chain, as the pipeline and the trainers build them
    a, b = tf.split(tf.fold_in(k, 3))
    ja, jb = jax.random.split(jax.random.fold_in(jk, 3))
    np.testing.assert_array_equal(tf.fold_in(b, 9),
                                  np.asarray(jax.random.fold_in(jb, 9)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_and_randint_are_bit_equal(shape):
    for seed in (0, 1248464818):
        k, jk = tf.key(seed), jkey(seed)
        np.testing.assert_array_equal(
            tf.random_bits(k, shape),
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
        for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-BOUND, BOUND)):
            got = tf.uniform(k, shape, lo, hi)
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            want = np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                                 lo, hi))
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          want.view(np.uint32))
        for lo, hi in ((0, 1000), (-5, 7), (3, 3), (9, 2),
                       (-2 ** 31, 2 ** 31 - 1), (-2 ** 31, 0)):
            got = tf.randint(k, shape, lo, hi)
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            np.testing.assert_array_equal(got.numpy(), want)


def test_randint_on_many_seeds():
    for seed in range(50):
        np.testing.assert_array_equal(
            tf.randint(tf.key(seed), (8,), 0, 1000).numpy(),
            np.asarray(jax.random.randint(jkey(seed), (8,), 0, 1000)))


def test_uniform_at_an_init_bound_on_many_seeds():
    for seed in range(10):
        got = tf.uniform(tf.key(seed), (64, 320), -BOUND, BOUND).numpy()
        want = np.asarray(jax.random.uniform(jkey(seed), (64, 320),
                                             jnp.float32, -BOUND, BOUND))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_normal_within_4_ulp():
    n = same = 0
    for seed, shape in [(s, sh) for s in SEEDS[:5] for sh in SHAPES] + [
            (s, (4, 64, 64, 4)) for s in (3, 7, 11)] + [(5, (64, 320))]:
        got = tf.normal(tf.key(seed), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        want = np.asarray(jax.random.normal(jkey(seed), shape, jnp.float32))
        d = ulps(got.numpy(), want)
        assert d.max(initial=0) <= 4, (seed, shape, d.max())
        n += d.size
        same += int((d == 0).sum())
    assert n == 299388
    assert same == n   # bit-equal on every element of these draws


@pytest.mark.parametrize("rows", [range(0, 1), range(1, 3), range(3, 4),
                                  range(0, 4), range(2, 2)])
def test_rows_are_slices_of_the_whole_draw(rows):
    k = tf.fold_in(tf.key(1248464818), 0x5DE)
    shape = (4, 8, 8, 4)
    sl = slice(rows.start, rows.stop)
    np.testing.assert_array_equal(tf.random_bits(k, shape, rows),
                                  tf.random_bits(k, shape)[sl])
    assert torch.equal(tf.normal(k, shape, rows), tf.normal(k, shape)[sl])
    assert torch.equal(tf.uniform(k, shape, -2.0, 3.0, rows),
                       tf.uniform(k, shape, -2.0, 3.0)[sl])
    assert torch.equal(tf.randint(k, (4,), 0, 1000, rows),
                       tf.randint(k, (4,), 0, 1000)[sl])


def test_randint_refuses_bounds_outside_int32():
    for lo, hi in ((0, 2 ** 31), (-2 ** 31 - 1, 0)):
        with pytest.raises(OverflowError):
            tf.randint(tf.key(0), (2,), lo, hi)
        with pytest.raises(OverflowError):
            jax.random.randint(jkey(0), (2,), lo, hi)


def test_rows_outside_the_leading_axis_are_refused():
    for rows in (range(2, 6), range(0, 4, 2)):
        with pytest.raises(ValueError, match="not a block"):
            tf.normal(tf.key(0), (4, 3), rows)
    with pytest.raises(ValueError, match="not a block"):
        tf.normal(tf.key(0), (), range(0, 1))


def test_draws_land_on_the_device_asked_for():
    got = tf.normal(tf.key(2), (3, 2), device="meta")
    assert got.device.type == "meta" and got.dtype == torch.float32
    assert tf.randint(tf.key(2), (3,), 0, 9).dtype == torch.int64


def test_many_keys_draw_as_vmap_draws():
    """R keys (R, 2) at once: row r is key r's draw, as ``jax.vmap`` over
    the keys gives it (``edit_batch``'s rows, each at the solo shape)."""
    seeds = [3, 1248464818, 2 ** 32 - 1]
    keys = torch.stack([tf.key(s) for s in seeds])
    jkeys = jnp.stack([jkey(s) for s in seeds])
    shape = (1, 8, 8, 4)
    vkeys = tf.fold_in(keys, 0x5DE)
    np.testing.assert_array_equal(
        vkeys, np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 0x5DE))(
            jkeys)))
    got = tf.normal(vkeys, shape)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, 0x5DE), shape))(jkeys))
    assert tuple(got.shape) == (3,) + shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    for r, s in enumerate(seeds):
        assert torch.equal(got[r], tf.normal(tf.fold_in(tf.key(s), 0x5DE),
                                             shape))
        assert torch.equal(tf.randint(keys, (5,), 0, 1000)[r],
                           tf.randint(tf.key(s), (5,), 0, 1000))


def _rn32(exact):
    """The float32 nearest the Fraction ``exact``, ties to even."""
    from fractions import Fraction
    r = np.float32(float(exact))
    cands = [r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                     int(np.array(x).view(np.uint32)) & 1))


def test_uniform_multiply_add_rounds_once_on_float32_ties():
    """``_fma32`` (the uniform's scale and shift) where the float64 sum is
    inexact and lands on a float32 tie, which rounding the float64 sum
    again gets wrong: c odd in its last place, a * b just under half its
    ulp, either sign. Against exact rational arithmetic."""
    from fractions import Fraction
    b = np.float32(1 - 2.0 ** -15)
    cases = []
    for k in range(1, 400, 2):
        for e in (-3, 0, 7):
            c = np.float32((1 + k * 2.0 ** -23) * 2.0 ** e)
            for sa in (1, -1):
                for sc in (1, -1):
                    a = np.float32(sa * float(np.spacing(c)) / 2
                                   * (1 + 2.0 ** -15))
                    cases.append((a, np.float32(sc * c)))
    a = torch.tensor([x[0] for x in cases])
    wrong = 0
    for i, (ai, ci) in enumerate(cases):
        got = tf._fma32(a[i:i + 1], float(b), float(ci)).item()
        want = _rn32(Fraction(float(ai)) * Fraction(float(b))
                     + Fraction(float(ci)))
        assert np.float32(got) == want, (ai, ci, got, want)
        wrong += np.float32(float(ai) * float(b) + float(ci)) != want
    assert wrong == len(cases) == 2400   # every case defeats double rounding
