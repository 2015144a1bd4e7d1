"""The port's threefry keys and samplers equal ``jax.random`` bit for bit
under the non-partitionable scheme the goldens were frozen under."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as jengines
from repro.core import lattice as jlattice
from repro_torch.core import engines, lattice, threefry

SEEDS = [0, 11, 2 ** 31 + 5, -7]
SHAPES = [(1,), (2,), (7,), (16, 16), (3, 5, 2)]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_key_data(seed):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.key_data(_jkey(seed)))
    got = threefry.key_data(threefry.PRNGKey(seed)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split(seed, num):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.split(_jkey(seed), num))
    np.testing.assert_array_equal(
        threefry.split(threefry.PRNGKey(seed), num).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 12345, 2 ** 32 - 1])
def test_fold_in(seed, data):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.fold_in(_jkey(seed), data))
    np.testing.assert_array_equal(
        threefry.fold_in(threefry.PRNGKey(seed), data).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_uniform(seed, shape):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.uniform(_jkey(seed), shape))
    got = threefry.uniform(threefry.PRNGKey(seed), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0, 2), (1, 6), (-5, 2 ** 31 - 1),
                                   (3, 3), (0, 70_000)])
def test_randint_scalar_bounds(shape, lo, hi):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.randint(_jkey(9), shape, lo, hi))
    got = threefry.randint(threefry.PRNGKey(9), shape, lo, hi).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("maxval", [(8, 32), (8, 8), (3, 100_000)])
def test_randint_array_maxval(maxval):
    """The torus-shift draw: one value per axis, each with its own span."""
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.randint(
            _jkey(4), (2,), 0, jnp.array(maxval), dtype=jnp.int32))
    got = threefry.randint(threefry.PRNGKey(4), (2,), 0,
                           torch.tensor(maxval)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("empty", [0.0, 0.1])
def test_init_grid(dtype, empty):
    with jax.threefry_partitionable(False):
        want = np.asarray(jlattice.init_grid(
            _jkey(5), 24, 40, 5, empty, dtype=jnp.dtype(dtype)))
    got = lattice.init_grid(threefry.PRNGKey(5), 24, 40, 5, empty,
                            dtype=getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile", [(8, 16), (8, 32)])
def test_multi_round_inputs(tile):
    """The host key chain of a chunk equals the reference's K-step
    schedule (seed words, shifts and the key after it)."""
    with jax.threefry_partitionable(False):
        jk, jseeds, jshifts = jengines.multi_round_inputs(_jkey(21), *tile,
                                                          6)
    key, seeds, shifts = engines.multi_round_inputs(threefry.PRNGKey(21),
                                                    *tile, 6)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(jseeds))
    np.testing.assert_array_equal(shifts.numpy(), np.asarray(jshifts))
