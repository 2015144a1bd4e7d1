"""``core.metrics`` of the port against ``repro.core.metrics`` on the same
seeded inputs: densities, survivors, alive species, stasis and the first
extinction MCS of a density history."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro_torch.core import metrics


def _grid(species, dtype, seed, shape=(24, 40)):
    rs = np.random.RandomState(seed)
    return rs.randint(0, species + 1, size=shape).astype(dtype)


@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("species", [3, 5, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_densities_and_survivors_match_the_reference(species, dtype, seed):
    g = _grid(species, dtype, seed)
    # a species wiped out, so that survivors has a False in it
    g[g == 2] = 0
    got_d = metrics.densities(torch.from_numpy(g), species)
    want_d = np.asarray(jmetrics.densities(jnp.asarray(g), species))
    assert got_d.dtype == torch.float32 and want_d.dtype == np.float32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    got_s = metrics.survivors(torch.from_numpy(g), species)
    want_s = np.asarray(jmetrics.survivors(jnp.asarray(g), species))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert not want_s[1]
    cnt = metrics.counts(torch.from_numpy(g), species)
    jcnt = jmetrics.counts(jnp.asarray(g), species)
    assert int(metrics.alive_species(cnt)) == int(
        jmetrics.alive_species(jcnt))
    assert bool(metrics.stasis(cnt)) == bool(jmetrics.stasis(jcnt))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("sp", [1, 2, 3])
def test_first_extinction_mcs_matches_the_reference(seed, sp):
    """Histories whose species die at random MCS, or never, or are absent
    from the start."""
    rs = np.random.RandomState(seed)
    hist = rs.rand(30, 4)
    for s in (1, 2, 3):
        die = rs.randint(-5, 30)
        if die >= 0:
            hist[die:, s] = 0.0
    assert metrics.first_extinction_mcs(hist, sp) == \
        jmetrics.first_extinction_mcs(hist, sp)
    assert metrics.first_extinction_mcs(hist.tolist(), sp) == \
        jmetrics.first_extinction_mcs(hist, sp)


def test_first_extinction_mcs_never_and_at_once():
    hist = np.ones((5, 3))
    assert metrics.first_extinction_mcs(hist, 1) == -1
    hist[:, 2] = 0.0
    assert metrics.first_extinction_mcs(hist, 2) == 0
