"""The port's sequential engine (``reference``, E1) and what it is built
from, against the JAX package: neighbour indexing under both boundary
rules, ``proposal_batch`` and the large-span ``randint`` it needs, the
pair rule's plain-Python oracle, ``reference.run_proposals`` (the plain
version of kernel S1) and ``simulate`` on the reference golden.

Inputs are made from numpy seeds and handed to both packages; every
comparison is exact, under ``jax.threefry_partitionable(False)`` as a
context manager.
"""
import hashlib
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lattice as jlattice
from repro.core import reference as jreference
from repro.core import rng as jrng
from repro.core import rules as jrules
from repro.core import scenarios as jscenarios
from repro.core.rng import ProposalBatch as JaxBatch
from repro.core.simulation import simulate as jsimulate
from repro_torch.core import dominance, lattice, reference, rng, rules
from repro_torch.core import threefry
from repro_torch.core.rng import ProposalBatch
from repro_torch.core.scenarios import (EngineConfig, RunConfig,
                                        make_scenario)
from repro_torch.core.simulation import simulate
from repro_torch.kernels import reference_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "reference_trajectory.json")


def _grid_hash(grid) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(grid).astype("<i4")).tobytes()).hexdigest()


def _key(seed):
    return np.random.RandomState(seed).randint(
        0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ------------------------------ lattice ---------------------------------- #

@pytest.mark.parametrize("flux", [True, False])
@pytest.mark.parametrize("nbhd", [4, 8])
@pytest.mark.parametrize("hw", [(12, 20), (7, 3)])
def test_neighbor_index_every_cell_and_direction(flux, nbhd, hw):
    h, w = hw
    cells, dirs = np.meshgrid(np.arange(h * w), np.arange(nbhd))
    cells = cells.reshape(-1).astype(np.int32)
    dirs = dirs.reshape(-1).astype(np.int32)
    want = np.asarray(jlattice.neighbor_index(
        jnp.asarray(cells), jnp.asarray(dirs), h, w, flux))
    got = lattice.neighbor_index(torch.from_numpy(cells),
                                 torch.from_numpy(dirs), h, w, flux)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    wr, wc = jlattice.neighbor_rc(jnp.asarray(cells // w),
                                  jnp.asarray(cells % w), jnp.asarray(dirs),
                                  h, w, flux)
    gr, gc = lattice.neighbor_rc(torch.from_numpy(cells // w),
                                 torch.from_numpy(cells % w),
                                 torch.from_numpy(dirs), h, w, flux)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("species", [3, 5])
def test_densities_match_reference(species):
    grid = np.random.RandomState(species).randint(
        0, species + 1, size=(12, 20)).astype(np.int32)
    want = np.asarray(jlattice.densities(jnp.asarray(grid), species))
    got = lattice.densities(torch.from_numpy(grid), species)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------- proposal draws ------------------------------ #

@pytest.mark.parametrize("n", [1, 999, 4096])
@pytest.mark.parametrize("span", [240, 65_537, 10_240_000])
def test_randint_with_a_large_span(n, span):
    """``randint``'s span/multiplier fold for spans past 2^16, where the
    multiplier wraps to 0, and odd sizes."""
    key = _key(span + n)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.randint(jnp.asarray(key), (n,), 0,
                                             span, jnp.int32))
    got = threefry.randint(_t(key), (n,), 0, span)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,n_cells,nbhd", [
    (1, 144, 4), (7, 240, 8), (144, 144, 4), (4097, 4096, 8),
    (1001, 10_240_000, 4), (18, 144, 8)])
def test_proposal_batch_matches_reference(n, n_cells, nbhd):
    key = _key(n)
    with jax.threefry_partitionable(False):
        want = jrng.proposal_batch(jnp.asarray(key), n, n_cells, nbhd)
    got = rng.proposal_batch(_t(key), n, n_cells, nbhd)
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == (n,) and g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_proposal_batch_draws_on_the_named_device():
    """A host key's splits stay on the host while the draws land on the
    device named (the engines' way of keeping the key chain off the
    card)."""
    props = rng.proposal_batch(threefry.PRNGKey(3), 5, 100, 4,
                               device="meta")
    assert all(f.device.type == "meta" and f.shape == (5,) for f in props)


# ------------------------------ the rule --------------------------------- #

def test_apply_pair_reference_matches_reference():
    dom = dominance.park_alliance_network(0.3, 0.7, 0.45)
    n_lab = dom.shape[0]
    u = [0.0, 0.1, 0.2999, 0.3, 0.45, 0.7, 0.99]
    for s, n, ua, ud in itertools.product(range(n_lab), range(n_lab), u, u):
        want = jrules.apply_pair_reference(s, n, ua, ud, 0.2, 0.6, dom)
        got = rules.apply_pair_reference(s, n, ua, ud, 0.2, 0.6, dom)
        assert got == want, (s, n, ua, ud)


# ------------------------- the sequential scan --------------------------- #

def _dom_probabilistic(species, seed):
    """A padded dominance matrix with float32 rates below 1/2, so that
    ``p1 + p2`` rounds in float32."""
    d = np.zeros((species + 1, species + 1), np.float32)
    d[1:, 1:] = np.random.RandomState(seed).uniform(
        0, 0.5, (species, species)).astype(np.float32)
    np.fill_diagonal(d, 0)
    return d


def _inputs(seed, h, w, species, b, nbhd, dom):
    """A numpy-seeded lattice and (B,) proposals; a third of the
    dominance draws sit exactly on ``p1`` or the float32 ``p1 + p2`` of
    their pair, where the rounding of the sum decides."""
    r = np.random.RandomState(seed)
    grid = r.randint(0, species + 1, size=(h, w)).astype(np.int32)
    cell = r.randint(0, h * w, b).astype(np.int32)
    dirn = r.randint(0, nbhd, b).astype(np.int32)
    u_act = r.uniform(0, 1, b).astype(np.float32)
    u_dom = r.uniform(0, 1, b).astype(np.float32)
    s, nb = r.randint(0, species + 1, b), r.randint(0, species + 1, b)
    on_edge = np.where(r.randint(0, 2, b) == 1, dom[s, nb],
                       dom[s, nb] + dom[nb, s])
    u_dom = np.where(r.randint(0, 3, b) == 0, on_edge, u_dom)
    return grid, (cell, dirn, u_act, u_dom.astype(np.float32))


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("flux", [True, False])
@pytest.mark.parametrize("nbhd", [4, 8])
@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_run_proposals_matches_reference(drop, flux, nbhd, dtype):
    """The plain version of S1 (the scan on the CPU) equals the
    reference's ``lax.scan``: lattice and applied count."""
    species, h, w, b = 4, 12, 20, 600
    dom = _dom_probabilistic(species, nbhd)
    grid, props = _inputs(nbhd + 2 * flux + 4 * drop, h, w, species, b,
                          nbhd, dom)
    grid = grid.astype(dtype)
    want_g, want_k = jreference.run_proposals(
        jnp.asarray(grid), JaxBatch(*map(jnp.asarray, props)), 0.2, 0.6,
        jnp.asarray(dom), flux, drop_conflicts=drop)
    got_g, got_k = reference.run_proposals(
        torch.from_numpy(grid), ProposalBatch(*map(torch.from_numpy, props)),
        0.2, 0.6, torch.from_numpy(dom), flux, drop_conflicts=drop)
    assert got_g.dtype == getattr(torch, dtype) and got_k.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert int(got_k) == int(want_k)
    assert (int(got_k) < b) == drop


def _window_schedule(grid, cell, dirn, u_act, u_dom, dom, t_eps, t_eps_mu,
                     flux, drop, window):
    """A numpy model of S1's schedule (``csrc/reference_scan.cu``), window
    by window of ``window`` steps: the smallest step that names each cell
    (first occurrences by step); the *first* steps, those that are the
    smallest for both their cells, applied all at once to the labels
    gathered at the window's start; without ``drop``, the other steps
    applied in order through the window's table; with ``drop``, a step
    kept iff it is first and neither cell was touched before the window;
    then the table written back, and with ``drop`` every cell of the
    window marked touched. Returns ``(grid, kept)``."""
    h, w = grid.shape
    off = np.asarray(lattice.DIRS)[dirn]
    r, c = cell // w + off[:, 0], cell % w + off[:, 1]
    if flux:
        r, c = r % h, c % w
    else:
        r, c = np.clip(r, 0, h - 1), np.clip(c, 0, w - 1)
    cells, nbrs = cell.tolist(), (r * w + c).tolist()
    ua, ud = u_act.tolist(), u_dom.tolist()
    p1 = dom.astype(np.float32)
    p12 = (p1 + p1.T).tolist()                  # float32 p1 + p2
    p1 = p1.tolist()
    te, tem = float(np.float32(t_eps)), float(np.float32(t_eps_mu))

    def rule(s, n, a, d):
        if s == n:
            return s, n
        if a < te:
            return n, s
        if a < tem:
            if d < p1[s][n]:
                return s, 0
            return (0, n) if d < p12[s][n] else (s, n)
        if n == 0:
            return s, s
        return (n, n) if s == 0 else (s, n)

    g = grid.reshape(-1).tolist()
    touched = [False] * (h * w)
    kept = 0
    for b0 in range(0, len(cells), window):
        steps = range(b0, min(b0 + window, len(cells)))
        first = {}
        for b in steps:
            first.setdefault(cells[b], b)
            first.setdefault(nbrs[b], b)
        gathered = {x: g[x] for x in first}
        label = dict(gathered)
        is_first = {b: first[cells[b]] == b == first[nbrs[b]] for b in steps}
        applied = [b for b in steps if is_first[b] and not (
            drop and (touched[cells[b]] or touched[nbrs[b]]))]
        outs = [rule(gathered[cells[b]], gathered[nbrs[b]], ua[b], ud[b])
                for b in applied]
        for b, (s, n) in zip(applied, outs):
            label[cells[b]] = s
            label[nbrs[b]] = n
        kept += len(applied)
        if not drop:
            for b in steps:
                if not is_first[b]:
                    i, j = cells[b], nbrs[b]
                    label[i], label[j] = rule(label[i], label[j], ua[b],
                                              ud[b])
                    kept += 1
        for x, v in label.items():
            g[x] = v
            touched[x] = touched[x] or drop
    return np.asarray(g, grid.dtype).reshape(h, w), kept


@pytest.mark.parametrize("side", [12, 64])
@pytest.mark.parametrize("length", ["1", "W-1", "W", "W+1", "4097"])
@pytest.mark.parametrize("window", [1, 7, 32, 256, 1024])
def test_window_schedule_equals_host_loop(window, length, side):
    """S1's window schedule, modelled in numpy, equals the host loop
    (``reference_scan_plain``) bit for bit, lattice and kept count: on
    12 x 12 (the reference golden's size, where nearly every step shares a
    cell with an earlier one of its window) and 64 x 64, every lattice
    type, both neighbourhoods, both boundaries (self-pairs at clamped
    edges) and ``drop_conflicts``."""
    b = {"1": 1, "W-1": window - 1, "W": window, "W+1": window + 1,
         "4097": 4097}[length]
    dom = _dom_probabilistic(4, window)
    for nbhd, dtype in itertools.product((4, 8), ("int8", "int16", "int32")):
        grid, props = _inputs(window + b + nbhd, side, side, 4, b, nbhd,
                              dom)
        grid = grid.astype(dtype)
        for flux, drop in itertools.product((True, False), (False, True)):
            want_g, want_k = reference_scan.reference_scan_plain(
                torch.from_numpy(grid), *map(torch.from_numpy, props),
                torch.from_numpy(dom), 0.2, 0.6, flux, drop)
            got_g, got_k = _window_schedule(grid, *props, dom, 0.2, 0.6,
                                            flux, drop, window)
            case = (nbhd, dtype, flux, drop)
            assert got_g.dtype == grid.dtype, case
            np.testing.assert_array_equal(got_g, want_g.numpy(),
                                          err_msg=str(case))
            assert got_k == int(want_k), case


def test_scan_wrapper_rejects_what_the_kernel_does_not_take():
    grid = torch.zeros((4, 4), dtype=torch.int32)
    props = [torch.zeros(3, dtype=dt) for dt in
             (torch.int32, torch.int32, torch.float32, torch.float32)]
    dom = torch.zeros((4, 4), dtype=torch.float32)
    dirs = torch.as_tensor(lattice.DIRS)
    with pytest.raises(ValueError, match="grid"):
        reference_scan.reference_scan(grid.long(), *props, dom, dirs, 0.2,
                                      0.6, True)
    with pytest.raises(ValueError, match="u_dom"):
        reference_scan.reference_scan(grid, *props[:3], props[3].double(),
                                      dom, dirs, 0.2, 0.6, True)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        reference_scan.reference_scan(grid, *(p.reshape(1, 3) for p in props),
                                      dom, dirs, 0.2, 0.6, True)


# ------------------------------- simulate -------------------------------- #

def test_simulate_reproduces_reference_golden():
    """``tests/golden/reference_trajectory.json`` (12 x 12, S = 3, RPS,
    seed 42, 5 MCS) through the port's ``simulate`` on the CPU."""
    with open(GOLDEN) as f:
        want = json.load(f)
    cfg = want["params"]
    hashes = []
    res = simulate(make_scenario("nspecies3", mobility=cfg["mobility"],
                                 empty=cfg["empty"]),
                   dominance.RPS(),
                   engine=EngineConfig(engine="reference"),
                   run=RunConfig(length=cfg["length"], height=cfg["height"],
                                 mcs=cfg["mcs"], chunk_mcs=cfg["chunk_mcs"],
                                 seed=cfg["seed"], observables=()),
                   stop_on_stasis=False, device="cpu",
                   hooks=[lambda m, g, c: hashes.append(_grid_hash(
                       g.cpu().numpy()))])
    assert hashes == want["grid_hashes"]
    assert _grid_hash(res.grid) == want["final_hash"]
    np.testing.assert_array_equal(res.densities,
                                  np.asarray(want["densities"]))
    assert res.kept_fraction == want["kept_fraction"] == 1.0


@pytest.mark.parametrize("flux,nbhd,dtype", [(False, 8, "int8"),
                                             (True, 4, "int16")])
def test_simulate_matches_jax_reference_engine(flux, nbhd, dtype):
    """Reflecting walls and the Moore neighbourhood, through both
    packages' ``simulate`` on the ``reference`` engine."""
    kw = dict(mobility=3e-3, empty=0.1, neighbourhood=nbhd,
              boundary="flux" if flux else "reflect")
    run = dict(length=12, height=10, mcs=3, chunk_mcs=2, seed=5)
    with jax.threefry_partitionable(False):
        want = jsimulate(jscenarios.make_scenario("nspecies4", **kw),
                         engine=jscenarios.EngineConfig(engine="reference",
                                                        cell_dtype=dtype),
                         run=jscenarios.RunConfig(**run),
                         stop_on_stasis=False)
    res = simulate(make_scenario("nspecies4", **kw),
                   engine=EngineConfig(engine="reference", cell_dtype=dtype),
                   run=RunConfig(**run), stop_on_stasis=False, device="cpu")
    np.testing.assert_array_equal(res.grid, want.grid)
    np.testing.assert_array_equal(res.densities, want.densities)
    assert res.kept_fraction == want.kept_fraction == 1.0
