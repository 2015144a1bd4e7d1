"""The port's CUDA kernels and its main path on the card.

Every test here needs a CUDA card and skips without one. They import no
JAX, so they run on the GPU machine as they are:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are held to their plain PyTorch versions (which
``test_torch_kernels.py`` holds to the JAX package on the CPU), and
``simulate`` on the card to the fused golden and to itself across
``k_mcs``.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import dominance, lattice, threefry
from repro_torch.core.scenarios import EngineConfig, RunConfig, make_scenario
from repro_torch.core.simulation import simulate
from repro_torch.kernels import escg_update_fused as fused

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "fused_trajectory.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine with "
                    "-m cuda)")
    return torch.device("cuda")


def _tables(species, dev):
    dom = dominance.circulant(species, (1, 2) if species >= 5 else (1,))
    return (torch.as_tensor(dom).to(dev),
            torch.as_tensor(lattice.DIRS).to(dev))


def _grid(dev, species, dtype, seed=1):
    return lattice.init_grid(threefry.PRNGKey(seed), 64, 128, species, 0.1,
                             dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype,nbhd", [(torch.int32, 4), (torch.int8, 8),
                                        (torch.int16, 4)])
@pytest.mark.parametrize("offset,gtw", [((0, 0), None), ((3, 7), 111)])
def test_round_kernel_equals_plain(cuda, dtype, nbhd, offset, gtw):
    grid = _grid(cuda, 5, dtype)
    dom, dirs = _tables(5, cuda)
    before = fused.LAUNCHES["escg_tile_round_fused"]
    got = fused.escg_tile_round_fused(grid, (9, 10), 3, dom, dirs, (8, 16),
                                      64, 0.25, 0.6, nbhd, offset, gtw)
    want = fused.escg_tile_round_fused_plain(grid, (9, 10), 3, dom, (8, 16),
                                             64, 0.25, 0.6, nbhd, offset,
                                             gtw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["escg_tile_round_fused"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
def test_megakernel_equals_plain(cuda, dtype):
    grid = _grid(cuda, 3, dtype, seed=2)
    dom, dirs = _tables(3, cuda)
    seeds = torch.tensor([[1, 2], [2 ** 32 - 1, 5], [7, 8]],
                         dtype=torch.int64, device=cuda)
    shifts = torch.tensor([[1, 5], [7, 0], [0, 15]], dtype=torch.int64,
                          device=cuda)
    got = fused.escg_tile_rounds_fused(grid, seeds, shifts, dom, dirs,
                                       (8, 16), 64, 0.25, 0.6, 3)
    want = fused.escg_tile_rounds_fused_plain(grid, seeds, shifts, dom,
                                              (8, 16), 64, 0.25, 0.6, 3)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_simulate_reproduces_golden_and_k_mcs(cuda):
    with open(GOLDEN) as f:
        want = json.load(f)

    def run(k_mcs):
        hashes = []
        res = simulate(make_scenario("nspecies5", mobility=1e-3, empty=0.1),
                       engine=EngineConfig(engine="pallas_fused",
                                           tile=(8, 8), k_mcs=k_mcs),
                       run=RunConfig(length=16, height=16, mcs=5,
                                     chunk_mcs=5 if k_mcs > 1 else 1,
                                     seed=11, observables=()),
                       stop_on_stasis=False,
                       hooks=[lambda m, g, c: hashes.append(
                           hashlib.sha256(g.cpu().numpy().astype("<i4")
                                          .tobytes()).hexdigest())])
        return hashes, res

    fused.reset_launches()
    hashes, res = run(1)
    assert hashes == want["grid_hashes"]
    assert fused.LAUNCHES["escg_tile_round_fused"] == 5
    _, res3 = run(3)
    assert fused.LAUNCHES["escg_tile_rounds_fused"] == 2
    np.testing.assert_array_equal(res3.grid, res.grid)
    np.testing.assert_array_equal(res3.densities,
                                  np.asarray(want["densities"]))
