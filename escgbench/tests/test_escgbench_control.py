"""The correctness check fails what it has to fail (CPU, small sizes): the
bfloat16 control in the program's place, and whole runs of the harness,
its look for a card skipped, with the timed path broken underneath:

* a step that returns its state unchanged;
* half of the trials left out (their lattices unchanged);
* an answer altered where it is produced (one trial's count).

One chip: no exchange between chips to leave out. The card's own test
runs a cell at its real size and sees it correct."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from escgbench import check, control, run  # noqa: E402

from repro_torch.core import batched  # noqa: E402
from repro_torch.kernels import density, ops  # noqa: E402

SMALL = {"config": {"length": 64, "height": 32},
         "traffic": {"trials": 4, "chunk_mcs": 2}}
CELLS = ["park3-3200.fused-t16", "zhong-3200.fused-t64",
         "park3-3200.batched-t8"]


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, seed):
    r = control.readings(cell, seed, torch.device("cpu"), SMALL)
    limits = check.limits()
    assert r["fails"]
    assert any(v > limits[k] for k, v in r["numbers"].items())


def _unchanged(fused):
    if fused:
        return lambda grids, *a, **k: grids.clone()
    return lambda grids, *a, **k: (grids.clone(),
                                   torch.zeros(grids.shape[0],
                                               dtype=torch.int32))


def _half(original, fused):
    def step(grids, *args, **kwargs):
        out = original(grids, *args, **kwargs)
        new = out if fused else out[0]
        h = grids.shape[0] // 2
        new = torch.cat([new[:h], grids[h:]])
        return new if fused else (new, out[1])
    return step


def _altered(original):
    def counts(grids, species):
        c = original(grids, species).clone()
        c[0, 1] += 1
        return c
    return counts


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    fused = "fused" in cell
    if fault == "altered":
        monkeypatch.setattr(density, "density_counts_trials",
                            _altered(density.density_counts_trials))
    else:
        mod, name = ((ops, "escg_round_fused_trials") if fused
                     else (batched, "run_proposals_trials"))
        fake = (_unchanged(fused) if fault == "unchanged"
                else _half(getattr(mod, name), fused))
        monkeypatch.setattr(mod, name, fake)
    out = run.run_cell(cell, 99, 0.3, False, device="cpu",
                       overrides=SMALL)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    out = run.run_cell(cell, 2 ** 32 + 3, 0.3, False, device="cpu",
                       overrides=SMALL)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_on_the_card_is_correct(card):
    out = run.run_cell("park3-3200.fused-t16", 4242, 2.0, False)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"


@pytest.mark.parametrize("k_mcs,chunk", [(2, 4), (3, 4)])
@pytest.mark.parametrize("cell", ["park3-3200.fused-t16",
                                  "zhong-3200.fused-t64"])
def test_sound_program_is_correct_with_launches_of_several_mcs(
        cell, k_mcs, chunk):
    small = {"config": SMALL["config"],
             "traffic": dict(SMALL["traffic"], chunk_mcs=chunk,
                             k_mcs=k_mcs)}
    out = run.run_cell(cell, 2 ** 33 + 9, 0.3, False, device="cpu",
                       overrides=small)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())
