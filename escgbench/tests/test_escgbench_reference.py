"""The frozen reference equals the port at small sizes on both engines'
semantics: keys, lattices, the key chain, one MCS and the rows. The test
imports both; the reference imports nothing of the port."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from escgbench import harness  # noqa: E402
from escgbench.reference import escg, philox, threefry as tf  # noqa: E402

from repro_torch.core import engines, observables  # noqa: E402
from repro_torch.core import threefry as port_tf  # noqa: E402
from repro_torch.core.scenarios import resolve_config  # noqa: E402
from repro_torch.core.trials import (fold_trial_keys,  # noqa: E402
                                     make_trial_init)
from repro_torch.kernels import philox as port_philox  # noqa: E402

SMALL = {"config": {"length": 64, "height": 32},
         "traffic": {"trials": 3, "chunk_mcs": 2}}
CELLS = ["park3-3200.fused-t16", "zhong-3200.fused-t64",
         "park3-3200.batched-t8"]
KEY = (0x12345678, 0x9ABCDEF0)


def test_threefry_and_philox_equal_the_ports():
    key = torch.tensor(KEY, dtype=torch.int64)
    assert torch.equal(tf.bits(key, 33), port_tf.random_bits(key, (33,)))
    assert tf.split_words(KEY, 3) == [tuple(k) for k in
                                      port_tf.split(key, 3).tolist()]
    assert tf.fold_in_words(KEY, 7) == tuple(port_tf.fold_in(key, 7).tolist())
    for span in (2048, 3200 * 3200, 70001):
        assert torch.equal(tf.randint(key, 101, 0, span),
                           port_tf.randint(key, (101,), 0, span).long())
    assert tf.randint_words(KEY, 2, 0, [8, 70001]) == \
        port_tf.randint(key, (2,), 0, torch.tensor([8, 70001])).tolist()
    assert torch.equal(tf.uniform(key, 9), port_tf.uniform(key, (9,)))
    idx = torch.arange(1000, dtype=torch.int64) * 7919
    assert all(torch.equal(a, b) for a, b in zip(
        philox.philox(idx, 3, 0, 0, *KEY),
        port_philox.philox_rounds(idx, torch.full_like(idx, 3),
                                  torch.zeros_like(idx),
                                  torch.zeros_like(idx), *KEY)))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port(cell):
    c = harness.load_cell(cell, overrides=SMALL)
    sc, eng, run = harness.program_inputs(c)
    p, dom = resolve_config(sc, None, eng, run)
    built = engines.build(p, dom, "cpu")
    m = c.model
    key = torch.tensor(KEY, dtype=torch.int64)
    grids, keys = make_trial_init(p, "cpu")(fold_trial_keys(key, 3))
    ref = torch.stack([escg.lattice(escg.trial_keys(KEY, t)[0], m, "cpu")
                       for t in range(3)])
    assert torch.equal(ref, grids.long())
    plans = [escg.chain(escg.trial_keys(KEY, t)[1], 3, c.engine, m.tile)[1]
             for t in range(3)]
    _, words, shifts = built.schedule_batch(keys, 3)
    assert words.tolist() == [[list(w) for w, _ in pl] for pl in plans]
    assert shifts.tolist() == [[list(s) for _, s in pl] for pl in plans]
    pipe = observables.build_pipeline(p)
    for mcs in range(3):
        grids, _ = built.one_mcs_batch(grids, words[:, mcs].contiguous(),
                                       shifts[:, mcs].contiguous())
        ref, raw = escg.run(ref, [pl[mcs:mcs + 1] for pl in plans], m,
                            c.engine)
        assert torch.equal(ref, grids.long())
        counts = built.counts_batch(grids, p.species)
        assert np.array_equal(escg.as_ring(raw[:, 0]),
                              pipe.row(grids, counts).numpy())
