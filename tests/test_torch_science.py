"""The science claims of ``tests/test_science.py`` on the port, at the same
reduced sizes, on the CPU, and the port's entry points kept free of JAX.

Claims exercised (the paper's validation, at reduced scale):
  * Zhong et al. ablated RPSLS: the Paper species goes extinct early, on
    ``batched`` and on ``sublattice``;
  * RMF: three-species coexistence below the mobility threshold;
  * Park et al.: the probabilistic-rate model produces survival
    statistics (``core/park.py``), and ``park_params`` follows the
    paper's protocol.
"""
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.core import dominance as dm
from repro_torch.core import metrics
from repro_torch.core.park import park_params, survival_probabilities
from repro_torch.core.params import EscgParams
from repro_torch.core.simulation import simulate

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.mark.slow
def test_zhong_paper_species_extinct_early():
    p = EscgParams(length=64, height=64, species=5, mobility=1e-4,
                   mcs=1500, chunk_mcs=250, engine="batched", seed=11)
    res = simulate(p, dm.zhong_ablated_rpsls(), stop_on_stasis=False,
                   device="cpu")
    ext = metrics.first_extinction_mcs(res.densities, dm.PAPER)
    assert 0 < ext <= 1500, f"Paper should die early, got {ext}"
    # the two sub-cycles persist at this horizon: >= 3 species alive
    assert (res.densities[-1][1:] > 0).sum() >= 3


@pytest.mark.slow
def test_rmf_coexistence_low_mobility():
    p = EscgParams(length=64, height=64, species=3, mobility=3e-5,
                   empty=0.1, mcs=300, chunk_mcs=100, engine="batched",
                   seed=5)
    res = simulate(p, dm.RPS(), stop_on_stasis=False, device="cpu")
    assert (res.densities[-1][1:] > 0.05).all(), res.densities[-1]


@pytest.mark.slow
def test_sublattice_engine_reproduces_zhong_extinction():
    p = EscgParams(length=64, height=64, species=5, mobility=1e-4,
                   mcs=1500, chunk_mcs=250, engine="sublattice",
                   tile=(8, 16), seed=11)
    res = simulate(p, dm.zhong_ablated_rpsls(), stop_on_stasis=False,
                   device="cpu")
    ext = metrics.first_extinction_mcs(res.densities, dm.PAPER)
    assert 0 < ext <= 1500


@pytest.mark.slow
def test_park_model_survival_statistics():
    ps, hist = survival_probabilities(alpha=0.3, beta=0.75, gamma=1.0,
                                      L=24, n_trials=4, mcs=150,
                                      device="cpu")
    assert ps.shape == (8,)
    assert hist.shape == (9,)
    assert abs(hist.sum() - 1.0) < 1e-6
    assert (0 <= ps).all() and (ps <= 1).all()


def test_park_params_match_paper_protocol():
    p = park_params(L=100)
    assert p.species == 8
    assert p.mcs == 100 * 100            # terminate after L^2 MCS
    assert p.eps == 0.0                  # no mobility in Park et al.
    p2 = park_params(L=50, mobility=1e-4)
    assert p2.eps > 0.0                  # the companion-paper extension


NO_JAX = """
import sys
sys.modules["jax"] = None            # any import of jax now fails
sys.modules["repro"] = None          # and so does any of the JAX package
import repro_torch.core.io
import repro_torch.launch
import repro_torch.launch.escg_run as escg_run
import repro_torch.launch.serve as serve
import repro_torch.serve
import repro_torch.serve.bucketing
import repro_torch.serve.cache
import repro_torch.serve.executor
import repro_torch.serve.httpd
import repro_torch.serve.loadgen
import repro_torch.serve.protocol
import repro_torch.serve.server
escg_run.main(["--length", "16", "--height", "16", "--mcs", "4",
               "--chunkMcs", "2", "--device", "cpu", "--save", "true",
               "--outDir", %r])
escg_run.main(["--resume", "true", "--mcs", "6", "--outDir", %r,
               "--device", "cpu"])
escg_run.main(["--listEngines", "--markdown"])
assert serve.main(["--synthetic", "2", "--waves", "2", "--check",
                   "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if sys.modules[m] is not None
             and (m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_entry_points_import_neither_jax_nor_repro(tmp_path):
    out_dir = str(tmp_path / "run")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(NO_JAX % (out_dir, out_dir))],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout
    assert os.path.exists(os.path.join(out_dir, "state.npz"))
