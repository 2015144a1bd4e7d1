"""Park, Chen & Szolnoki (2023) eight-species alliance model (paper §4.3.2;
port of ``repro.core.park``), with the mobility extension of the Cliff &
Sinadjan companion paper (App. C).

The physics is the registered ``probabilistic`` scenario
(``core/scenarios.py``); this module composes it with an engine and run
configuration and reads the trial statistics the figures and Table 4.2
use, through ``trials.run_trials`` on ``device`` (default: every visible
card; ``device='cpu'`` runs the plain path).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import threefry
from .device import Devices
from .params import EscgParams
from .scenarios import EngineConfig, RunConfig, Scenario, compose
from .scenarios import make_scenario
from .trials import run_trials


def park_scenario(alpha: float = 0.15, beta: float = 0.75,
                  gamma: float = 1.0, mobility: float = 0.0) -> Scenario:
    """The registered ``probabilistic`` preset with Park's rate knobs."""
    return make_scenario("probabilistic", alpha=alpha, beta=beta,
                         gamma=gamma, mobility=mobility)


def park_params(L: int = 100, mcs: Optional[int] = None,
                mobility: float = 0.0, engine: str = "batched",
                seed: int = 0, **kw) -> EscgParams:
    """Park's defaults as flat params: S = 8 and no empty sites at the
    start (interactions make empties that reproduction refills), L x L,
    ending after L^2 MCS (paper Figs 4.9/4.10); ``**kw`` overrides fields
    of the result."""
    p = compose(park_scenario(mobility=mobility),
                EngineConfig(engine=engine),
                RunConfig(length=L, height=L, seed=seed,
                          mcs=int(mcs if mcs is not None else L * L)))
    return p.replace(**kw).validate() if kw else p


def survival_probabilities(alpha: float, beta: float, gamma: float = 1.0,
                           L: int = 100, n_trials: int = 20,
                           mcs: Optional[int] = None, mobility: float = 0.0,
                           key: Optional[torch.Tensor] = None,
                           engine: str = "batched",
                           trial_devices: Optional[int] = None,
                           device: Optional[Devices] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(per-species survival probability (8,), n-survivors histogram (9,))
    over IID trials, the quantity of paper Figs 4.9-4.13. The stasis exit
    is safe: a species never reappears, so the survival mask is frozen
    from stasis on."""
    res = run_trials(park_scenario(alpha, beta, gamma, mobility), None,
                     n_trials, key=key, trial_devices=trial_devices,
                     engine=EngineConfig(engine=engine),
                     run=RunConfig(length=L, height=L,
                                   mcs=int(mcs if mcs is not None
                                           else L * L)),
                     device=device)
    return res.survival_probabilities(), res.survivors_hist()


def species5_extinction_std(L_values, mcs_values, alpha: float = 0.15,
                            beta: float = 0.75, gamma: float = 1.0,
                            n_trials: int = 20, seed: int = 0,
                            engine: str = "batched",
                            trial_devices: Optional[int] = None,
                            device: Optional[Devices] = None
                            ) -> np.ndarray:
    """Paper Table 4.2: the std over IID trials of species 5's extinction
    indicator, for each (MCS, L); returns (len(mcs_values),
    len(L_values)). Cell (i, j) runs its trials with the key
    ``PRNGKey(seed + 17 * j + i)``, as the reference."""
    out = np.zeros((len(mcs_values), len(L_values)))
    sc = park_scenario(alpha, beta, gamma)
    for j, L in enumerate(L_values):
        for i, mcs in enumerate(mcs_values):
            if mcs == 0:
                continue
            res = run_trials(sc, None, n_trials,
                             key=threefry.PRNGKey(seed + 17 * j + i),
                             trial_devices=trial_devices,
                             engine=EngineConfig(engine=engine),
                             run=RunConfig(length=L, height=L, mcs=mcs,
                                           seed=seed),
                             device=device)
            extinct5 = 1.0 - res.survival[:, 4].astype(np.float64)
            out[i, j] = float(extinct5.std())
    return out
