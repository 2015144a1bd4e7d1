"""ESCG simulation driver of the port: the paper's CLI (Tables 3.1/3.2) on
the card (port of ``repro.launch.escg_run``).

    python -m repro_torch.launch.escg_run --scenario park3 \
        --length 3200 --height 3200 --engine pallas_fused --mcs 20
    python -m repro_torch.launch.escg_run --length 32 --height 32 \
        --mcs 40 --save true --outDir out/rps --device cpu
    python -m repro_torch.launch.escg_run --resume true --mcs 60 \
        --outDir out/rps          # continue a saved run
    python -m repro_torch.launch.escg_run --scenario probabilistic \
        --length 100 --height 100 --trials 64 --mcs 10000
    python -m repro_torch.launch.escg_run --listEngines --markdown

The flags are the reference's: every registered engine, ``--save``/
``--resume`` state round-trips, ``--dominance`` CSV import, periodic
snapshots, density export, ``--trials N`` (IID trials through
``trials.run_trials``, a ``TrialResult`` JSON in ``<outDir>/trials.json``
with ``--save true``), ``--scenario NAME`` (physics from the scenario
registry; explicitly passed physics flags override the preset), and the
registry matrices of ``--listEngines``/``--listScenarios`` with their
``--markdown`` form and the ``--check README.md`` drift check. The files
it writes are the reference's (``core/io.py``), so a state saved by either
package resumes in the other.

The port adds ``--device``: the card by default, ``cpu`` for the plain
PyTorch path, or a comma-separated list (``cuda:0,cuda:0,cuda:0,cuda:0``)
that lays out the mesh of ``sharded``/``sharded_pod`` or the pod of
``--trials``. Without a card and without ``--device cpu`` it exits
non-zero; nothing falls back to the CPU. ``--printLaunches`` prints the
kernel launch counts of the run as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Optional

import numpy as np

from ..core import dominance as dom_mod
from ..core import engines, scenarios, threefry
from ..core import io as io_mod
from ..core.device import Devices, resolve_devices
from ..core.params import EscgParams, add_cli_args, params_from_args
from ..core.simulation import simulate
from ..core.trials import run_trials

# ---------------------- registry matrices (docs) -------------------------- #
# The README's engine and scenario tables are generated from the
# registries and checked against drift between these markers.

_MATRIX_HEAD = ("engine", "boundaries", "tile", "devices", "trial axis",
                "local kernels", "reproduces")
_MATRIX_BEGIN = ("<!-- engine-matrix:begin (generated: escg_run "
                 "--listEngines --markdown; CI-checked) -->")
_MATRIX_END = "<!-- engine-matrix:end -->"

_SC_MATRIX_HEAD = ("scenario", "species", "rates", "boundary", "init",
                   "observables", "reproduces")
_SC_MATRIX_BEGIN = ("<!-- scenario-matrix:begin (generated: escg_run "
                    "--listScenarios --markdown; CI-checked) -->")
_SC_MATRIX_END = "<!-- scenario-matrix:end -->"


def _markdown_table(head, rows) -> str:
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    lines += ["| " + " | ".join(row) + " |" for row in rows]
    return "\n".join(lines)


def _readme_block_drift(readme_path: str, begin: str, end: str, want: str,
                        what: str, regen_flag: str) -> Optional[str]:
    """None when the README block between ``begin`` and ``end`` equals the
    generated table; else a message saying how it drifted."""
    with open(readme_path) as f:
        text = f.read()
    m = re.search(re.escape(begin) + r"\n(.*?)\n" + re.escape(end),
                  text, re.S)
    if not m:
        return f"{readme_path}: {what} markers not found"
    got = m.group(1).strip()
    if got != want.strip():
        return (f"{readme_path}: {what} drifted from the registry.\n"
                f"Regenerate with:\n  PYTHONPATH=src python -m "
                f"repro_torch.launch.escg_run {regen_flag} --markdown\n"
                f"--- README ---\n{got}\n--- registry ---\n{want.strip()}")
    return None


def engine_matrix_rows():
    """One row per registered engine, from its ``EngineCaps``."""
    rows = []
    for spec in engines.engine_specs():
        c = spec.caps
        tile = ("must divide device blocks" if c.multi_device
                else "must divide lattice") if c.tiled else "—"
        rows.append((f"`{spec.name}`",
                     "flux only" if c.flux_only else "flux or reflect",
                     tile,
                     "multi" if c.multi_device else "single",
                     c.trial_axis,
                     ", ".join(f"`{k}`" for k in c.local_kernels) or "—",
                     f"{c.paper} — {c.description}"))
    return rows


def engine_matrix_markdown() -> str:
    """The README engine matrix, generated from the registry."""
    return _markdown_table(_MATRIX_HEAD, engine_matrix_rows())


def readme_matrix_drift(readme_path: str) -> Optional[str]:
    """The engine matrix's drift check (``--listEngines --check``)."""
    return _readme_block_drift(readme_path, _MATRIX_BEGIN, _MATRIX_END,
                               engine_matrix_markdown(), "engine matrix",
                               "--listEngines")


def scenario_matrix_rows():
    """One row per registered scenario, from its ``ScenarioCaps``."""
    rows = []
    for spec in scenarios.scenario_specs():
        c = spec.caps
        rows.append((f"`{spec.name}`",
                     "parametric (`S`)" if c.species is None
                     else str(c.species),
                     c.rates,
                     c.boundary,
                     c.init,
                     ", ".join(f"`{o}`" for o in c.observables) or "—",
                     f"{c.paper} — {c.description}"))
    return rows


def scenario_matrix_markdown() -> str:
    """The README scenario matrix, generated from the registry."""
    return _markdown_table(_SC_MATRIX_HEAD, scenario_matrix_rows())


def readme_scenario_drift(readme_path: str) -> Optional[str]:
    """The scenario matrix's drift check (``--listScenarios --check``)."""
    return _readme_block_drift(readme_path, _SC_MATRIX_BEGIN,
                               _SC_MATRIX_END, scenario_matrix_markdown(),
                               "scenario matrix", "--listScenarios")


def print_engine_matrix() -> None:
    """The engine table as plain text."""
    print(f"{'engine':<13} {'boundaries':<11} {'tiled':<6} {'devices':<8} "
          f"{'trial axis':<17} paper ref")
    for spec in engines.engine_specs():
        c = spec.caps
        print(f"{spec.name:<13} {'flux-only' if c.flux_only else 'any':<11} "
              f"{'yes' if c.tiled else 'no':<6} "
              f"{'multi' if c.multi_device else 'single':<8} "
              f"{c.trial_axis:<17} {c.paper}")
        print(f"{'':13} {spec.caps.description}")


def print_scenario_matrix() -> None:
    """The scenario table as plain text."""
    print(f"{'scenario':<15} {'species':<9} {'rates':<14} {'boundary':<9} "
          "paper ref")
    for spec in scenarios.scenario_specs():
        c = spec.caps
        sp = "S (param)" if c.species is None else str(c.species)
        print(f"{spec.name:<15} {sp:<9} {c.rates:<14} {c.boundary:<9} "
              f"{c.paper}")
        print(f"{'':15} {c.description}")


# ------------------------------ trial mode -------------------------------- #

def run_trial_batch(params: EscgParams, dom: np.ndarray, n_trials: int,
                    trial_devices: Optional[int],
                    device: Optional[Devices] = None) -> None:
    """--trials N: IID trials through ``trials.run_trials``."""
    def progress(mcs_done, alive_counts):
        in_stasis = int((alive_counts <= 1).sum())
        print(f"[escg]   chunk -> MCS {mcs_done}: {in_stasis}/{n_trials} "
              f"trials in stasis", flush=True)

    # the scenario-first call form; decompose round-trips the params
    sc, eng_cfg, run_cfg = scenarios.decompose(params)
    t0 = time.time()
    res = run_trials(sc, dom, n_trials, trial_devices=trial_devices,
                     hooks=[progress], engine=eng_cfg, run=run_cfg,
                     device=device)
    dt = time.time() - t0

    upd = res.mcs_completed * params.n_cells * n_trials
    print(f"[escg] {n_trials} trials x {params.height}x{params.length} "
          f"species={params.species} engine={params.engine} on "
          f"{res.n_devices} device(s): {res.mcs_completed} MCS in {dt:.2f}s "
          f"({upd / max(dt, 1e-9):.3g} updates/s aggregate)")
    print(f"[escg] survival probabilities: "
          f"{np.round(res.survival_probabilities(), 4)}")
    print(f"[escg] survivors histogram:    "
          f"{np.round(res.survivors_hist(), 4)}")
    n_stasis = int((res.stasis_mcs >= 0).sum())
    if n_stasis:
        reached = res.stasis_mcs[res.stasis_mcs >= 0]
        print(f"[escg] stasis reached in {n_stasis}/{n_trials} trials "
              f"(median MCS {int(np.median(reached))})")
    if params.save:
        os.makedirs(params.out_dir, exist_ok=True)
        path = os.path.join(params.out_dir, "trials.json")
        with open(path, "w") as f:
            f.write(res.to_json())
        print(f"[escg] TrialResult saved to {path}")


# --------------------------------- main ----------------------------------- #

def parse_device(text: Optional[str]) -> Optional[Devices]:
    """``--device``: None (the card), one device, or a comma-separated
    list of them (a mesh or a pod, in raster order)."""
    if text is None:
        return None
    parts = [x.strip() for x in text.split(",") if x.strip()]
    if not parts:
        raise argparse.ArgumentTypeError("--device needs a device name")
    return parts[0] if len(parts) == 1 else parts


def build_parser() -> argparse.ArgumentParser:
    """The whole CLI parser (paper flags, scaling, scenario layer and the
    port's ``--device``)."""
    ap = argparse.ArgumentParser(description="ESCG simulator (paper CLI), "
                                             "PyTorch/CUDA port")
    add_cli_args(ap)
    ap.add_argument("--snapshotEvery", dest="snapshot_every", type=int,
                    default=0, help="save lattice snapshot every N MCS")
    ap.add_argument("--trials", type=int, default=0,
                    help="run N IID trials (one launch per kernel and MCS "
                         "for the trials of a device) instead of one "
                         "simulation; prints survival/stasis statistics")
    ap.add_argument("--trialDevices", dest="trial_devices", type=int,
                    default=None,
                    help="pod width for --trials: the first N devices of "
                         "--device (default: all; results are "
                         "bit-identical for any value)")
    ap.add_argument("--scenario", type=str, default=None,
                    help="run a registered scenario preset (see "
                         "--listScenarios); its physics come from the "
                         "registry, overridden by explicitly-passed "
                         "flags; parametric families take a numeric "
                         "suffix (nspecies7)")
    ap.add_argument("--device", type=parse_device, default=None,
                    help="where to run: the card (default), 'cpu' for the "
                         "plain PyTorch path, or a comma-separated list "
                         "(cuda:0,cuda:0,cuda:0,cuda:0) for the mesh of "
                         "sharded/sharded_pod or the pod of --trials")
    ap.add_argument("--printLaunches", dest="print_launches",
                    action="store_true",
                    help="print the run's kernel launch counts as one "
                         "JSON line")
    ap.add_argument("--listEngines", dest="list_engines",
                    action="store_true",
                    help="print the registered engine matrix and exit")
    ap.add_argument("--listScenarios", dest="list_scenarios",
                    action="store_true",
                    help="print the registered scenario matrix and exit")
    ap.add_argument("--markdown", action="store_true",
                    help="with --listEngines/--listScenarios: print the "
                         "matrix as the markdown table of README.md")
    ap.add_argument("--check", dest="check_readme", metavar="README",
                    default=None,
                    help="with --listEngines/--listScenarios: exit "
                         "non-zero if README's matrix drifted from the "
                         "registry")
    return ap


def scenario_setup(args, ap: argparse.ArgumentParser):
    """Resolve ``--scenario``: ``(scenario, validated EscgParams,
    dominance)``. The physics come from the preset, overridden by the
    scenario flags passed with other values than their defaults; engine
    and run control from the other flags. The preset's declared
    observables stream unless ``--observables`` pins the set."""
    sc = scenarios.scenario_from_cli(args, ap)
    params, dom = scenarios.resolve_config(
        sc, None, scenarios.engine_config_from_args(args),
        scenarios.run_config_from_args(args))
    return sc, params, dom


def _list_matrices(args) -> None:
    for flagged, drift_fn, md_fn, text_fn, what in (
            (args.list_engines, readme_matrix_drift,
             engine_matrix_markdown, print_engine_matrix, "engine matrix"),
            (args.list_scenarios, readme_scenario_drift,
             scenario_matrix_markdown, print_scenario_matrix,
             "scenario matrix")):
        if not flagged:
            continue
        if args.check_readme:
            drift = drift_fn(args.check_readme)
            if drift:
                raise SystemExit(drift)
            print(f"[escg] {args.check_readme} {what} matches the "
                  "registry")
        elif args.markdown:
            print(md_fn())
        else:
            text_fn()


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.list_engines or args.list_scenarios:
        _list_matrices(args)
        return

    device = args.device
    try:
        resolve_devices(device)          # no card and no --device cpu: exit
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"[escg] {e}")
    if args.print_launches:
        from ..kernels import ops as kernel_ops
        kernel_ops.reset_launches()

    grid0 = None
    key = None
    start_mcs = 0
    if args.resume:
        if args.trials:
            raise SystemExit("--trials and --resume are mutually exclusive "
                             "(trial batches keep no host-side state)")
        if args.scenario:
            raise SystemExit("--scenario and --resume are mutually "
                             "exclusive (the resumed state already "
                             "carries its physics)")
        params, grid0, start_mcs, dom, key = io_mod.load_state(args.out_dir)
        params = params.replace(resume=True)
        if key is None:
            key = threefry.fold_in(threefry.PRNGKey(params.seed), start_mcs)
        # the CLI may extend the run beyond the saved target
        params = params.replace(mcs=max(params.mcs, args.mcs))
        print(f"[escg] resumed {args.out_dir} at MCS {start_mcs}")
    elif args.scenario:
        if args.dominance:
            raise SystemExit("--scenario and --dominance are mutually "
                             "exclusive (the scenario defines its own "
                             "dominance network)")
        sc, params, dom = scenario_setup(args, ap)
        print(f"[escg] scenario {sc.name!r}: species={sc.species} "
              f"rates={scenarios.get_scenario(sc.name).caps.rates} "
              f"boundary={sc.boundary}")
    else:
        params = params_from_args(args)
        if args.dominance:
            with open(args.dominance) as f:
                dom = dom_mod.from_csv(f.read())
            params = params.replace(species=dom.shape[0] - 1)
        else:
            # default circulant: RPS for 3, C(S,{1,2}) for 5+, C(S,{1}) else
            offs = (1, 2) if params.species >= 5 else (1,)
            dom = dom_mod.circulant(params.species, offs)

    if args.trials:
        run_trial_batch(params.validate(), dom, args.trials,
                        args.trial_devices, device)
        _print_launches(args)
        return

    params = params.replace(mcs=params.mcs - start_mcs).validate()

    hooks = []
    if args.snapshot_every:
        def snap_hook(mcs_done, grid, cnts):
            if mcs_done % args.snapshot_every == 0:
                # the hook gets the lattice where it lives: io copies it
                io_mod.save_snapshot(params.out_dir, grid,
                                     start_mcs + mcs_done)
        hooks.append(snap_hook)

    if params.print_frequency > 0:
        # the paper's printFrequency: the per-MCS rows reach the host once
        # per chunk, so any interval costs no extra transfer
        pf, n_cells = params.print_frequency, params.n_cells

        def density_hook(mcs_done, grid, cnts):
            first = mcs_done - len(cnts) + 1
            for i in range((-first % pf), len(cnts), pf):
                print(f"[escg] MCS {start_mcs + first + i}: densities "
                      f"{np.round(cnts[i] / n_cells, 4)}", flush=True)
        hooks.append(density_hook)

    # the scenario-first call form; decompose round-trips the params
    sc_run, eng_cfg, run_cfg = scenarios.decompose(params)
    t0 = time.time()
    res = simulate(sc_run, dom, grid0=grid0, key=key, hooks=hooks,
                   engine=eng_cfg, run=run_cfg, device=device)
    dt = time.time() - t0

    n = params.n_cells
    total_mcs = start_mcs + res.mcs_completed
    print(f"[escg] {params.height}x{params.length} species={params.species}"
          f" engine={params.engine}: {res.mcs_completed} MCS in {dt:.2f}s"
          f" ({res.mcs_completed * n / max(dt, 1e-9):.3g} updates/s)")
    if res.stasis_mcs >= 0:
        print(f"[escg] stasis (monoculture/dead) at MCS "
              f"{start_mcs + res.stasis_mcs}")
    print("[escg] final densities:", np.round(res.densities[-1], 4))
    _print_launches(args)

    if params.save:
        t0 = time.time()
        os.makedirs(params.out_dir, exist_ok=True)
        io_mod.save_state(params.out_dir, params.replace(mcs=args.mcs),
                          res.grid, total_mcs, np.asarray(dom))
        io_mod.export_densities_csv(
            os.path.join(params.out_dir, "densities.csv"), res.densities)
        print(f"[escg] state + densities saved to {params.out_dir} in "
              f"{time.time() - t0:.3f}s")


def _print_launches(args) -> None:
    if args.print_launches:
        from ..kernels import ops as kernel_ops
        print("[escg] kernel launches " + json.dumps(kernel_ops.launches()),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
