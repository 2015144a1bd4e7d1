"""State import and export (port of ``repro.core.io``): the paper's files
(grid.csv, params.csv, dominance.csv; ``--save``/``--resume``, §3.2.2),
the binary ``state.npz``, density CSVs and lattice snapshots.

The formats are the reference's byte for byte, so a state saved by either
package resumes in the other:

* ``grid.csv``: one CSV row per lattice row, the MCS on the last line;
* ``params.csv``: the params as JSON;
* ``dominance.csv``: the species block of the dominance matrix;
* ``state.npz``: ``grid`` int32, ``mcs`` int64, ``dom`` float32 and, when
  given, ``key`` as the two uint32 words of a threefry key, as JAX writes
  a raw key;
* ``densities.csv``: ``mcs,empty,s1..sS`` rows at ``%.6f``;
* ``snapshot_%08d.npy``: an int32 lattice.

Every writer takes a tensor on any device (or a numpy array) and copies
it to the host itself, so ``simulate``'s hooks can hand it the card's
lattice.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from . import dominance as dom_mod
from .params import EscgParams


def to_host(a) -> np.ndarray:
    """A numpy copy of ``a`` (a tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def export_grid_csv(path: str, grid, mcs: int) -> None:
    """Paper format: one CSV row per lattice row; final line = last MCS.
    Labels 0..9 (every preset but a large ``nspecies``) are written as
    one byte each, interleaved with the commas, in one pass."""
    grid = to_host(grid).astype(np.int64)
    grid = grid.reshape(grid.shape[0], -1)
    with open(path, "wb") as f:
        if grid.size and 0 <= grid.min() and grid.max() <= 9:
            text = np.full((grid.shape[0], 2 * grid.shape[1]), ord(","),
                           np.uint8)
            text[:, 0::2] = grid + ord("0")
            text[:, -1] = ord("\n")
            f.write(text.tobytes())
        else:
            np.savetxt(f, grid, fmt="%d", delimiter=",")
        f.write(f"{int(mcs)}\n".encode())


def import_grid_csv(path: str) -> Tuple[np.ndarray, int]:
    with open(path) as f:
        lines = [line.strip() for line in f if line.strip()]
    mcs = int(lines[-1])
    grid = np.array([[int(v) for v in line.split(",")]
                     for line in lines[:-1]], dtype=np.int32)
    return grid, mcs


def key_words(key) -> np.ndarray:
    """A threefry key (the port's int64 tensor of two uint32 words, or a
    JAX raw key) as uint32 (2,), the form JAX saves."""
    return (to_host(key).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


def save_state(out_dir: str, params: EscgParams, grid, mcs: int,
               dom: np.ndarray, key=None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    export_grid_csv(os.path.join(out_dir, "grid.csv"), grid, mcs)
    with open(os.path.join(out_dir, "params.csv"), "w") as f:
        f.write(params.to_json())
    with open(os.path.join(out_dir, "dominance.csv"), "w") as f:
        f.write(dom_mod.to_csv(to_host(dom)))
    # the binary state, replaced atomically
    tmp = os.path.join(out_dir, ".state.npz.tmp")
    blob = {"grid": to_host(grid).astype(np.int32), "mcs": np.int64(mcs),
            "dom": to_host(dom).astype(np.float32)}
    if key is not None:
        blob["key"] = key_words(key)
    with open(tmp, "wb") as f:
        np.savez(f, **blob)
    os.replace(tmp, os.path.join(out_dir, "state.npz"))


def load_state(out_dir: str):
    """``(params, grid, mcs, dom, key or None)``, the key in the port's
    form (an int64 tensor of two uint32 words). Reads ``state.npz`` when
    it is there, else the paper's CSV files."""
    with open(os.path.join(out_dir, "params.csv")) as f:
        params = EscgParams.from_json(f.read())
    npz_path = os.path.join(out_dir, "state.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            key = (torch.from_numpy(key_words(z["key"]).astype(np.int64))
                   if "key" in z.files else None)
            return params, z["grid"], int(z["mcs"]), z["dom"], key
    grid, mcs = import_grid_csv(os.path.join(out_dir, "grid.csv"))
    with open(os.path.join(out_dir, "dominance.csv")) as f:
        dom = dom_mod.from_csv(f.read())
    return params, grid, mcs, dom, None


def export_densities_csv(path: str, density_history) -> None:
    hist = to_host(density_history)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        s = hist.shape[1] - 1
        f.write("mcs,empty," + ",".join(f"s{i}" for i in range(1, s + 1))
                + "\n")
        for t, row in enumerate(hist):
            f.write(f"{t}," + ",".join(f"{v:.6f}" for v in row) + "\n")


def save_snapshot(out_dir: str, grid, mcs: int) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"snapshot_{mcs:08d}.npy")
    np.save(path, to_host(grid).astype(np.int32))
    return path
