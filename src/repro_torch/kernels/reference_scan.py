"""The reference engine's sequential scan as a kernel (S1).

The reference runs ``reference.run_proposals`` as a ``lax.scan`` that XLA
compiles into a device loop; it has no Pallas kernel. As PyTorch tensor
operations the scan would cost several launches per proposal, so the card
runs it as ``reference_scan_kernel`` in ``csrc/reference_scan.cu``: one
block walks the (B,) proposal stream in windows of 1,024 steps (256 on a
lattice of fewer than 65,536 cells), gathers each window's cells into a
shared-memory table, applies in parallel the steps that are the first of
the window to touch both their cells and the rest in order through the
table, and writes the cells back, with the pair rule of
``csrc/tile_staging.cuh``. Its plain version is a host loop over Python
integers, with the float32 rounding of the reference's rule (thresholds
rounded to float32, ``p1 + p2`` summed in float32).

The wrapper launches the kernel for a CUDA grid and takes the plain
version only for a CPU grid. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..core import lattice
from . import build

LAUNCHES = {"reference_scan": 0}

_LIB = "reference_scan"


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.reference_scan
    if fn.argtypes is None:
        i32, ptr, f32 = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [i32, ptr, i32, i32, ctypes.c_int64, ptr, ptr, ptr,
                       ptr, ptr, i32, ptr, f32, f32, i32, ptr, ptr, i32, ptr]
        fn.restype = i32
    return lib


def _check(grid: torch.Tensor, cell: torch.Tensor, dirn: torch.Tensor,
           u_act: torch.Tensor, u_dom: torch.Tensor) -> None:
    if grid.dim() != 2 or grid.dtype not in build.CELL_DTYPES:
        raise ValueError(f"grid must be a 2-D int8/int16/int32 tensor, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    if cell.dim() != 1:
        raise ValueError(f"proposals must be (B,), got {tuple(cell.shape)}")
    for name, t, dt in (("cell", cell, torch.int32),
                        ("dirn", dirn, torch.int32),
                        ("u_act", u_act, torch.float32),
                        ("u_dom", u_dom, torch.float32)):
        if t.dtype != dt or t.shape != cell.shape \
                or t.device != grid.device:
            raise ValueError(f"{name} must be {tuple(cell.shape)} {dt} on "
                             f"{grid.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def reference_scan_plain(grid: torch.Tensor, cell: torch.Tensor,
                         dirn: torch.Tensor, u_act: torch.Tensor,
                         u_dom: torch.Tensor, dom: torch.Tensor,
                         t_eps: float, t_eps_mu: float, flux: bool,
                         drop_conflicts: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of S1 (any device): the scan as a host loop. Python
    floats hold the float32 draws, thresholds and sums exactly, so every
    comparison is the reference's float32 one."""
    h, w = grid.shape
    ni = lattice.neighbor_index(cell, dirn, h, w, flux)
    g = grid.reshape(-1).tolist()
    d = dom.cpu().numpy().astype(np.float32)
    p1 = d.tolist()
    p12 = (d + d.T).tolist()                    # float32 p1 + p2
    te = float(np.float32(t_eps))
    tem = float(np.float32(t_eps_mu))
    touched = bytearray(h * w) if drop_conflicts else None
    kept = 0
    for i, j, ua, ud in zip(cell.tolist(), ni.tolist(), u_act.tolist(),
                            u_dom.tolist()):
        if touched is not None:
            dropped = touched[i] or touched[j]
            touched[i] = touched[j] = 1
            if dropped:
                continue
        s, n = g[i], g[j]
        if s != n:
            if ua < te:                          # migration
                s, n = n, s
            elif ua < tem:                       # interaction
                if ud < p1[s][n]:
                    n = 0
                elif ud < p12[s][n]:
                    s = 0
            elif n == 0:                         # reproduction
                n = s
            elif s == 0:
                s = n
        g[i] = s
        g[j] = n
        kept += 1
    out = torch.tensor(g, dtype=grid.dtype).reshape(h, w).to(grid.device)
    return out, torch.tensor(kept, dtype=torch.int32, device=grid.device)


def reference_scan(grid: torch.Tensor, cell: torch.Tensor,
                   dirn: torch.Tensor, u_act: torch.Tensor,
                   u_dom: torch.Tensor, dom: torch.Tensor,
                   dirs: torch.Tensor, t_eps: float, t_eps_mu: float,
                   flux: bool, drop_conflicts: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the (B,) proposals ``cell``/``dirn`` (int32) and
    ``u_act``/``u_dom`` (float32) strictly in order to the (H, W) grid;
    returns ``(grid, kept)``, a new grid and an int32 scalar, on the grid's
    device. ``dom`` is the padded (S+1, S+1) float32 dominance matrix and
    ``dirs`` the (8, 2) int32 direction table, on the grid's device."""
    _check(grid, cell, dirn, u_act, u_dom)
    build.check_tables(grid, dom, dirs)
    if grid.device.type == "cpu":
        return reference_scan_plain(grid, cell, dirn, u_act, u_dom, dom,
                                    t_eps, t_eps_mu, flux, drop_conflicts)
    device, stream = build.launch_args(grid)
    h, w = grid.shape
    out = grid.clone(memory_format=torch.contiguous_format)
    kept = torch.empty((), dtype=torch.int32, device=grid.device)
    touched = (torch.zeros(h * w, dtype=torch.uint8, device=grid.device)
               if drop_conflicts else None)
    lib = _lib()
    err = lib.reference_scan(
        grid.element_size(), build.ptr(out), h, w, cell.numel(),
        build.ptr(cell), build.ptr(dirn), build.ptr(u_act), build.ptr(u_dom),
        build.ptr(dom), dom.shape[0], build.ptr(dirs), float(t_eps),
        float(t_eps_mu), int(bool(flux)),
        None if touched is None else build.ptr(touched), build.ptr(kept),
        device, stream)
    build.check(lib, err, "reference_scan launch")
    LAUNCHES["reference_scan"] += 1
    return out, kept
