"""Streaming observables on the device (port of ``repro.core.observables``,
DESIGN.md §11).

A registry of *streaming observables* that the chunked MCS loop evaluates
on the lattice's device after every MCS and banks into a device ring
buffer; the host sees the rows once per chunk.

Registry contract (``@register_observable``):

* ``width(params) -> int``: the observable's slice of a row;
* ``compute(grid, counts, params) -> (width,)`` (or ``(..., width)`` for a
  stack of counts): a pure function of the lattice and the per-MCS species
  counts. It draws no random numbers and changes nothing, so trajectories
  are bit-identical with observables on and off;
* ``post(rows, params) -> np.ndarray``: the host's finishing of the
  flushed raw rows (raw counts -> densities). Rows hold raw integer
  statistics in float32, exact below 2**24;
* ``from_counts``: True when the observable is a function of the counts
  alone. Under the ``k_mcs`` megakernel the intermediate lattices never
  leave the kernel, so count-derived observables keep per-MCS cadence
  from the (K, S+1) counts it banks, while grid-derived ones are
  *lag-held*: the rows of a launch group repeat the value taken at the
  group's start.

The ring is a ``(capacity, width)`` float32 tensor on the device, written
at slot ``pos % capacity``; ``pos`` counts every row ever pushed and is a
host integer, since the host loop knows it. :func:`ring_flush` unrolls
``[start, stop)`` modulo the capacity and drops the oldest rows when more
were pushed than the ring holds (``simulate`` sizes the ring so that this
never happens).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ObservableSpec", "register_observable", "observable_names",
    "observable_specs", "get_observable", "resolve", "ObsPipeline",
    "build_pipeline", "ring_init", "ring_push", "ring_push_many",
    "ring_flush", "ring_capacity",
]


# ------------------------------- registry ---------------------------------- #

@dataclass(frozen=True)
class ObservableSpec:
    """One registered streaming observable (see module docstring)."""
    name: str
    width: Callable[..., int] = field(repr=False, default=None)
    compute: Callable[..., torch.Tensor] = field(repr=False, default=None)
    post: Callable[..., np.ndarray] = field(repr=False, default=None)
    from_counts: bool = False
    description: str = ""


_REGISTRY: Dict[str, ObservableSpec] = {}


def register_observable(name: str, *, width: Callable[..., int],
                        from_counts: bool = False,
                        post: Optional[Callable] = None,
                        description: str = ""):
    """Decorator: register ``compute(grid, counts, params)`` under
    ``name``; registering a name again replaces it."""
    def deco(compute_fn):
        _REGISTRY[name] = ObservableSpec(
            name=name, width=width, compute=compute_fn,
            post=post or (lambda rows, p: rows),
            from_counts=from_counts, description=description)
        return compute_fn
    return deco


def observable_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def observable_specs() -> Tuple[ObservableSpec, ...]:
    return tuple(_REGISTRY.values())


def get_observable(name: str) -> ObservableSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown observable {name!r}; registered: {observable_names()}"
        ) from None


def resolve(names) -> Tuple[ObservableSpec, ...]:
    """Requested names -> specs in registry order, without repeats.
    Unknown names raise."""
    want = set()
    for n in names:
        get_observable(n)
        want.add(n)
    return tuple(s for s in _REGISTRY.values() if s.name in want)


# ------------------------------- pipeline ---------------------------------- #

def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


@dataclass(frozen=True)
class ObsPipeline:
    """A resolved observable set for one params: the row layout.

    A row is every spec's slice in registry order; ``densities`` is always
    there and always first, so ``simulate`` takes the per-MCS species counts
    (stasis, hooks, the density history) from its raw-count columns and
    the flushed ring replaces the per-chunk counts copy."""
    specs: Tuple[ObservableSpec, ...]
    widths: Tuple[int, ...]
    offsets: Tuple[int, ...]
    width: int
    _params: object = field(repr=False, default=None)

    # ------------------------- device side ----------------------------- #
    def row(self, grid: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        """The full (width,) float32 row of one MCS."""
        p = self._params
        return torch.cat([_f32(s.compute(grid, counts, p)).reshape(-1)
                          for s in self.specs])

    def grid_values(self, grid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The grid-derived slices, taken at a launch-group boundary (what
        ``k_mcs > 1`` holds); count-derived specs are left out."""
        p = self._params
        return {s.name: _f32(s.compute(grid, None, p)).reshape(-1)
                for s in self.specs if not s.from_counts}

    def row_held(self, counts: torch.Tensor,
                 held: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Rows of megakernel-interior MCS: count-derived slices from
        ``counts`` (S+1,) or (K, S+1), grid-derived slices from ``held``;
        (width,) or (K, width)."""
        p = self._params
        lead = counts.shape[:-1]
        parts = []
        for s, w in zip(self.specs, self.widths):
            if s.from_counts:
                part = _f32(s.compute(None, counts, p)).reshape(lead + (w,))
            else:
                part = held[s.name].expand(lead + (w,))
            parts.append(part)
        return torch.cat(parts, dim=-1)

    # -------------------------- host side ------------------------------ #
    def counts_from_rows(self, rows: np.ndarray, species: int) -> np.ndarray:
        """Per-MCS (..., S+1) int32 species counts from flushed raw rows
        (the leading ``densities`` slice holds raw counts)."""
        return rows[..., : species + 1].astype(np.int32)

    def split(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """Flushed raw rows (..., width) -> per-observable arrays, each
        spec's ``post`` applied."""
        p = self._params
        out = {}
        for s, off, w in zip(self.specs, self.offsets, self.widths):
            out[s.name] = s.post(
                np.asarray(rows[..., off:off + w], np.float64), p)
        return out


def build_pipeline(p) -> ObsPipeline:
    """Pipeline for ``p.observables``, with ``densities`` put in front when
    it is not asked for (``simulate``'s stasis and density accounting read
    its raw-count columns)."""
    names = tuple(p.observables)
    if "densities" not in names:
        names = ("densities",) + names
    specs = resolve(names)
    widths = tuple(int(s.width(p)) for s in specs)
    offsets = tuple(int(x) for x in np.cumsum((0,) + widths[:-1]))
    return ObsPipeline(specs=specs, widths=widths, offsets=offsets,
                       width=int(sum(widths)), _params=p)


# ------------------------------ ring buffer -------------------------------- #

def ring_init(capacity: int, row_shape: Tuple[int, ...],
              device) -> Tuple[torch.Tensor, int]:
    """A device ring ``(zeros (capacity, *row_shape) float32, pos=0)``."""
    if capacity < 1:
        raise ValueError(f"ring capacity must be >= 1, got {capacity}")
    return (torch.zeros((capacity,) + tuple(row_shape), dtype=torch.float32,
                        device=device), 0)


def ring_push(ring: torch.Tensor, pos: int,
              row: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Write ``row`` at slot ``pos % capacity`` (in place); returns
    ``(ring, pos + 1)``."""
    ring[pos % ring.shape[0]] = row
    return ring, pos + 1


def ring_push_many(ring: torch.Tensor, pos: int,
                   rows: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Push ``rows[t]`` in order t = 0..T-1 (in place): where T exceeds the
    capacity only the last ``capacity`` rows survive, as in T single
    pushes."""
    cap, n = ring.shape[0], rows.shape[0]
    drop = max(0, n - cap)
    slots = (torch.arange(pos + drop, pos + n) % cap).to(ring.device)
    ring[slots] = rows[drop:].to(ring.dtype)
    return ring, pos + n


def ring_flush(buf_h: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Host-side unroll of rows ``[start, stop)`` (absolute push indices)
    out of a copied ring. Rows older than ``stop - capacity`` were
    overwritten on the device and are dropped."""
    cap = buf_h.shape[0]
    if stop < start:
        raise ValueError(f"ring_flush: stop {stop} < start {start}")
    lost = max(0, (stop - start) - cap)
    idx = np.arange(start + lost, stop, dtype=np.int64) % cap
    return buf_h[idx]


def ring_capacity(p, default_rows: int) -> int:
    """``params.obs_capacity`` when set, else ``default_rows`` (the
    MCS loop passes its rows per chunk)."""
    return int(p.obs_capacity) if p.obs_capacity else int(default_rows)


# -------------------------- registered observables ------------------------- #
# Registry order is row order: densities first (build_pipeline relies on
# it), then the grid-derived set.

@register_observable(
    "densities", width=lambda p: p.species + 1, from_counts=True,
    post=lambda rows, p: rows / p.n_cells,
    description="per-species population share, col 0 = empties (paper "
                "§3.2.2; raw counts on the device, normalized on flush)")
def _obs_densities(grid, counts, p):
    return _f32(counts)


def _bonds(grid: torch.Tensor):
    """The torus's right and down bonds as (cell, neighbour) pairs of views,
    the inner bonds and then those that wrap around: no copy of the grid."""
    return ((grid[:, :-1], grid[:, 1:]), (grid[:, -1:], grid[:, :1]),
            (grid[:-1], grid[1:]), (grid[-1:], grid[:1]))


@register_observable(
    "interface_length", width=lambda p: 1,
    post=lambda rows, p: rows / (2.0 * p.n_cells),
    description="fraction of unlike nearest-neighbour bonds on the torus "
                "(interface length density)")
def _obs_interface_length(grid, counts, p):
    n_unlike = sum((a != b).sum() for a, b in _bonds(grid))
    return _f32(n_unlike).reshape(1)


@register_observable(
    "cluster_size", width=lambda p: 1,
    post=lambda rows, p: rows / (2.0 * p.n_cells),
    description="same-species occupied-bond density, a cluster-size "
                "proxy")
def _obs_cluster_size(grid, counts, p):
    n_like = sum(((a == b) & (a > 0)).sum() for a, b in _bonds(grid))
    return _f32(n_like).reshape(1)


def _snap_shape(p) -> Tuple[int, int]:
    return min(8, p.height), min(8, p.length)


def _snap_post(rows: np.ndarray, p) -> np.ndarray:
    gh, gw = _snap_shape(p)
    return rows.reshape(rows.shape[:-1] + (gh, gw))


@register_observable(
    "snapshot", width=lambda p: _snap_shape(p)[0] * _snap_shape(p)[1],
    post=_snap_post,
    description="coarse lattice snapshot: the most frequent label of each "
                "block of an (up to) 8x8 partition, the first on ties")
def _obs_snapshot(grid, counts, p):
    gh, gw = _snap_shape(p)
    bh, bw = p.height // gh, p.length // gw
    blocks = (grid[: gh * bh, : gw * bw].reshape(gh, bh, gw, bw)
              .permute(0, 2, 1, 3).reshape(gh, gw, bh * bw))
    labels = torch.arange(p.species + 1, device=grid.device)
    hist = (blocks[..., None] == labels).sum(dim=2)
    # torch.argmax returns the first maximum, as jnp.argmax does
    return _f32(torch.argmax(hist, dim=-1)).reshape(-1)
