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
  group's start;
* ``block``/``finish``: how a grid-derived observable reads a lattice
  decomposed over a device mesh (the ``sharded`` and ``sharded_pod``
  engines), no device holding all of it: ``block(view, params)`` is the
  integer partial of one block (a :class:`BlockView`; with a leading
  trial axis for a decomposed trial batch), the partials are summed on the
  mesh's first device, and ``finish(total, params)`` makes the row's
  slice, equal to ``compute`` of the gathered lattice. An observable
  without them is computed on the gathered lattice.

The ring is a ``(capacity, width)`` float32 tensor on the device, written
at slot ``pos % capacity``; ``pos`` counts every row ever pushed and is a
host integer, since the host loop knows it. :func:`ring_flush` unrolls
``[start, stop)`` modulo the capacity and drops the oldest rows when more
were pushed than the ring holds (``simulate`` sizes the ring so that this
never happens; the trial driver allows it, since its statistics come from
the counts).

A batch of IID trials is n lattices stacked as one (n, H, W) tensor:
``compute`` takes it whole (every built-in observable reads the last two
dims), a row of the batch is (n, width), equal to the trials' rows
stacked, and the trial driver's ring is ``(capacity, n, width)``. A batch
decomposed over a mesh (blocks of (n, bh, bw)) gives the same (n, width)
rows from its blocks' partials, and a batch over several pod groups
(an object with ``groups``, each such a batch) its groups' rows in turn.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "BlockView", "ObservableSpec", "register_observable", "observable_names",
    "observable_specs", "get_observable", "resolve", "ObsPipeline",
    "build_pipeline", "build_observe", "ring_init", "ring_push",
    "ring_push_many", "ring_flush", "ring_capacity",
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
    block: Optional[Callable[..., torch.Tensor]] = field(repr=False,
                                                         default=None)
    finish: Optional[Callable[..., torch.Tensor]] = field(repr=False,
                                                          default=None)


class BlockView(NamedTuple):
    """One block of a lattice (or of a trial batch, with a leading trial
    axis) decomposed over a device mesh: its cells, the global (row, col)
    of its first cell, and the first column of its right neighbour block,
    (..., h, 1), and the first row of its lower neighbour block, (..., 1,
    w), on the torus, on the block's device."""
    cells: torch.Tensor
    offset: Tuple[int, int]
    right: torch.Tensor
    down: torch.Tensor


_REGISTRY: Dict[str, ObservableSpec] = {}


def register_observable(name: str, *, width: Callable[..., int],
                        from_counts: bool = False,
                        post: Optional[Callable] = None,
                        description: str = "",
                        block: Optional[Callable] = None,
                        finish: Optional[Callable] = None):
    """Decorator: register ``compute(grid, counts, params)`` under
    ``name``; registering a name again replaces it."""
    def deco(compute_fn):
        _REGISTRY[name] = ObservableSpec(
            name=name, width=width, compute=compute_fn,
            post=post or (lambda rows, p: rows),
            from_counts=from_counts, description=description, block=block,
            finish=finish)
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
    def row(self, grid, counts: torch.Tensor) -> torch.Tensor:
        """The full (width,) float32 row of one MCS."""
        return self.row_held(counts, self.grid_values(grid))

    def grid_values(self, grid) -> Dict[str, torch.Tensor]:
        """The grid-derived slices of an (H, W) lattice (each (w,)) or of
        an (n, H, W) trial batch (each (n, w)), or of a lattice or trial
        batch decomposed over a mesh (an object with ``views()``,
        ``gather()``, ``lead`` and ``device``, such as
        ``sharded.ShardedLattice``), or of the pod groups of a decomposed
        batch (an object with ``groups`` and ``device``, their rows in
        turn), on the lattice's (first) device; count-derived specs are
        left out. Taken at a launch-group boundary, they are what ``k_mcs >
        1`` holds."""
        p = self._params
        specs = [s for s in self.specs if not s.from_counts]
        if isinstance(grid, torch.Tensor):
            lead = tuple(grid.shape[:-2])
            return {s.name: _f32(s.compute(grid, None, p)).reshape(
                lead + (-1,)) for s in specs}
        groups = getattr(grid, "groups", None)
        if groups is not None:
            parts = [self.grid_values(g) for g in groups]
            return {s.name: torch.cat([v[s.name].to(grid.device)
                                       for v in parts]) for s in specs}
        lead = grid.lead
        out, views, whole = {}, None, None
        for s in specs:
            if s.block is None:
                if whole is None:
                    whole = grid.gather()
                value = s.compute(whole, None, p)
            else:
                views = grid.views() if views is None else views
                total = sum(s.block(v, p).to(grid.device) for v in views)
                value = s.finish(total, p)
            out[s.name] = _f32(value).reshape(lead + (-1,))
        return out

    def row_held(self, counts: torch.Tensor,
                 held: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Rows of megakernel-interior MCS: count-derived slices from
        ``counts`` (..., S+1), grid-derived slices from ``held``, which
        broadcast against its leading dims; (..., width). For a trial
        batch: counts (K, n, S+1) and ``held`` of (n, H, W) grids give
        (K, n, width)."""
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

def build_observe(p) -> Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor]:
    """The engine-facing ``observe(grid, counts) -> (width,) float32``
    row of ``p``'s observables, as the reference's: ``build_pipeline(p)``'s
    ``row``."""
    return build_pipeline(p).row


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


def _bonds(cells: torch.Tensor, right: torch.Tensor, down: torch.Tensor):
    """The right and down bonds of a block (or of each lattice of a
    batch, over the last two dims) as (cell, neighbour) pairs of views,
    the inner bonds and then those to the neighbours' first column
    (``right``) and first row (``down``): no copy of the cells. For a
    whole lattice the neighbours are its own first column and row, the
    torus's wrap-around bonds."""
    return ((cells[..., :, :-1], cells[..., :, 1:]),
            (cells[..., :, -1:], right),
            (cells[..., :-1, :], cells[..., 1:, :]),
            (cells[..., -1:, :], down))


def _unlike(cells, right, down):
    return sum((a != b).sum(dim=(-2, -1))
               for a, b in _bonds(cells, right, down))


def _like(cells, right, down):
    return sum(((a == b) & (a > 0)).sum(dim=(-2, -1))
               for a, b in _bonds(cells, right, down))


def _bond_total(total, p):
    return _f32(total).reshape(total.shape + (1,))


@register_observable(
    "interface_length", width=lambda p: 1,
    post=lambda rows, p: rows / (2.0 * p.n_cells),
    description="fraction of unlike nearest-neighbour bonds on the torus "
                "(interface length density)",
    block=lambda v, p: _unlike(v.cells, v.right, v.down),
    finish=_bond_total)
def _obs_interface_length(grid, counts, p):
    return _bond_total(_unlike(grid, grid[..., :, :1], grid[..., :1, :]), p)


@register_observable(
    "cluster_size", width=lambda p: 1,
    post=lambda rows, p: rows / (2.0 * p.n_cells),
    description="same-species occupied-bond density, a cluster-size "
                "proxy",
    block=lambda v, p: _like(v.cells, v.right, v.down),
    finish=_bond_total)
def _obs_cluster_size(grid, counts, p):
    return _bond_total(_like(grid, grid[..., :, :1], grid[..., :1, :]), p)


def _snap_shape(p) -> Tuple[int, int]:
    return min(8, p.height), min(8, p.length)


def _snap_post(rows: np.ndarray, p) -> np.ndarray:
    gh, gw = _snap_shape(p)
    return rows.reshape(rows.shape[:-1] + (gh, gw))


def _snap_segments(start: int, length: int, size: int, count: int):
    """(coarse index, local start, local stop) of each of ``count`` coarse
    cells of ``size`` that meets [start, start + length)."""
    for c in range(count):
        lo, hi = max(start, c * size), min(start + length, (c + 1) * size)
        if lo < hi:
            yield c, lo - start, hi - start


def _snap_block(v: BlockView, p) -> torch.Tensor:
    """The (..., gh, gw, S+1) label histogram of the coarse cells, over one
    block's cells (a coarse cell may span several blocks)."""
    gh, gw = _snap_shape(p)
    h, w = v.cells.shape[-2:]
    lead = tuple(v.cells.shape[:-2])
    labels = torch.arange(p.species + 1, device=v.cells.device)
    hist = torch.zeros(lead + (gh, gw, p.species + 1), dtype=torch.int64,
                       device=v.cells.device)
    for cr, r0, r1 in _snap_segments(v.offset[0], h, p.height // gh, gh):
        for cc, c0, c1 in _snap_segments(v.offset[1], w, p.length // gw,
                                         gw):
            hist[..., cr, cc, :] = (v.cells[..., r0:r1, c0:c1, None]
                                    == labels).sum(dim=(-3, -2))
    return hist


def _snap_finish(hist: torch.Tensor, p) -> torch.Tensor:
    # torch.argmax returns the first maximum, as jnp.argmax does
    return _f32(torch.argmax(hist, dim=-1)).flatten(-2)


@register_observable(
    "snapshot", width=lambda p: _snap_shape(p)[0] * _snap_shape(p)[1],
    post=_snap_post,
    description="coarse lattice snapshot: the most frequent label of each "
                "block of an (up to) 8x8 partition, the first on ties",
    block=_snap_block, finish=_snap_finish)
def _obs_snapshot(grid, counts, p):
    gh, gw = _snap_shape(p)
    bh, bw = p.height // gh, p.length // gw
    lead = tuple(grid.shape[:-2])
    blocks = (grid[..., : gh * bh, : gw * bw].reshape(lead + (gh, bh, gw, bw))
              .transpose(-3, -2).reshape(lead + (gh, gw, bh * bw)))
    labels = torch.arange(p.species + 1, device=grid.device)
    return _snap_finish((blocks[..., None] == labels).sum(dim=-2), p)
