"""GPipe-style pipeline parallelism over a list of devices (port of
``repro.parallel.pipeline``, DESIGN.md §9; opt-in).

Layers are partitioned into S contiguous stages; stage i's parameters
live on ``devices[i]`` and micro-batches stream through the stages. The
schedule is the classic GPipe ladder: n_micro + S - 1 ticks, stage i
running micro-batch t - i at tick t; bubble fraction (S-1)/(M+S-1).

Where the reference runs one ``shard_map`` program with ``ppermute``
hops over a 'stage' mesh axis, the port drives every stage from one
process, as its lattice meshes do: each stage runs on its own CUDA
stream, and a micro-batch crosses to the next stage by a non-blocking
``.to`` after which that stage's stream waits on an event. A device may
repeat (four stages on ``cuda:0``, or on ``cpu``), so the pipeline runs
on one card as on several. ``torch.distributed.pipelining`` is not used:
it needs one process per stage, so one card per stage under NCCL.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List

import torch

from ..core.device import Devices, resolve_devices
from ..models.spec import tree_leaves, tree_map


def _stream_ctx(stream):
    return torch.cuda.stream(stream) if stream is not None else \
        contextlib.nullcontext()


def pipeline_apply(block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, n_micro: int,
                   devices: Devices) -> torch.Tensor:
    """Run ``block_fn`` over S parameter slices as a pipeline.

    ``stage_params``: a tree (nested dicts) whose every leaf has leading
    dim S = ``len(devices)``; slice i goes to ``devices[i]``. ``x``: (B,
    ...) with B % n_micro == 0. Returns the last stage's outputs, (B, ...)
    on ``devices[-1]``: per micro-batch exactly the sequential composition
    ``block_fn(p[S-1], ... block_fn(p[0], x_m))``.
    """
    devs: List[torch.device] = list(resolve_devices(devices))
    stages = len(devs)
    lead = {int(a.shape[0]) for a in tree_leaves(stage_params)}
    if lead != {stages}:
        raise ValueError(f"every stage_params leaf needs leading dim "
                         f"{stages} (one slice per device), got {lead}")
    b = x.shape[0]
    if n_micro < 1 or b % n_micro:
        raise ValueError("batch must divide n_micro")
    mb = b // n_micro
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in devs]
    # every stage's stream starts after the work that made its inputs
    involved = {t.device for t in [x] + tree_leaves(stage_params)
                if t.is_cuda} | {d for d in devs if d.type == "cuda"}
    for s in streams:
        if s is not None:
            for d in involved:
                s.wait_stream(torch.cuda.current_stream(d))
    params = []
    for i, d in enumerate(devs):          # stage i's weights on its device
        with _stream_ctx(streams[i]):
            params.append(tree_map(
                lambda a: a[i].to(d, non_blocking=True), stage_params))
    xm = x.reshape(n_micro, mb, *x.shape[1:])
    inbox: List[dict] = [dict() for _ in range(stages)]   # stage -> {m: x}
    with _stream_ctx(streams[0]):
        for m in range(n_micro):
            inbox[0][m] = (xm[m].to(devs[0], non_blocking=True), None)
    outs: List[Any] = [None] * n_micro
    for t in range(n_micro + stages - 1):
        for i in range(stages):
            m = t - i
            if not 0 <= m < n_micro:
                continue
            inp, ready = inbox[i].pop(m)
            s = streams[i]
            with _stream_ctx(s):
                if ready is not None:
                    s.wait_event(ready)
                if s is not None:
                    inp.record_stream(s)
                out = block_fn(params[i], inp)
                if i == stages - 1:
                    outs[m] = out
                    continue
                nxt = out.to(devs[i + 1], non_blocking=True)
                ev = None
                if s is not None:
                    ev = torch.cuda.Event()
                    ev.record(s)
                inbox[i + 1][m] = (nxt, ev)
    last = streams[-1]
    if last is not None:
        torch.cuda.current_stream(devs[-1]).wait_stream(last)
        for o in outs:
            o.record_stream(torch.cuda.current_stream(devs[-1]))
    return torch.cat(outs, dim=0)


def split_stages(tree: Any, n_stages: int) -> Any:
    """A stacked layer tree (leading dim L, L % n_stages == 0) as the
    stage tree ``pipeline_apply`` takes: leading dims (S, L / S)."""
    def split(a):
        if a.shape[0] % n_stages:
            raise ValueError(f"{a.shape[0]} layers do not split into "
                             f"{n_stages} stages")
        return a.reshape(n_stages, a.shape[0] // n_stages, *a.shape[1:])
    return tree_map(split, tree)

