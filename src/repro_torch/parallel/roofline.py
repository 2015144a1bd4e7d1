"""Roofline terms of a step from counts taken below DTensor (port of
``repro.parallel.roofline``, DESIGN.md §8).

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at 700 W:
  * 989.4 TFLOP/s dense bf16 tensor-core peak (PEAK_FLOPS);
  * 3.35 TB/s HBM3 (HBM_BW);
  * 50 GB/s per GPU between nodes: one 400 Gb/s NDR port per GPU
    (LINK_BW). Every axis of the production meshes (16 x 16, 2 x 16 x 16)
    spans more than one 8-GPU node, so this rate sets the collective term;
    NVLink 4 inside a node gives 450 GB/s per direction (NVLINK_BW),
    recorded for meshes that stay inside one node.

  compute    = flops_per_chip / PEAK_FLOPS
  memory     = bytes_per_chip / HBM_BW
  collective = collective_bytes_total / (chips * LINK_BW)

The reference parses XLA's compiled HLO; the port counts the local ops
each rank runs (``LocalCost``, a ``TorchDispatchMode`` under which a
DTensor op defers to DTensor's own dispatch, so the mode sees the
per-shard ops, and the per-shard collectives DTensor issues): FLOPs by
``torch.utils.flop_counter``'s formulas, bytes as operands plus outputs
of every local op (an unfused upper bound: a fused kernel reads and
writes less), collective bytes as the output bytes of every
``c10d_functional`` collective, by kind, with its group size.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989.4e12        # bf16 dense / GPU
HBM_BW = 3.35e12             # bytes/s / GPU
LINK_BW = 50e9               # bytes/s / GPU across nodes (400 Gb/s NDR)
NVLINK_BW = 450e9            # bytes/s / GPU per direction inside a node
# integer/instruction issue rate, for kernels that are not tensor-core
# products (the ESCG cell): 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz
INSTR_RATE = 132 * 4 * 32 * 1.98e9

HARDWARE = {"card": "NVIDIA H100 80GB HBM3 (SXM), 700 W",
            "peak_flops_bf16": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
            "link_bytes_per_s": LINK_BW, "nvlink_bytes_per_s": NVLINK_BW,
            "instr_per_s": INSTR_RATE}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "broadcast", "collective-permute")

# c10d_functional op name -> the reference's collective kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


def _is_fake(types, out) -> bool:
    """An op DTensor runs on fake tensors to propagate shapes (global
    shapes, no work of any rank)."""
    from torch._subclasses.fake_tensor import FakeTensor
    if any(issubclass(t, FakeTensor) for t in types):
        return True
    return isinstance(out, FakeTensor)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _group_size(args) -> int:
    """The size of a functional collective's group, named by its last
    string argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if not names:
        return 1
    return _resolve_process_group(names[-1]).size()


class CollectiveBytes(TorchDispatchMode):
    """Sums each ``c10d_functional`` collective's output bytes by kind, as
    the reference sums the output shapes of the HLO's collectives.
    ``by_kind``: {kind: bytes}; ``calls``: (kind, bytes, group size) per
    collective. Under it, a DTensor op is left to DTensor's dispatch, so
    the collectives DTensor issues for a redistribution are seen."""

    def __init__(self):
        super().__init__()
        self.by_kind: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
        self.calls: List[Tuple[str, int, int]] = []

    def _collective(self, func, args, out) -> None:
        kind = _KINDS.get(func.__name__.split(".")[0])
        if kind is None:
            return
        nbytes = sum(t.nbytes for t in _tensors(out))
        self.by_kind[kind] += nbytes
        self.calls.append((kind, nbytes, _group_size(args)))

    def _local(self, func, args, kwargs, out) -> None:
        """A local op that ran (not a collective); counted by subclasses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor's dispatch runs the shards
        out = func(*args, **kwargs)
        if _is_fake(types, out):
            return out
        if func.namespace == "_c10d_functional":
            self._collective(func, args, out)
        else:
            self._local(func, args, kwargs, out)
        return out


# the reference's name: ``with collective_bytes() as c: ...; c.by_kind``
collective_bytes = CollectiveBytes


def _aliases(func) -> bool:
    """Whether an op's output aliases an input (a view or an in-place
    op): it allocates nothing."""
    return any(r.alias_info is not None for r in func._schema.returns)


class LocalCost(CollectiveBytes):
    """Per-rank cost of what runs under it: ``flops`` (the local ops', by
    ``torch.utils.flop_counter.flop_registry``), ``bytes`` (operands and
    outputs of every local op that is not a view), ``ops`` (local ops
    counted), the collectives as ``CollectiveBytes`` counts them, and
    ``peak_bytes``: the most bytes that outputs of local ops held at once,
    each freed when its tensor is, over ``base_bytes`` (the arguments
    already placed)."""

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = base_bytes
        self.peak_bytes = base_bytes

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _local(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        self.ops += 1
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in _tensors(args) + outs)
        if _aliases(func):
            return
        for t in outs:
            n = t.nbytes
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def _collective(self, func, args, out) -> None:
        super()._collective(func, args, out)
        if _aliases(func):
            return
        for t in _tensors(out):
            n = t.nbytes
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_total: float, chips: int,
                   peak: float = PEAK_FLOPS) -> Dict[str, Any]:
    """The three terms and the dominant one; ``peak`` is the compute rate
    (``INSTR_RATE`` for an integer kernel's operations)."""
    compute = flops_per_chip / peak
    memory = bytes_per_chip / HBM_BW
    collective = coll_bytes_total / (chips * LINK_BW)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = max(compute, memory, collective)
    terms["flops_per_chip"] = flops_per_chip
    terms["bytes_per_chip"] = bytes_per_chip
    terms["collective_bytes"] = coll_bytes_total
    return terms


def model_flops(n_active_params: int, n_tokens: int,
                kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * n_tokens


def summarize(cost: Optional[Dict[str, float]], coll: Dict[str, int],
              chips: int, n_active_params: int, n_tokens: int, kind: str
              ) -> Dict[str, Any]:
    """The record's roofline block. ``cost``: per-chip ``flops`` and
    ``bytes accessed``; ``coll``: one chip's collective bytes by kind
    (every chip runs the same program, so the total is ``chips`` times
    it)."""
    flops = float(cost.get("flops", 0.0)) if cost else 0.0
    byts = float(cost.get("bytes accessed", 0.0)) if cost else 0.0
    coll_total = float(sum(coll.values())) * chips
    terms = roofline_terms(flops, byts, coll_total, chips)
    mf = model_flops(n_active_params, n_tokens, kind)
    terms["model_flops_total"] = mf
    terms["model_flops_per_chip"] = mf / chips
    terms["useful_flops_ratio"] = (mf / chips) / flops if flops else 0.0
    terms["collective_breakdown"] = dict(coll)
    return terms
