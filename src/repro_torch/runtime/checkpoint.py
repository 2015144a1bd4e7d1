"""Sharded checkpointing (port of ``repro.runtime.checkpoint``): save and
restore trees (nested dicts) of tensors and decomposed lattices with a
manifest + per-leaf ``.npy`` payloads, in the reference's layout, so that
either package restores what the other saved.

Design (DESIGN.md §9):
  * every leaf is written per shard with its global index bounds: a
    tensor as one shard (the reference's single-device array), a
    ``ShardedLattice`` block by block (the reference's addressable shards
    of a lattice on a ('rows', 'cols') mesh);
  * a DTensor leaf is written as the reference writes a sharded
    ``jax.Array``: each shard with its bounds, a replicated shard once.
    In a world of several ranks each rank writes its own shards; rank 0
    writes the manifest and the marker and publishes the directory after
    a barrier (on the calling thread: with ``blocking=False`` the shards
    are written on the writer thread and the barrier and publish wait for
    ``wait()`` or the next ``save``);
  * restore is layout-agnostic: ``shardings`` places each leaf whole on a
    device, as a ``ShardedLattice`` on any ``LatticeMesh``, or as a
    DTensor on any ``(DeviceMesh, placements)`` (the elastic path);
  * atomic publish: write to ``step_XXXX.tmp`` then ``os.replace`` it; a
    crash mid-write never corrupts the latest checkpoint;
  * retention: keep the newest K checkpoints;
  * async: ``save(..., blocking=False)`` hands the host copies to a writer
    thread (at most one outstanding save). ``save`` takes a real host copy
    of every leaf before it returns, so a later in-place update of a
    tensor never reaches a pending write.

A bfloat16 leaf is written as the reference writes one: a ``'<V2'``
payload (``np.save`` of an ``ml_dtypes`` array) under ``"dtype":
"bfloat16"``; it is read back through an int16 view, with no
``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core.device import DeviceLike, resolve_device
from ..core.sharded import ShardedLattice, place
from ..parallel.sharding import LatticeMesh

MANIFEST = "manifest.json"
_MARKER = "COMMITTED"
_BF16_DESCR = "<V2"

# the manifest's dtype name (numpy's) of each of the port's dtypes
_DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.float64: "float64",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor that shares no storage with it; bfloat16 as
    its raw int16 words."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    return host.numpy()


def tensor_from_numpy(arr, dtype_name: Optional[str] = None) -> torch.Tensor:
    """A CPU tensor of a numpy array (copied). ``dtype_name`` 'bfloat16'
    (or an ``ml_dtypes`` bfloat16 array, or a 2-byte void array) reads the
    16-bit words as bfloat16."""
    a = np.array(arr, copy=True, order="C")
    if (dtype_name == "bfloat16" or a.dtype.name == "bfloat16"
            or a.dtype == np.dtype("V2")):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf_paths(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree.keys()):
            out.extend(_leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                   else k))
        return out
    return [(prefix, tree)]


def _unflatten(items: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, v in items.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _slug(path: str) -> str:
    return path.replace("/", ".")


def _world() -> Tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _dtensor_shards(arr) -> Tuple[List[int], str, int,
                                  List[Tuple[int, list, Any]]]:
    """(shape, dtype name, n_shards, [(index, bounds, payload)]) of a
    DTensor: the shards of every mesh coordinate in mesh order, each bounds
    once (a replica is written by its first holder), the payload this
    rank's host copy where it holds that shard, else ``None``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    arr = arr.redistribute(arr.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in arr.placements))
    mesh = arr.device_mesh
    coords = list(np.ndindex(*mesh.shape))
    mine = tuple(mesh.get_coordinate() or ())
    shards = []
    for i, c in enumerate(coords):
        local, off = _compute_local_shape_and_global_offset(
            arr.shape, mesh.shape, list(c), arr.placements)
        shards.append((i, [[int(o), int(o) + int(n)]
                           for o, n in zip(off, local)], c == mine))
    out = [(i, b, tensor_to_numpy(arr.to_local()) if here else None)
           for i, b, here in _once(shards)]
    return list(arr.shape), _DTYPE_NAMES[arr.dtype], len(coords), out


def _once(shards):
    """The shards whose bounds no earlier shard had (replicas: once)."""
    seen, out = set(), []
    for x in shards:
        key = json.dumps(x[1])
        if key not in seen:
            seen.add(key)
            out.append(x)
    return out


def _host_shards(arr) -> Tuple[List[int], str, List[Tuple[list, Any]]]:
    """(shape, dtype name, [(bounds, host payload)]) of one leaf."""
    if isinstance(arr, ShardedLattice):
        lead = list(arr.lead)
        bh, bw = arr.blocks[0][0].shape[-2:]
        shards = [([[0, n] for n in lead]
                   + [[ri * bh, (ri + 1) * bh], [ci * bw, (ci + 1) * bw]],
                   tensor_to_numpy(b))
                  for ri, row in enumerate(arr.blocks)
                  for ci, b in enumerate(row)]
        return (lead + list(arr.shape), _DTYPE_NAMES[arr.flat[0].dtype],
                shards)
    if isinstance(arr, torch.Tensor):
        shape, name, data = list(arr.shape), _DTYPE_NAMES[arr.dtype], \
            tensor_to_numpy(arr)
    else:
        data = np.array(arr, copy=True)
        shape, name = list(data.shape), str(data.dtype)
    return shape, name, [([[0, d] for d in shape], data)]


def _save_npy(fn: str, data: np.ndarray, dtype_name: str) -> None:
    """``np.save``, except that bfloat16 words get the reference's
    ``'<V2'`` header (byte for byte what it writes)."""
    if dtype_name != "bfloat16":
        np.save(fn, data)
        return
    with open(fn, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": data.shape})
        f.write(np.ascontiguousarray(data).tobytes())


def _place_on_mesh(t: torch.Tensor, mesh, placements):
    """A whole host tensor as a DTensor on ``mesh``; each rank keeps its
    shard (every rank read the same files: no collective)."""
    from torch.distributed.tensor import distribute_tensor
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return distribute_tensor(t.to(dev), mesh, tuple(placements),
                             src_data_rank=None)


class CheckpointManager:
    """Checkpoints of one run under ``directory``. ``device`` is where
    ``restore`` places a leaf that ``shardings`` does not place (default:
    the card)."""

    def __init__(self, directory: str, keep: int = 3,
                 device: Optional[DeviceLike] = None):
        self.dir = directory
        self.keep = keep
        self.device = device
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._publish = None      # a multi-rank save's pending publish

    # ------------------------------ save ------------------------------- #
    def save(self, step: int, tree: Any, blocking: bool = True) -> str:
        """Snapshot `tree` at `step`. The host copies are taken here; file
        IO happens inline (blocking) or on the writer thread. In a world
        of several ranks every rank calls it: each writes the shards it
        holds, rank 0 also a plain leaf, the manifest and the marker."""
        self.wait()
        rank, world = _world()
        host_data = []
        manifest: Dict[str, Any] = {"step": int(step), "leaves": {}}
        for path, arr in _leaf_paths(tree):
            if isinstance(arr, DTensor):
                shape, dtype_name, n, shards = _dtensor_shards(arr)
                mine = [(i, b, d) for i, b, d in shards if d is not None]
            else:
                shape, dtype_name, flat = _host_shards(arr)
                n = len(flat)
                shards = _once([(i, b, d) for i, (b, d) in enumerate(flat)])
                mine = shards if rank == 0 else []
            manifest["leaves"][path] = {
                "shape": shape, "dtype": dtype_name, "n_shards": n,
                "bounds": {str(i): b for i, b, _ in shards}}
            host_data.append((path, dtype_name, mine))

        final = os.path.join(self.dir, f"step_{int(step):010d}")
        tmp = final + ".tmp"
        if world > 1:
            import torch.distributed as dist
            if rank == 0:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
            dist.barrier()
        elif os.path.exists(tmp):
            shutil.rmtree(tmp)

        def write_shards():
            os.makedirs(tmp, exist_ok=True)
            for path, dtype_name, shards in host_data:
                for i, _, data in shards:
                    _save_npy(os.path.join(tmp, f"{_slug(path)}.{i}.npy"),
                              data, dtype_name)

        def publish():
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, _MARKER), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if world > 1:
            # the barrier before the publish runs on this thread, in
            # ``wait``: no collective on the writer thread
            self._publish = publish if rank == 0 else (lambda: None)
            if blocking:
                write_shards()
                self.wait()
            else:
                self._thread = threading.Thread(target=write_shards,
                                                daemon=True)
                self._thread.start()
        elif blocking:
            write_shards()
            publish()
        else:
            def write():
                write_shards()
                publish()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return final

    def wait(self) -> None:
        """Finish the outstanding save: join the writer thread and, in a
        world of several ranks, the barrier and rank 0's publish."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._publish is not None:
            import torch.distributed as dist
            publish, self._publish = self._publish, None
            dist.barrier()
            publish()
            dist.barrier()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ----------------------------- restore ----------------------------- #
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name, _MARKER)):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> Tuple[int, Any]:
        """Load a checkpoint. ``shardings``: optional tree of the SAME
        structure whose leaves are a device (the leaf placed whole), a
        ``LatticeMesh`` (the leaf, an (..., H, W) lattice, placed as a
        ``ShardedLattice`` on that mesh, whatever mesh saved it: the
        elastic restart) or a ``(DeviceMesh, placements)`` pair (the leaf
        a DTensor on that mesh, each rank keeping its shard); a leaf it
        does not name goes whole to the manager's device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{int(step):010d}")
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)

        shard_lookup = (dict(_leaf_paths(shardings))
                        if shardings is not None else {})

        items: Dict[str, Any] = {}
        for path, meta in manifest["leaves"].items():
            bf16 = meta["dtype"] == "bfloat16"
            full = np.zeros(meta["shape"], dtype=np.int16 if bf16
                            else np.dtype(meta["dtype"]))
            bounds_map = meta.get("bounds", {})
            for i in range(meta["n_shards"]):
                fn = os.path.join(d, f"{_slug(path)}.{i}.npy")
                if not os.path.exists(fn):
                    continue
                data = np.load(fn)
                if bf16:
                    data = data.view(np.int16)
                b = bounds_map.get(str(i), [])
                if b:
                    sl = tuple(slice(lo, hi) for lo, hi in b)
                    full[sl] = data
                else:
                    full[...] = data
            t = tensor_from_numpy(full, meta["dtype"])
            sh = shard_lookup.get(path)
            if isinstance(sh, LatticeMesh):
                items[path] = place(t, sh)
            elif isinstance(sh, tuple):
                items[path] = _place_on_mesh(t, *sh)
            else:
                items[path] = t.to(resolve_device(
                    self.device if sh is None else sh))
        return int(manifest["step"]), _unflatten(items)
