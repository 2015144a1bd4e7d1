"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]
# one device, or a sequence of them for the multi-device engine
Devices = Union[DeviceLike, Sequence[DeviceLike]]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises; the
    port never carries on on the CPU unless the caller passed it."""
    if isinstance(device, (list, tuple)):
        raise ValueError(
            f"one device is wanted here, got the sequence {device!r}; a "
            "sequence of devices lays out the mesh of the multi-device "
            "engine 'sharded'")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the card by default and CUDA is not "
            "available here; pass device='cpu' to run the plain PyTorch "
            "path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


def resolve_devices(devices: Optional[Devices] = None
                    ) -> Tuple[torch.device, ...]:
    """The devices of a mesh, in order. ``None`` means every visible card,
    ``cuda:0`` .. ``cuda:n-1``; one device gives one entry; a sequence
    gives one entry per item and may name a device more than once. A card
    named without an index is the current card."""
    if devices is None:
        resolve_device("cuda")          # raises without a card
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if not isinstance(devices, (list, tuple)):
        devices = (devices,)
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return tuple(out)
