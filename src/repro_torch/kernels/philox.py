"""Philox-4x32-10 on tensors (port of ``repro.kernels.philox``).

The plain version of the generator that the fused CUDA kernels inline
(``csrc/escg_update_fused.cu``): uint32 words are held in int64 tensors and
the 32x32->64 multiplies are split into 16-bit halves so that no product
leaves the signed 64-bit range.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.threefry import MASK

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10


def _mulhilo(a: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of the 32x32->64 product ``a * b``."""
    x = a * (b & 0xFFFF)                 # < 2^48
    y = a * (b >> 16)                    # < 2^48
    hi = (y + (x >> 16)) >> 16
    lo = (((y & 0xFFFF) << 16) + x) & MASK
    return hi, lo


def philox_rounds(c0, c1, c2, c3, k0: int, k1: int):
    """10 Philox rounds on uint32 values in int64 tensors; returns the 4
    output words."""
    for r in range(ROUNDS):
        if r > 0:
            k0 = (k0 + PHILOX_W0) & MASK
            k1 = (k1 + PHILOX_W1) & MASK
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)
    return c0, c1, c2, c3


def philox_proposal_fields(idx: torch.Tensor, round_idx: int, k0: int,
                           k1: int, interior: int, nbhd: int):
    """Map Philox counters to one ESCG proposal each (the fused-kernel
    counter layout, DESIGN.md §3): counter = (idx, round_idx, 0, 0) with
    ``idx`` the global proposal index (global tile id * K + j), key =
    ``(k0, k1)``. The four output words become (cell, dirn, u_act, u_dom):
    uniform ints by modulus, uniform floats from the top 24 bits."""
    idx = idx.to(torch.int64) & MASK
    c1 = torch.full_like(idx, int(round_idx) & MASK)
    zeros = torch.zeros_like(idx)
    x0, x1, x2, x3 = philox_rounds(idx, c1, zeros, zeros, int(k0) & MASK,
                                   int(k1) & MASK)
    cell = (x0 % interior).to(torch.int32)
    dirn = (x1 % nbhd).to(torch.int32)
    u_act = (x2 >> 8).to(torch.float32) * 2.0 ** -24
    u_dom = (x3 >> 8).to(torch.float32) * 2.0 ** -24
    return cell, dirn, u_act, u_dom
