"""Philox-4x32-10 as the fused sweep draws its proposals, frozen for the
benchmark's reference.

Counter (c0, c1, c2, c3) under the key (k0, k1): ten rounds, each taking
the 64-bit products of c0 by 0xD2511F53 and of c2 by 0xCD9E8D57, and
bumping the key by the Weyl constants between rounds. uint32 values live
in int64 tensors; each product is formed from the multiplier's two
16-bit halves so that nothing leaves the signed 64-bit range.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85


def _mul_hi_lo(a: torch.Tensor, m: int):
    lo16 = a * (m & 0xFFFF)           # below 2^48
    hi16 = a * (m >> 16)              # below 2^48
    hi = (hi16 + (lo16 >> 16)) >> 16
    lo = (lo16 + ((hi16 & 0xFFFF) << 16)) & MASK
    return hi, lo


def philox(c0, c1, c2, c3, k0, k1):
    """The four output words of Philox-4x32-10; every argument a tensor
    or an int, broadcasting."""
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK
            k1 = (k1 + W1) & MASK
        hi0, lo0 = _mul_hi_lo(c0, M0)
        hi1, lo1 = _mul_hi_lo(c2, M1)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)
    return c0, c1, c2, c3
