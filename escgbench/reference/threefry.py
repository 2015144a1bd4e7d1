"""Threefry-2x32 (20 rounds) as ``jax.random`` uses it under the
non-partitionable scheme, frozen for the benchmark's reference.

A key is two uint32 words. ``bits(keys, n)`` hashes the counters
0..n-1 split into two halves (an odd count padded with one zero word),
``split(keys, k)`` is ``bits(keys, 2k)`` read as k keys, ``fold_in(keys,
d)`` hashes the pair (0, d). ``uniform`` keeps the top 23 bits as a
float32 mantissa in [1, 2) less 1; ``randint`` folds two words per value
into [lo, hi) by ``jax.random.randint``'s span and multiplier.

Tensors hold uint32 values in int64 and take keys of shape (..., 2) that
broadcast against the counters, so many lanes hash at once on any device.
The per-MCS key chain hashes single keys, which Python integers do faster
than tensors: ``hash_words``, ``split_words``, ``fold_in_words``.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _hash(k0, k1, x0, x1):
    """The 20 rounds on (x0, x1) under the key (k0, k1): Python integers
    or int64 tensors that broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _multiplier(span: int) -> int:
    """2^32 mod span as ``jax.random.randint`` forms it: the square of
    2^16 mod span taken in uint32, so it wraps, then mod span."""
    return ((2 ** 16 % span) ** 2 & MASK) % span


# ------------------------- single keys, Python ints ------------------------ #

def hash_words(key, counts):
    """Threefry of the list ``counts`` under ``key`` (two ints)."""
    n = len(counts)
    padded = list(counts) + [0] * (n % 2)
    half = len(padded) // 2
    out0, out1 = [], []
    for a, b in zip(padded[:half], padded[half:]):
        y0, y1 = _hash(key[0], key[1], a, b)
        out0.append(y0)
        out1.append(y1)
    return (out0 + out1)[:n]


def split_words(key, num=2):
    w = hash_words(key, range(2 * num))
    return [(w[2 * i], w[2 * i + 1]) for i in range(num)]


def fold_in_words(key, data):
    return tuple(hash_words(key, [0, int(data) & MASK]))


def randint_words(key, n, lo, hi):
    """``randint`` of n values with per-value bounds ``hi`` (a list)."""
    k1, k2 = split_words(key)
    higher, lower = hash_words(k1, range(n)), hash_words(k2, range(n))
    out = []
    for h, l, top in zip(higher, lower, hi):
        span = (top - lo) & MASK if top > lo else 1
        mult = _multiplier(span)
        out.append(lo + (((h % span) * mult + l % span) & MASK) % span)
    return out


# ----------------------------- lanes, tensors ------------------------------ #

def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) words of each key of ``keys`` (..., 2)."""
    half = (n + 1) // 2
    c = torch.arange(2 * half, dtype=torch.int64, device=keys.device)
    if n % 2:
        c[-1] = 0
    y0, y1 = _hash(keys[..., 0:1], keys[..., 1:2], c[:half], c[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    return bits(keys, 2 * num).reshape(keys.shape[:-1] + (num, 2))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    y0, y1 = _hash(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def to_unit(words: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 23 bits."""
    m = ((words >> 9) | 0x3F800000).to(torch.int32)
    return m.view(torch.float32) - 1.0


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    return to_unit(bits(keys, n))


def randint(keys: torch.Tensor, n: int, lo: int, hi: int) -> torch.Tensor:
    """(..., n) int64 in [lo, hi) with scalar bounds below 2^31 apart, so
    that the product of two residues stays inside int64."""
    span = (hi - lo) & MASK if hi > lo else 1
    if span >= 2 ** 31:
        raise ValueError(f"span {span} too wide for the int64 fold")
    mult = _multiplier(span)
    sub = split(keys)
    higher = bits(sub[..., 0, :], n)
    lower = bits(sub[..., 1, :], n)
    return lo + (((higher % span) * mult + lower % span) & MASK) % span
