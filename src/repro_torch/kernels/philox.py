"""Philox-4x32-10 on tensors (port of ``repro.kernels.philox``).

The plain version of the generator that the fused CUDA kernels inline
(``csrc/escg_update_fused.cu``): uint32 words are held in int64 tensors and
the 32x32->64 multiplies are split into 16-bit halves so that no product
leaves the signed 64-bit range.

K5, ``philox_bits``/``philox_uniform``: bulk words in the reference's
layout. Counter i is (i, stream, 0, 0) under key ``seed``, its 4 words
interleaved in the output. The CUDA kernel is ``philox_bits_kernel`` in
``csrc/philox.cu``, one thread per counter; for ``philox_uniform`` it
writes the float32 ``(word >> 8) * 2^-24`` itself. The words come back
as ``torch.uint32``, whose numpy view is the reference's uint32 array
(PyTorch computes little on uint32; the plain version works in int64 and
converts at the end). A wrapper launches the kernel on the card and takes
the plain version only for ``device='cpu'``. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.device import DeviceLike, resolve_device
from ..core.threefry import MASK
from . import build

LAUNCHES = {"philox_bits": 0}

_LIB = "philox"

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


# ----------------------- K5: bulk words and uniforms ----------------------- #

def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.philox_bits
    if fn.argtypes is None:
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [ptr, ctypes.c_int64, u32, u32, u32, i32, i32, ptr]
        fn.restype = i32
    return lib


def _n_counters(n: int, block: int) -> int:
    if n < 0 or block < 1:
        raise ValueError(f"need n >= 0 and block >= 1, got n={n}, "
                         f"block={block}")
    # the reference rounds n up to 4 * block words; the counters past
    # ceil(n / 4) only make words that it then cuts off
    return -(-n // 4)


def _as_uint32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> a ``torch.uint32`` tensor."""
    signed = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return signed.to(torch.int32).view(torch.uint32)


def _unit_float(words: torch.Tensor) -> torch.Tensor:
    return (words >> 8).to(torch.float32) * 2.0 ** -24


def philox_words_plain(n: int, seed: Tuple[int, int], stream: int = 0,
                       block: int = 1024,
                       device: DeviceLike = "cpu") -> torch.Tensor:
    """Plain version of K5's words, as int64 holding uint32 values."""
    n_ctr = _n_counters(n, block)
    idx = torch.arange(n_ctr, dtype=torch.int64, device=device) & MASK
    c1 = torch.full_like(idx, int(stream) & MASK)
    zeros = torch.zeros_like(idx)
    words = philox_rounds(idx, c1, zeros, zeros, int(seed[0]) & MASK,
                          int(seed[1]) & MASK)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def philox_bits_plain(n: int, seed: Tuple[int, int], stream: int = 0,
                      block: int = 1024,
                      device: DeviceLike = "cpu") -> torch.Tensor:
    """Plain version of ``philox_bits`` (any device)."""
    return _as_uint32(philox_words_plain(n, seed, stream, block, device))


def philox_uniform_plain(n: int, seed: Tuple[int, int], stream: int = 0,
                         block: int = 1024,
                         device: DeviceLike = "cpu") -> torch.Tensor:
    """Plain version of ``philox_uniform`` (any device)."""
    return _unit_float(philox_words_plain(n, seed, stream, block, device))


def _launch(n: int, seed, stream: int, block: int, dev: torch.device,
            as_uniform: bool) -> torch.Tensor:
    n_ctr = _n_counters(n, block)
    out = torch.empty(4 * n_ctr, dtype=torch.float32 if as_uniform
                      else torch.uint32, device=dev)
    device, cuda_stream = build.launch_args(out)
    lib = _lib()
    err = lib.philox_bits(build.ptr(out), n_ctr, int(stream) & MASK,
                          int(seed[0]) & MASK, int(seed[1]) & MASK,
                          int(as_uniform), device, cuda_stream)
    build.check(lib, err, "philox_bits launch")
    LAUNCHES["philox_bits"] += 1
    return out[:n]


def philox_bits(n: int, seed: Tuple[int, int] = (0, 0), stream: int = 0,
                block: int = 1024,
                device: Optional[DeviceLike] = None) -> torch.Tensor:
    """``n`` Philox-4x32-10 words, (n,) ``torch.uint32`` on ``device``
    (default: the card). ``block`` is the reference's program width: it
    pads the counter range and does not change the words."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return philox_bits_plain(n, seed, stream, block, dev)
    return _launch(n, seed, stream, block, dev, as_uniform=False)


def philox_uniform(n: int, seed: Tuple[int, int] = (0, 0), stream: int = 0,
                   block: int = 1024,
                   device: Optional[DeviceLike] = None) -> torch.Tensor:
    """``n`` float32 uniforms in [0, 1): the top 24 bits of each word
    times 2^-24, computed in the kernel."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return philox_uniform_plain(n, seed, stream, block, dev)
    return _launch(n, seed, stream, block, dev, as_uniform=True)
