"""Threefry-2x32 keys and samplers, bit-identical to ``jax.random``.

The reference drives every random choice outside the fused kernels
through ``jax.random`` with the threefry2x32 generator under the
non-partitionable scheme (``jax.threefry_partitionable(False)``, the
scheme the goldens were frozen under; DESIGN.md §3). This module
reproduces that scheme on PyTorch tensors so that the same seed gives the
same lattice and the same per-MCS schedule:

* a key is an int64 tensor of shape (2,) holding two uint32 words;
* ``threefry_2x32`` hashes a flat counter array split into two halves,
  padded with one zero word when its length is odd;
* ``split(key, n)`` hashes the counters 0..2n-1, ``fold_in(key, d)``
  hashes the seed key (0, d), ``random_bits`` hashes 0..size-1;
* ``uniform`` keeps the top 23 bits as a float32 mantissa in [1, 2) and
  subtracts 1; ``normal`` maps uniforms on (-1, 1) through XLA's
  ``erf_inv`` polynomial; ``randint`` draws two words per value and folds
  them with the span/multiplier scheme of ``jax.random.randint``.

uint32 arithmetic runs on int64 tensors masked back to 32 bits. The
per-MCS key chain keeps its keys on the host and hashes them with Python
integer words (``_hash``); a sampler draws on the key's device unless it
is given another.

The ``*_batch`` functions are ``jax.vmap`` of the scalar ones over a
leading batch of keys (or, for ``fold_in_batch``, of data words): the key
words become tensors that broadcast against the shared counter array, so
one batch of tile keys and all their draws stay on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from .device import DeviceLike

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for uint32 values held in int64, without the
    signed overflow a plain 32x32-bit product could reach."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def _words(key: torch.Tensor) -> Tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"a key has shape (2,), got {tuple(key.shape)}")
    k0, k1 = (int(v) & MASK for v in key.tolist())
    return k0, k1


def PRNGKey(seed: int) -> torch.Tensor:
    """The raw key of ``jax.random.PRNGKey(seed)``: the seed is taken as a
    32-bit integer, so the key is (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The two uint32 words of a key (raw keys are their own data)."""
    return key


def _hash(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(5):
        for rot in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Threefry-2x32 of ``count`` (int64 tensor of uint32 values, any
    shape) under ``key``; the result has the shape and device of
    ``count``."""
    k0, k1 = _words(key)
    flat = count.reshape(-1).to(torch.int64)
    odd = flat.numel() % 2
    if odd:
        flat = torch.cat([flat, flat.new_zeros(1)])
    x0, x1 = flat.chunk(2)
    out = torch.cat(_hash(k0, k1, x0, x1))
    if odd:
        out = out[:-1]
    return out.reshape(count.shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, shape (num, 2)."""
    counts = torch.arange(2 * num, dtype=torch.int64, device=key.device)
    return threefry_2x32(key, counts).reshape(num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key from ``key`` and a 32-bit integer."""
    seed = torch.tensor([0, int(data) & MASK], dtype=torch.int64,
                        device=key.device)
    return threefry_2x32(key, seed)


def _check_size(size: int) -> None:
    if size >= MASK:
        raise NotImplementedError(
            "more than 2^32 - 2 words from one key takes the reference's "
            "blocked scheme, which is not ported")


def random_bits(key: torch.Tensor, shape: Shape,
                device: Optional[DeviceLike] = None) -> torch.Tensor:
    """uint32 words (as int64) of the given shape on ``device`` (default:
    the key's device)."""
    shape = _shape(shape)
    size = math.prod(shape)
    _check_size(size)
    device = key.device if device is None else device
    counts = torch.arange(size, dtype=torch.int64, device=device)
    return threefry_2x32(key, counts).reshape(shape)


def _to_unit_float(bits: torch.Tensor, minval: float,
                   maxval: float) -> torch.Tensor:
    """``jax.random.uniform``'s map of uint32 words to float32: the top 23
    bits as a mantissa in [1, 2), minus 1, scaled to [minval, maxval)."""
    mantissa = (bits >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0,
            device: Optional[DeviceLike] = None) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), as ``jax.random.uniform``, on
    ``device`` (default: the key's device)."""
    return _to_unit_float(random_bits(key, shape, device), minval, maxval)


# ``jax.random.normal``'s open interval for its uniforms: the float32 after
# -1 towards 0, up to 1
_NORMAL_LO = -1.0 + 2.0 ** -24
_SQRT2 = math.sqrt(2.0)
# counter pairs hashed at once by ``normal``: int64 temporaries of a slice,
# never of a whole stacked leaf
_NORMAL_SLICE = 1 << 23
# the most counters one key hashes in the reference's ``_random_bits``
_BLOCK = MASK
# XLA's float32 erf_inv (Giles' approximation): the polynomial's
# coefficients in w = -log1p(-x^2) below 5, then in sqrt(w) above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA computes it (the same
    polynomial in the same order); ``log1p`` and ``sqrt`` are PyTorch's,
    so a value may differ from XLA's by a few ulps."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape,
           device: Optional[DeviceLike] = None, std: Optional[float] = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normals as ``jax.random.normal(key, shape, float32)``:
    ``sqrt(2) * erf_inv(u)`` of uniforms ``u`` in ``[nextafter(-1, 0),
    1)``, times ``std`` when given (in float32), cast to ``dtype``, on
    ``device`` (default: the key's device).

    The uniform bits are threefry's exactly; ``erf_inv`` may put a value a
    few float32 ulps from the reference's. The counters are hashed in
    slices of pairs: counter i pairs with i + ceil(n/2) (the odd count's
    last pair with a zero word), so each slice fills two ranges of the
    output. From ``_BLOCK`` (2^32 - 1) words on, the reference's blocked
    scheme: ``split(key, nblocks + 1)``, a whole block of ``_BLOCK``
    counters from each of the first keys, the rest from the last."""
    shape = _shape(shape)
    n = math.prod(shape)
    device = key.device if device is None else device
    out = torch.empty(n, dtype=dtype, device=device)
    sqrt2 = torch.tensor(_SQRT2, dtype=torch.float32, device=device)
    if std is not None:
        std = torch.tensor(std, dtype=torch.float32, device=device)
    nblocks, rem = divmod(n, _BLOCK)
    if not nblocks:
        _fill_normal(out, key, sqrt2, std)
    else:
        keys = split(key, nblocks + 1)
        for b in range(nblocks):
            _fill_normal(out[b * _BLOCK:(b + 1) * _BLOCK], keys[b], sqrt2,
                         std)
        _fill_normal(out[nblocks * _BLOCK:], keys[nblocks], sqrt2, std)
    return out.reshape(shape)


def _fill_normal(out: torch.Tensor, key: torch.Tensor, sqrt2: torch.Tensor,
                 std: Optional[torch.Tensor]) -> None:
    """``out`` (1-D) := the normals of counters 0..len(out) from ``key``."""
    n = out.numel()
    device = out.device
    k0, k1 = _words(key)
    half = (n + 1) // 2
    for lo in range(0, half, _NORMAL_SLICE):
        hi = min(lo + _NORMAL_SLICE, half)
        x0 = torch.arange(lo, hi, dtype=torch.int64, device=device)
        x1 = x0 + half
        if n % 2 and hi == half:
            x1[-1] = 0
        for dst, bits in zip((lo, lo + half), _hash(k0, k1, x0, x1)):
            vals = erf_inv(_to_unit_float(bits, _NORMAL_LO, 1.0)) * sqrt2
            if std is not None:
                vals = vals * std
            m = min(hi - lo, n - dst)
            out[dst:dst + m] = vals[:m]


def _as_int32_range(v, shape, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int64, device=device)
    t = t.clamp(-(2 ** 31), 2 ** 31 - 1)
    return torch.broadcast_to(t, shape)


def _fold_span(higher, lower, lo, span, multiplier) -> torch.Tensor:
    """``jax.random.randint``'s fold of two uint32 draws into [lo, lo +
    span), as int32."""
    offset = mul32(higher % span, multiplier) + (lower % span)
    offset = (offset & MASK) % span
    out = (lo + offset + 2 ** 31) & MASK
    return (out - 2 ** 31).to(torch.int32)


def randint(key: torch.Tensor, shape: Shape, minval, maxval,
            device: Optional[DeviceLike] = None) -> torch.Tensor:
    """int32 values in [minval, maxval), as ``jax.random.randint`` with
    ``dtype=int32``; ``minval``/``maxval`` may be arrays that broadcast to
    ``shape``. Drawn on ``device`` (default: the key's device)."""
    shape = _shape(shape)
    device = key.device if device is None else device
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    lo = _as_int32_range(minval, shape, device)
    hi = _as_int32_range(maxval, shape, device)
    span = (hi - lo) & MASK
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    multiplier = (2 ** 16) % span
    multiplier = mul32(multiplier, multiplier) % span
    return _fold_span(higher, lower, lo, span, multiplier)


# ------------------------- batches of keys (vmap) ------------------------- #

def _hash_batch(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                x1: torch.Tensor):
    """``_hash`` with tensor key words that broadcast against the counter
    halves ``x0``/``x1``; a separate function so that the host chain's
    scalar hash keeps its Python-integer keys."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for block in range(5):
        for rot in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + (ks[(block + 2) % 3] + (block + 1))) & MASK
    return x0, x1


def _threefry_batch(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``vmap(lambda k: threefry_2x32(k, arange(n)))(keys)``: keys (..., 2)
    int64, result (..., n) on the keys' device. Every key hashes the same
    counters, padded with one zero word when ``n`` is odd."""
    if keys.shape[-1:] != (2,):
        raise ValueError(f"keys have shape (..., 2), got "
                         f"{tuple(keys.shape)}")
    half = (n + 1) // 2
    counts = torch.arange(2 * half, dtype=torch.int64, device=keys.device)
    if n % 2:
        counts[-1] = 0
    x0, x1 = _hash_batch(keys[..., 0:1], keys[..., 1:2], counts[:half],
                         counts[half:])
    return torch.cat([x0, x1], dim=-1)[..., :n]


def fold_in_batch(key: torch.Tensor, data) -> torch.Tensor:
    """``vmap(lambda d: fold_in(key, d))(data)`` for one key (2,) and data
    a tensor of 32-bit integers, giving keys (*data.shape, 2); or
    ``vmap(fold_in)`` over a batch of keys (..., 2) against data (a tensor
    or an integer) that broadcasts with ``key.shape[:-1]``, giving keys
    (*broadcast shape, 2). On the key's device."""
    if key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"keys have shape (..., 2), got "
                         f"{tuple(key.shape)}")
    d = torch.as_tensor(data).to(device=key.device, dtype=torch.int64) & MASK
    x0, x1 = _hash_batch(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    x0, x1 = torch.broadcast_tensors(x0, x1)
    return torch.stack([x0, x1], dim=-1)


def split_batch(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``vmap(lambda k: split(k, num))(keys)``: keys (..., 2) -> (..., num,
    2)."""
    return _threefry_batch(keys, 2 * num).reshape(
        keys.shape[:-1] + (num, 2))


def random_bits_batch(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``vmap(lambda k: random_bits(k, (n,)))(keys)``: (..., n) uint32
    words as int64."""
    _check_size(n)
    return _threefry_batch(keys, n)


def uniform_batch(keys: torch.Tensor, n: int, minval: float = 0.0,
                  maxval: float = 1.0) -> torch.Tensor:
    """``vmap(lambda k: uniform(k, (n,), minval, maxval))(keys)``."""
    return _to_unit_float(random_bits_batch(keys, n), minval, maxval)


def randint_batch(keys: torch.Tensor, n: int, minval,
                  maxval) -> torch.Tensor:
    """``vmap(lambda k: randint(k, (n,), minval, maxval))(keys)``: (..., n)
    int32, the same two draws per value and the same span/multiplier fold
    as ``randint``. The bounds are integers, or a ``maxval`` that is a
    sequence of n integers, one bound per value."""
    sub = split_batch(keys)
    if not isinstance(maxval, int):
        # one bound per value (the torus shift's (th, tw)), as randint
        # takes an array maxval
        shape = (n,)
        lo = _as_int32_range(minval, shape, keys.device)
        hi = _as_int32_range(maxval, shape, keys.device)
        span = (hi - lo) & MASK
        span = torch.where(hi <= lo, torch.ones_like(span), span)
        multiplier = (2 ** 16) % span
        multiplier = mul32(multiplier, multiplier) % span
        higher = random_bits_batch(sub[..., 0, :], n)
        lower = random_bits_batch(sub[..., 1, :], n)
        return _fold_span(higher, lower, lo, span, multiplier)
    lo = max(-(2 ** 31), min(int(minval), 2 ** 31 - 1))
    hi = max(-(2 ** 31), min(int(maxval), 2 ** 31 - 1))
    span = (hi - lo) & MASK if hi > lo else 1
    multiplier = (2 ** 16) % span
    multiplier = (multiplier * multiplier) % 2 ** 32 % span
    higher = random_bits_batch(sub[..., 0, :], n)
    lower = random_bits_batch(sub[..., 1, :], n)
    return _fold_span(higher, lower, lo, span, multiplier)
