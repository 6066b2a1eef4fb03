"""A bit-exact twin of JAX's default PRNG (threefry2x32, partitionable).

The stochastic wire codecs (``int8``, ``int4``) are keyed by JAX PRNG keys
in the reference (``derive_key``, and ``fold_in(key, leaf_index)`` per
leaf). Drawing the same bits here makes the port's wire bytes identical to
the reference's for the same leaves and key. This module covers what the
codecs use, for ``jax_default_prng_impl = threefry2x32`` with
``jax_threefry_partitionable = True`` (the JAX default since 0.5):

* :func:`key` — ``jax.random.key(seed)``: key data ``(0, seed mod 2^32)``
  (with ``jax_enable_x64`` off JAX keeps the seed in 32 bits);
* :func:`fold_in` — ``jax.random.fold_in(key, data)``: the threefry hash
  of the counter pair ``(0, data)`` under ``key``;
* :func:`key_data` — ``jax.random.key_data(key)``: the two uint32 words;
* :func:`random_bits` / :func:`uniform` — 32-bit draws for a shape: the
  hash of the row-major element index, split into its high and low words,
  gives ``(bits1, bits2)``, and the draw is ``bits1 ^ bits2``; a float32
  uniform keeps the top 23 bits as the mantissa of a number in [1, 2) and
  subtracts 1;
* :func:`split` — ``jax.random.split(key, n)``: key ``i`` is the hash of
  the counter pair ``(0, i)``, the same as ``fold_in(key, i)``;
* :func:`normal` / :func:`laplace` — ``jax.random.normal`` /
  ``jax.random.laplace`` in float32, from the uniform on
  ``(nextafter(-1, 0), 1)`` the reference builds them on. The uniform is
  bit-equal; ``torch.erfinv`` and ``torch.log1p`` are not XLA's
  polynomials, so a draw agrees with the reference's within a few ulp.

A key is an int64 tensor of shape ``[2]`` holding the two uint32 words.
Batched forms take a ``[C, 2]`` tensor of keys, one a row, on the device
the draw runs on, and give row ``c`` what the one-key form gives for key
``c`` — ``jax.vmap`` of the reference's function: :func:`fold_in_batch`,
:func:`fold_in_many`, :func:`uniform_batch`, :func:`randint_batch`,
:func:`normal_batch`.
:func:`uniform_leaves` and :func:`normal_leaves` draw the leaves of a whole
tree for every row in one hash: element ``j`` of leaf ``i`` takes
``fold_in(key, i)`` and counter ``j``, as the reference's per-leaf
``fold_in(key, i)`` draws do.

Tensors hash int32 words (CUDA has no uint32 arithmetic): two's-complement
adds wrap mod 2^32 and the right shift of each rotation is masked to a
logical one, so the bits are the uint32 hash's, at half the bytes of int64
words (a large draw is memory-bound on the card). One key's words (Python
ints) hash in Python.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = torch.Tensor
IntOrTensor = Union[int, torch.Tensor]
DeviceLike = Optional[Union[str, torch.device]]


def threefry2x32(k1: int, k2: int, x1: int, x2: int) -> Tuple[int, int]:
    """The Threefry-2x32 hash (20 rounds) of one counter pair ``(x1, x2)``
    under the key ``(k1, k2)``, on Python ints (uint32 values)."""
    k1, k2 = int(k1) & _MASK, int(k2) & _MASK
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (int(x1) + ks[0]) & _MASK
    y = (int(x2) + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & _MASK
            y = (((y << r) | (y >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        y = (y + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, y


def _as_key(words: Sequence[int]) -> Key:
    return torch.tensor([int(w) & _MASK for w in words], dtype=torch.int64)


def key(seed: int) -> Key:
    """``jax.random.key(seed)``: data ``(0, seed mod 2^32)``."""
    return _as_key((0, int(seed)))


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``: ``data`` as uint32 (hashed on
    Python ints: one key is two words)."""
    return _as_key(threefry2x32(int(k[0]), int(k[1]), 0, int(data) & _MASK))


def key_data(k: Key) -> np.ndarray:
    """``jax.random.key_data(k)``: the two words as a uint32 array."""
    return k.cpu().numpy().astype(np.uint32)


# -- the tensor hash on int32 words -------------------------------------------
def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values (in int64) → the int32 with the same bits."""
    x = x.to(torch.int64) & _MASK
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits → their uint32 value in int64."""
    return x.to(torch.int64) & _MASK


def _ints32(data: Sequence[int], device: DeviceLike) -> torch.Tensor:
    vals = [int(d) & _MASK for d in data]
    return torch.tensor([v - (1 << 32) if v >> 31 else v for v in vals], dtype=torch.int32,
                        device=device)


def _rotl32(x: torch.Tensor, d: int) -> torch.Tensor:
    return (x << d) | ((x >> (32 - d)) & ((1 << d) - 1))


def _hash32(k1, k2, x1, x2):
    """:func:`threefry2x32` on broadcasting int32 tensors; the outputs carry
    the uint32 words' bits."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x1 + ks[0]
    y = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + y
            y = _rotl32(y, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        y = y + ks[(i + 2) % 3] + (i + 1)
    return x0, y


def _key_columns(keys: torch.Tensor):
    """The two words of ``[C, 2]`` keys as int32 ``[C, 1]`` columns."""
    k = _to_i32(keys)
    return k[:, 0:1], k[:, 1:2]


def _bits32(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[C, n]`` int32 draws: element ``j`` of row ``c`` hashes counter ``j``
    under ``keys[c]`` (high words 0: a draw has fewer than 2^31 elements)."""
    k1, k2 = _key_columns(keys)
    idx = torch.arange(int(n), dtype=torch.int32, device=keys.device)[None]
    bits1, bits2 = _hash32(k1, k2, 0, idx)
    return bits1 ^ bits2


def _to_unit32(bits: torch.Tensor) -> torch.Tensor:
    """int32 draws → float32 in [0, 1): the top 23 bits as a mantissa."""
    return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0


def _numel(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


# -- one key ------------------------------------------------------------------
def _row(k: Key, device: DeviceLike) -> torch.Tensor:
    k = k.reshape(1, 2)
    return k if device is None else k.to(device)


def random_bits(k: Key, shape: Sequence[int], device: DeviceLike = None) -> torch.Tensor:
    """32 random bits per element of ``shape`` (uint32 values as int64),
    ``jax.random.bits(k, shape, jnp.uint32)``."""
    shape = tuple(int(d) for d in shape)
    return _u32(_bits32(_row(k, device), _numel(shape))[0]).reshape(shape)


def uniform(k: Key, shape: Sequence[int], device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32: values in [0, 1)."""
    return uniform_batch(_row(k, device), shape)[0]


def split(k: Key, n: int) -> torch.Tensor:
    """``jax.random.split(k, n)``: an ``[n, 2]`` tensor of keys, row ``i``
    the hash of the counter pair ``(0, i)`` under ``k``."""
    return fold_in_many(k.reshape(1, 2), range(int(n)))[0]


# the open lower end of the reference's normal and laplace draws:
# nextafter(-1, 0) in float32, and the width hi - lo as float32 rounds it
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_WIDTH = float(np.float32(1.0) - np.float32(_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _symmetric(u: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=nextafter(-1, 0), maxval=1)``
    from the [0, 1) draw ``u``: ``max(lo, u * (hi - lo) + lo)``."""
    return torch.clamp_min(u * _WIDTH + _LO, _LO)


def normal(k: Key, shape: Sequence[int], device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in float32: ``sqrt(2)·erfinv(u)``."""
    return torch.erfinv(_symmetric(uniform(k, shape, device))) * _SQRT2


def laplace(k: Key, shape: Sequence[int], device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.laplace(k, shape)`` in float32:
    ``sign(u)·log1p(-|u|)``."""
    u = _symmetric(uniform(k, shape, device))
    return torch.sign(u) * torch.log1p(-torch.abs(u))


# -- batched forms: one key a row ---------------------------------------------
def fold_in_batch(keys: torch.Tensor, data: IntOrTensor) -> torch.Tensor:
    """``jax.vmap(jax.random.fold_in)``: row ``c`` is ``fold_in(keys[c],
    data)`` (``data`` an int, or a ``[C]`` tensor of one datum a row)."""
    k1, k2 = _key_columns(keys)
    d = (_to_i32(data).reshape(-1, 1) if isinstance(data, torch.Tensor)
         else _ints32([data], keys.device)[None])
    b1, b2 = _hash32(k1, k2, 0, d)
    return torch.cat([_u32(b1), _u32(b2)], dim=1)


def fold_in_many(keys: torch.Tensor, data: Sequence[int]) -> torch.Tensor:
    """``[C, len(data), 2]``: ``fold_in(keys[c], data[j])`` for every row and
    datum, in one hash."""
    k1, k2 = _key_columns(keys)
    b1, b2 = _hash32(k1, k2, 0, _ints32(list(data), keys.device)[None])
    return torch.stack([_u32(b1), _u32(b2)], dim=2)


def uniform_batch(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, shape))``: ``[C, *shape]``
    on the keys' device."""
    shape = tuple(int(d) for d in shape)
    return _to_unit32(_bits32(keys, _numel(shape))).reshape((keys.shape[0],) + shape)


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def randint_batch(keys: torch.Tensor, shape: Sequence[int], lo: int, hi: int) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))`` for the
    default int32 dtype: ``[C, *shape]`` int32 on the keys' device.

    As the reference draws it: the key splits in two, each half draws 32
    bits an element (higher, lower), and with ``span = hi - lo`` and
    ``multiplier = (2^16 mod span)^2 mod span`` the value is ``lo + ((higher
    mod span)·multiplier + lower mod span) mod span``, the sum wrapping as
    uint32 arithmetic does. The bounds clip to int32; ``hi <= lo`` gives
    ``lo``; ``hi`` past the int32 range widens the span by one (2^32 wraps to
    a span of 0, where a remainder leaves its operand as it is)."""
    shape = tuple(int(d) for d in shape)
    n = _numel(shape)
    k_hi, k_lo = fold_in_many(keys, (0, 1)).unbind(1)
    higher, lower = _u32(_bits32(k_hi, n)), _u32(_bits32(k_lo, n))
    minval = min(max(int(lo), _I32_MIN), _I32_MAX)
    maxval = min(max(int(hi), _I32_MIN), _I32_MAX)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    if int(hi) > _I32_MAX and maxval > minval:
        span = (span + 1) & _MASK

    def rem(x):
        return x if span == 0 else x % span

    mult = rem(rem(1 << 16) * rem(1 << 16) & _MASK)
    # (higher mod span) < 2^32 and mult < 2^16: the product fits in int64
    offset = rem((rem(higher) * mult + rem(lower)) & _MASK)
    return _to_i32(offset + minval).reshape((keys.shape[0],) + shape)


def normal_batch(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.normal(k, shape))``: ``[C, *shape]``."""
    return torch.erfinv(_symmetric(uniform_batch(keys, shape))) * _SQRT2


def _leaf_bits(keys: torch.Tensor, leaf_ids: Sequence[int],
               sizes: Sequence[int]) -> torch.Tensor:
    """``[C, sum(sizes)]`` int32 draws: the ``sizes[j]`` elements of leaf
    ``leaf_ids[j]`` under ``fold_in(keys[c], leaf_ids[j])``, counters from 0."""
    dev = keys.device
    k1, k2 = _key_columns(keys)
    lk1, lk2 = _hash32(k1, k2, 0, _ints32(leaf_ids, dev)[None])  # [C, L]: leaf keys
    counts = torch.tensor([int(s) for s in sizes], dtype=torch.int64, device=dev)
    starts = torch.cumsum(counts, 0) - counts
    total = int(sum(int(s) for s in sizes))
    idx = (torch.arange(total, dtype=torch.int64, device=dev)
           - torch.repeat_interleave(starts, counts)).to(torch.int32)[None]
    bits1, bits2 = _hash32(torch.repeat_interleave(lk1, counts, dim=1),
                           torch.repeat_interleave(lk2, counts, dim=1), 0, idx)
    return bits1 ^ bits2


def uniform_leaves(keys: torch.Tensor, leaf_ids: Sequence[int],
                   sizes: Sequence[int]) -> torch.Tensor:
    """One hash for a whole tree: ``[C, sum(sizes)]`` f32 in [0, 1), the
    columns of leaf ``leaf_ids[j]`` equal to ``uniform_batch(fold_in_batch(
    keys, leaf_ids[j]), (sizes[j],))``."""
    return _to_unit32(_leaf_bits(keys, leaf_ids, sizes))


def normal_leaves(keys: torch.Tensor, leaf_ids: Sequence[int],
                  sizes: Sequence[int]) -> torch.Tensor:
    """:func:`uniform_leaves`'s layout for ``jax.random.normal`` draws."""
    return torch.erfinv(_symmetric(uniform_leaves(keys, leaf_ids, sizes))) * _SQRT2
