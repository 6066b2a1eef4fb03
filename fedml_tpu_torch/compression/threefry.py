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
Every word is held in an int64 tensor and masked to 32 bits after each
addition, so the hash runs on any device PyTorch has (CUDA has no uint32
arithmetic).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = torch.Tensor
IntOrTensor = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1: IntOrTensor, k2: IntOrTensor, x1: IntOrTensor,
                 x2: IntOrTensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``: two arrays of uint32 values as int64 (or
    two Python ints, for Python-int counters)."""
    if isinstance(k1, torch.Tensor):
        k1, k2 = int(k1), int(k2)
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ _PARITY) & _MASK)
    x0 = (x1 + ks[0]) & _MASK
    y = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & _MASK
            y = _rotl(y, r) ^ x0
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
    return _as_key(threefry2x32(k[0], k[1], 0, int(data) & _MASK))


def key_data(k: Key) -> np.ndarray:
    """``jax.random.key_data(k)``: the two words as a uint32 array."""
    return k.cpu().numpy().astype(np.uint32)


def random_bits(k: Key, shape: Sequence[int],
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.Tensor:
    """32 random bits per element of ``shape`` (uint32 values as int64),
    ``jax.random.bits(k, shape, jnp.uint32)``."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    bits1, bits2 = threefry2x32(k[0], k[1], idx >> 32, idx & _MASK)
    return (bits1 ^ bits2).reshape(shape)


def uniform(k: Key, shape: Sequence[int],
            device: Optional[Union[str, torch.device]] = None
            ) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32: values in [0, 1)."""
    bits = random_bits(k, shape, device)
    mant = (bits >> 9) | 0x3F800000  # < 2^30: fits int32
    return mant.to(torch.int32).view(torch.float32) - 1.0


def split(k: Key, n: int) -> torch.Tensor:
    """``jax.random.split(k, n)``: an ``[n, 2]`` tensor of keys, row ``i``
    the hash of the counter pair ``(0, i)`` under ``k``."""
    idx = torch.arange(int(n), dtype=torch.int64)
    b1, b2 = threefry2x32(k[0], k[1], torch.zeros_like(idx), idx)
    return torch.stack([b1, b2], dim=1)


# the open lower end of the reference's normal and laplace draws:
# nextafter(-1, 0) in float32, and the width hi - lo as float32 rounds it
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_WIDTH = float(np.float32(1.0) - np.float32(_LO))


def _symmetric_uniform(k: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=nextafter(-1, 0), maxval=1)``:
    ``max(lo, u * (hi - lo) + lo)`` with ``u`` the [0, 1) draw."""
    u = uniform(k, shape, device)
    return torch.clamp_min(u * _WIDTH + _LO, _LO)


def normal(k: Key, shape: Sequence[int],
           device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in float32: ``sqrt(2)·erfinv(u)``."""
    u = _symmetric_uniform(k, shape, device)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2.0)))


def laplace(k: Key, shape: Sequence[int],
            device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """``jax.random.laplace(k, shape)`` in float32:
    ``sign(u)·log1p(-|u|)``."""
    u = _symmetric_uniform(k, shape, device)
    return torch.sign(u) * torch.log1p(-torch.abs(u))
