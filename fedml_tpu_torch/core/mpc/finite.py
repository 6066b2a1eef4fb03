"""Finite-field arithmetic and fixed-point quantization for secure
aggregation — counterpart of ``fedml_tpu/core/mpc/finite.py``: int64 numpy
on the host, Fermat inverses, prime ``2^31 - 1`` by default (products of two
residues fit uint64).

A port tree (flat ``{path: tensor}``) is flattened in the reference's leaf
order with each leaf in the reference's layout
(``models/convert.to_reference_layout``), so the finite vector is element
for element the one a JAX peer builds from the same model.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fedml_tpu_torch.models.convert import _from_ref, _to_ref
from fedml_tpu_torch.utils.tree import Tree, leaf_order

DEFAULT_PRIME = (1 << 31) - 1  # 2147483647, Mersenne prime


def modular_inv(a: int, p: int = DEFAULT_PRIME) -> int:
    """a^-1 mod p for prime p (Fermat)."""
    return pow(int(a) % p, p - 2, p)


def mod_inv_vec(a: np.ndarray, p: int = DEFAULT_PRIME) -> np.ndarray:
    return np.array([pow(int(x) % p, p - 2, p) for x in np.ravel(a)],
                    dtype=np.int64).reshape(np.shape(a))


def mulmod(a: np.ndarray, b: np.ndarray, p: int = DEFAULT_PRIME) -> np.ndarray:
    """(a*b) mod p elementwise without overflow (p < 2^31 ⇒ fits uint64)."""
    return ((a.astype(np.uint64) * (np.asarray(b, np.int64) % p).astype(np.uint64))
            % np.uint64(p)).astype(np.int64)


def quantize(x: np.ndarray, q_bits: int = 16, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Fixed point → field element, round(x·2^q); negatives at the top of
    the field (p - |v|)."""
    scaled = np.round(np.asarray(x, np.float64) * (1 << q_bits)).astype(np.int64)
    return np.mod(scaled, p).astype(np.int64)


def dequantize(xq: np.ndarray, q_bits: int = 16, p: int = DEFAULT_PRIME,
               n_summands: int = 1) -> np.ndarray:
    """Field element → float32 through the symmetric half-field split.

    Correct iff the true (summed) value ``v`` has ``|v| · 2^q_bits < p/2``;
    no check can see a wrap, so the caller sizes ``q_bits``/``p``
    (``n_summands`` documents how many values were summed)."""
    xq = np.mod(np.asarray(xq, np.int64), p)
    del n_summands
    neg = xq > (p - 1) // 2
    signed = np.where(neg, xq.astype(np.float64) - p, xq.astype(np.float64))
    return (signed / (1 << q_bits)).astype(np.float32)


def _ref_leaves(tree: Tree):
    """(path, host numpy leaf in the reference's layout) in leaf order."""
    return [(k, np.asarray(_to_ref(k, tree[k].detach().to("cpu")).numpy()))
            for k in leaf_order(tree)]


def tree_to_finite(tree: Tree, q_bits: int = 16,
                   p: int = DEFAULT_PRIME) -> Tuple[np.ndarray, Tree]:
    """Flatten a port tree to one int64 field vector (+ the tree itself as
    the template), in the reference's order and layout."""
    leaves = _ref_leaves(tree)
    flat = (np.concatenate([quantize(a, q_bits, p).ravel() for _, a in leaves])
            if leaves else np.zeros(0, np.int64))
    return flat, tree


def finite_to_tree(flat: np.ndarray, tree_like: Tree, q_bits: int = 16,
                   p: int = DEFAULT_PRIME, n_summands: int = 1) -> Tree:
    """The inverse of :func:`tree_to_finite`: a port tree of float32 CPU
    tensors in the port's layout (each leaf dequantized in the reference's
    layout, as the reference's leaves are)."""
    out, off = {}, 0
    for k in leaf_order(tree_like):
        shape = tuple(_to_ref(k, tree_like[k]).shape)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        leaf = dequantize(flat[off:off + n], q_bits, p, n_summands).reshape(shape)
        out[k] = _from_ref(k, torch.from_numpy(leaf)).contiguous()
        off += n
    return out
