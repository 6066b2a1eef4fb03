"""Lagrange coded computing (LCC), the coding core of LightSecAgg and of
Shamir reconstruction — counterpart of ``fedml_tpu/core/mpc/lcc.py``.

Coefficients and encode/decode are matrix ops over int64 field vectors on
the host. The hot path is the port's own C++ library
(``ops/csrc/lcc.cpp``, compiled with the host C++ compiler into
``build/fedml_tpu_torch/`` at first use); a failed build raises with the
compiler's message. The numpy twin is the plain version: it runs only
when the caller asks for it (``use_native=False``), and the tests hold
the two against each other bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from fedml_tpu_torch.core.mpc.finite import DEFAULT_PRIME, mulmod

_bound = None


def _native() -> ctypes.CDLL:
    """The LCC library, built and bound once per process."""
    global _bound
    if _bound is None:
        from fedml_tpu_torch.ops import _build

        lib = _build.load_host("lcc")
        p64 = ctypes.POINTER(ctypes.c_int64)
        lib.lcc_lagrange_coeffs.restype = ctypes.c_int
        lib.lcc_lagrange_coeffs.argtypes = [p64, ctypes.c_int64, p64, ctypes.c_int64,
                                            ctypes.c_int64, p64]
        lib.lcc_field_matmul.restype = None
        lib.lcc_field_matmul.argtypes = [p64, p64, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64, p64]
        _bound = lib
    return _bound


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_available() -> bool:
    """Whether the C++ library builds and loads here (raises nothing)."""
    try:
        _native()
        return True
    except (OSError, RuntimeError):
        return False


# -- coefficients ---------------------------------------------------------------

def gen_lagrange_coeffs(eval_pts: np.ndarray, target_pts: np.ndarray,
                        p: int = DEFAULT_PRIME,
                        use_native: Optional[bool] = None) -> np.ndarray:
    """U[i, j] = L_j(target_i) over GF(p): interpolate from ``eval_pts`` to
    ``target_pts``. ``use_native=False`` runs the numpy twin."""
    eval_pts = np.mod(np.asarray(eval_pts, np.int64), p)
    target_pts = np.mod(np.asarray(target_pts, np.int64), p)
    if len(np.unique(eval_pts)) != len(eval_pts):
        raise ValueError("evaluation points must be distinct mod p")
    if use_native is not False:
        out = np.zeros((len(target_pts), len(eval_pts)), np.int64)
        rc = _native().lcc_lagrange_coeffs(
            _ptr(np.ascontiguousarray(eval_pts)), len(eval_pts),
            _ptr(np.ascontiguousarray(target_pts)), len(target_pts), p, _ptr(out))
        if rc != 0:
            raise ValueError("zero denominator in Lagrange coefficients")
        return out
    n_e, n_t = len(eval_pts), len(target_pts)
    out = np.zeros((n_t, n_e), np.int64)
    for j in range(n_e):
        num = np.ones(n_t, np.int64)
        den = np.int64(1)
        for m in range(n_e):
            if m == j:
                continue
            num = mulmod(num, (target_pts - eval_pts[m]) % p, p)
            den = int(mulmod(np.int64(den), (eval_pts[j] - eval_pts[m]) % p, p))
        inv = pow(int(den) % p, p - 2, p)
        out[:, j] = mulmod(num, np.int64(inv), p)
    return out


def field_matmul(coeffs: np.ndarray, X: np.ndarray, p: int = DEFAULT_PRIME,
                 use_native: Optional[bool] = None) -> np.ndarray:
    """coeffs [n_out, n_in] × X [n_in, dim] over GF(p)."""
    coeffs = np.mod(np.asarray(coeffs, np.int64), p)
    X = np.mod(np.asarray(X, np.int64), p)
    n_out, n_in = coeffs.shape
    dim = X.shape[1]
    if use_native is not False:
        out = np.zeros((n_out, dim), np.int64)
        _native().lcc_field_matmul(_ptr(np.ascontiguousarray(coeffs)),
                                   _ptr(np.ascontiguousarray(X)), n_out, n_in, dim, p,
                                   _ptr(out))
        return out
    out = np.zeros((n_out, dim), np.int64)
    for j in range(n_in):
        out = (out + mulmod(np.broadcast_to(coeffs[:, j:j + 1], (n_out, dim)), X[j], p)) % p
    return out


# -- LCC encode/decode -----------------------------------------------------------

def lcc_encode(X: np.ndarray, eval_pts: np.ndarray, target_pts: np.ndarray,
               p: int = DEFAULT_PRIME, use_native: Optional[bool] = None) -> np.ndarray:
    """Encode rows of X (defined at ``eval_pts``) to ``target_pts``: X is
    [K(+T), dim] data (+ noise) rows, the result [N, dim] coded rows."""
    U = gen_lagrange_coeffs(eval_pts, target_pts, p, use_native)
    return field_matmul(U, X, p, use_native)


def lcc_decode(evals: np.ndarray, eval_pts: np.ndarray, target_pts: np.ndarray,
               p: int = DEFAULT_PRIME, use_native: Optional[bool] = None) -> np.ndarray:
    """Recover the values at ``target_pts`` from evaluations at ``eval_pts``."""
    U = gen_lagrange_coeffs(eval_pts, target_pts, p, use_native)
    return field_matmul(U, evals, p, use_native)
