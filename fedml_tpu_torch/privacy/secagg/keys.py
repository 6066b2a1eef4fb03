"""X25519 key agreement for the pair seeds — counterpart of
``fedml_tpu/privacy/secagg/keys.py``.

The ``cryptography`` package's X25519 is preferred where it imports (the
constant-time path); otherwise a pure-Python RFC 7748 Montgomery ladder
computes the same curve with the same clamping and encoding, so peers on
either path agree on every shared secret byte for byte. The ladder takes
about a millisecond an exchange, once per (client, peer) pair per process.

The ladder is not constant-time. The secrets it protects are per-run mask
seeds under an honest-but-curious server, not long-lived identity keys.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

__all__ = ["kx_agree", "kx_keygen", "public_key"]

_P = 2 ** 255 - 19
_A24 = 121665
_BASE_U = 9


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _x25519(k_bytes: bytes, u_bytes: bytes) -> bytes:
    """RFC 7748 §5 scalar multiplication on curve25519."""
    k = _decode_scalar(k_bytes)
    x1 = int.from_bytes(u_bytes, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


def _have_cryptography() -> bool:
    try:
        import cryptography.hazmat.primitives.asymmetric.x25519  # noqa: F401

        return True
    except ImportError:
        return False


def public_key(sk: bytes, ladder: Optional[bool] = None) -> bytes:
    """The 32-byte public key of the private scalar ``sk``. ``ladder=True``
    forces the pure-Python path, ``False`` the ``cryptography`` one."""
    if ladder is None:
        ladder = not _have_cryptography()
    if not ladder:
        from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

        return X25519PrivateKey.from_private_bytes(bytes(sk)).public_key().public_bytes_raw()
    return _x25519(bytes(sk), _BASE_U.to_bytes(32, "little"))


def kx_keygen(sk: Optional[bytes] = None) -> Tuple[bytes, bytes]:
    """(private scalar bytes, 32-byte public key); the scalar comes from OS
    entropy unless ``sk`` is given (tests only)."""
    sk = os.urandom(32) if sk is None else bytes(sk)
    return sk, public_key(sk)


def kx_agree(sk: bytes, their_pk: bytes, ladder: Optional[bool] = None) -> int:
    """Shared secret → 128-bit PRF seed: the first 16 bytes of the SHA-256
    of the raw exchange, little-endian (the reference's derivation)."""
    if ladder is None:
        ladder = not _have_cryptography()
    if not ladder:
        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PrivateKey,
            X25519PublicKey,
        )

        secret = X25519PrivateKey.from_private_bytes(bytes(sk)).exchange(
            X25519PublicKey.from_public_bytes(bytes(their_pk)))
    else:
        secret = _x25519(bytes(sk), bytes(their_pk))
    return int.from_bytes(hashlib.sha256(secret).digest()[:16], "little")
