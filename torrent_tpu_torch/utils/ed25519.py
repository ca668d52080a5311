"""Pure-Python Ed25519 (RFC 8032) for BEP 44 mutable DHT items.

No crypto libraries ship in this image (no nacl/cryptography), and DHT
item signing is a low-rate control-plane operation (one signature per
put, one verify per stored item) — a big-int implementation at ~5 ms per
operation is plenty. Data-plane crypto stays in the native engine
(native/io_engine.cpp RC4) or the GPU hash planes.

Two signing entry points:

- ``sign(seed, msg)`` — the normal RFC 8032 path (32-byte seed).
- ``sign_expanded(expanded, msg)`` — takes the 64-byte libsodium-style
  expanded secret (clamped scalar || nonce prefix). BEP 44's published
  test vectors distribute keys in this form, so supporting it keeps the
  vectors directly checkable.
"""

from __future__ import annotations

import hashlib

__all__ = ["publickey", "publickey_expanded", "sign", "sign_expanded", "verify"]

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = -121665 * pow(121666, _P - 2, _P) % _P

_BY = 4 * pow(5, _P - 2, _P) % _P
_BX = None  # recovered below


def _sha512(m: bytes) -> bytes:
    return hashlib.sha512(m).digest()


def _inv(x: int) -> int:
    return pow(x, _P - 2, _P)


def _recover_x(y: int, sign: int) -> int | None:
    x2 = (y * y - 1) * _inv(_D * y * y + 1) % _P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P != 0:
        x = x * pow(2, (_P - 1) // 4, _P) % _P
    if (x * x - x2) % _P != 0:
        return None
    if x & 1 != sign:
        x = _P - x
    return x


_BX = _recover_x(_BY, 0)
_B = (_BX, _BY, 1, _BX * _BY % _P)  # extended homogeneous (X, Y, Z, T)
_IDENT = (0, 1, 1, 0)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    dd = 2 * z1 * z2 % _P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _mul(s: int, p):
    q = _IDENT
    while s > 0:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _equal(p, q) -> bool:
    # cross-multiply to compare projective points
    return (
        (p[0] * q[2] - q[0] * p[2]) % _P == 0
        and (p[1] * q[2] - q[1] * p[2]) % _P == 0
    )


def _compress(p) -> bytes:
    zinv = _inv(p[2])
    x = p[0] * zinv % _P
    y = p[1] * zinv % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(data: bytes):
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= _P:
        return None
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % _P)


def _clamp(a: bytes) -> int:
    s = int.from_bytes(a, "little")
    s &= (1 << 254) - 8
    s |= 1 << 254
    return s


def publickey(seed: bytes) -> bytes:
    """32-byte public key from a 32-byte seed."""
    h = _sha512(seed)
    return _compress(_mul(_clamp(h[:32]), _B))


def publickey_expanded(expanded: bytes) -> bytes:
    return _compress(_mul(_clamp(expanded[:32]), _B))


def _sign_parts(a: int, prefix: bytes, pub: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(_sha512(prefix + msg), "little") % _L
    rb = _compress(_mul(r, _B))
    k = int.from_bytes(_sha512(rb + pub + msg), "little") % _L
    s = (r + k * a) % _L
    return rb + s.to_bytes(32, "little")


def sign(seed: bytes, msg: bytes) -> bytes:
    """64-byte signature from a 32-byte seed (RFC 8032 Ed25519)."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    h = _sha512(seed)
    a = _clamp(h[:32])
    return _sign_parts(a, h[32:], _compress(_mul(a, _B)), msg)


def sign_expanded(expanded: bytes, msg: bytes) -> bytes:
    """64-byte signature from a 64-byte expanded secret (scalar||prefix)."""
    if len(expanded) != 64:
        raise ValueError("expanded secret must be 64 bytes")
    a = _clamp(expanded[:32])
    return _sign_parts(a, expanded[32:], _compress(_mul(a, _B)), msg)


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """True iff ``sig`` is a valid signature of ``msg`` under ``pub``."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    a = _decompress(pub)
    r = _decompress(sig[:32])
    if a is None or r is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= _L:
        return False
    k = int.from_bytes(_sha512(sig[:32] + pub + msg), "little") % _L
    return _equal(_mul(s, _B), _add(r, _mul(k, a)))
