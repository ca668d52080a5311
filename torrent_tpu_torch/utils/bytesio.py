"""Byte-level helpers (reference layer L0: _bytes.ts).

The reference implements exact-N socket reads, big-endian integer
read/write for 1-8 byte widths (_bytes.ts:24-56), tracker-safe %-escaping
of binary data (_bytes.ts:58-90), and fixed-size chunking (_bytes.ts:92-99).
Python note: ints are arbitrary precision, so the reference's ``readInt``
32-bit ``<<`` overflow bug (_bytes.ts:29-34, SURVEY §8.4) cannot occur here.
"""

from __future__ import annotations

# Unreserved characters per RFC 3986 — everything else is %-escaped when a
# binary value (info_hash, peer_id) rides in a tracker query string.
_UNRESERVED = frozenset(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_.~"
)

_HEX = "0123456789ABCDEF"


def read_int(data: bytes | memoryview, n: int, offset: int = 0) -> int:
    """Read an ``n``-byte big-endian unsigned integer at ``offset``.

    Unlike the reference (_bytes.ts:24-35) this is exact for all widths up
    to 8 bytes — no 32-bit truncation of uploaded/downloaded/left counters.
    """
    if n < 1 or n > 8:
        raise ValueError(f"read_int width must be 1-8, got {n}")
    chunk = bytes(data[offset : offset + n])
    if len(chunk) != n:
        raise ValueError(f"read_int: need {n} bytes at offset {offset}, have {len(chunk)}")
    return int.from_bytes(chunk, "big")


def write_int(value: int, n: int) -> bytes:
    """Encode ``value`` as ``n`` big-endian bytes (1-8)."""
    if n < 1 or n > 8:
        raise ValueError(f"write_int width must be 1-8, got {n}")
    if value < 0:
        raise ValueError("write_int: negative values not representable")
    return value.to_bytes(n, "big")


def write_int_into(buf: bytearray, value: int, n: int, offset: int) -> None:
    """Write ``value`` as ``n`` big-endian bytes into ``buf`` at ``offset``."""
    buf[offset : offset + n] = value.to_bytes(n, "big")


def encode_binary_data(data: bytes) -> str:
    """%-escape arbitrary binary for a tracker query string.

    Mirrors _bytes.ts:73-90: unreserved ASCII passes through, everything
    else becomes %XX. Stdlib ``urllib.parse.quote`` would also work but its
    ``safe`` handling of ``~`` differs across versions; this is exact.
    """
    out = []
    for b in data:
        if b in _UNRESERVED:
            out.append(chr(b))
        else:
            out.append("%" + _HEX[b >> 4] + _HEX[b & 0xF])
    return "".join(out)


def decode_binary_data(text: str | bytes) -> bytes:
    """Inverse of :func:`encode_binary_data` (_bytes.ts:58-71).

    Operates on raw %-escapes without any charset decoding, so 20-byte
    info hashes survive round-trips that ``urllib.parse.unquote`` (which
    assumes UTF-8) would corrupt.
    """
    if isinstance(text, str):
        raw = text.encode("latin-1")
    else:
        raw = text
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        c = raw[i]
        if c == 0x25:  # '%'
            if i + 3 > n:
                raise ValueError("truncated %-escape")
            try:
                out.append(int(raw[i + 1 : i + 3].decode("ascii"), 16))
            except Exception as e:
                raise ValueError(f"bad %-escape at {i}") from e
            i += 3
        elif c == 0x2B:  # '+' means space in query strings
            out.append(0x20)
            i += 1
        else:
            out.append(c)
            i += 1
    return bytes(out)


def partition(data: bytes, size: int) -> list[bytes]:
    """Split ``data`` into ``size``-byte chunks (_bytes.ts:92-99).

    Used to slice the metainfo ``pieces`` blob into 20-byte SHA1 digests.
    The final chunk may be short; a short final chunk is the caller's
    problem to validate (metainfo validates total length % 20 == 0).
    """
    if size <= 0:
        raise ValueError("partition size must be positive")
    return [data[i : i + size] for i in range(0, len(data), size)]
