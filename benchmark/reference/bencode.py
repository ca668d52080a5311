"""Plain bencode (BEP 3): canonical encode, strict decode."""

from __future__ import annotations


def bencode(value) -> bytes:
    """Canonical bencode of bytes, str, int, list and dict (keys sorted
    as raw bytes)."""
    out = bytearray()
    _encode(value, out)
    return bytes(out)


def _encode(value, out: bytearray) -> None:
    if isinstance(value, bool):
        raise TypeError("bencode has no bool")
    if isinstance(value, int):
        out += b"i%de" % value
    elif isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        out += b"%d:" % len(raw)
        out += raw
    elif isinstance(value, str):
        _encode(value.encode("utf-8"), out)
    elif isinstance(value, list):
        out += b"l"
        for item in value:
            _encode(item, out)
        out += b"e"
    elif isinstance(value, dict):
        out += b"d"
        keys = {(k.encode("utf-8") if isinstance(k, str) else bytes(k)): v for k, v in value.items()}
        for k in sorted(keys):
            _encode(k, out)
            _encode(keys[k], out)
        out += b"e"
    else:
        raise TypeError(f"cannot bencode {type(value).__name__}")


def bdecode(data: bytes):
    """Decode one whole bencoded value (bytes keys); raises ValueError on
    malformed or trailing input."""
    value, end = _decode(bytes(data), 0)
    if end != len(data):
        raise ValueError("trailing bytes after bencoded value")
    return value


def _decode(buf: bytes, i: int):
    if i >= len(buf):
        raise ValueError("truncated bencode")
    c = buf[i : i + 1]
    if c == b"i":
        end = buf.index(b"e", i)
        return int(buf[i + 1 : end]), end + 1
    if c == b"l":
        i += 1
        out = []
        while buf[i : i + 1] != b"e":
            item, i = _decode(buf, i)
            out.append(item)
        return out, i + 1
    if c == b"d":
        i += 1
        out = {}
        while buf[i : i + 1] != b"e":
            key, i = _decode(buf, i)
            out[key], i = _decode(buf, i)
        return out, i + 1
    if c.isdigit():
        colon = buf.index(b":", i)
        n = int(buf[i:colon])
        start = colon + 1
        if start + n > len(buf):
            raise ValueError("truncated bencode string")
        return buf[start : start + n], start + n
    raise ValueError(f"bad bencode byte {c!r} at {i}")
