"""Bencode codec (reference layer L1: bencode.ts, 202 LoC).

Design differences from the reference, deliberate (SURVEY §8.10-11, §8.16):

- **Bytes keys everywhere.** Decoded dicts are keyed by ``bytes``, which is
  what the wire actually carries. This removes the reference's whole
  ``bdecodeBytestringMap`` special case (bencode.ts:168-202) for scrape
  responses keyed by raw 20-byte info hashes — binary keys just work.
- **Canonical sorted-key encode by default** as BEP 3 requires; the
  reference emits insertion order (bencode.ts:56-64) and only round-trips
  correctly because its decoder preserves order. ``sort_keys=False`` gives
  the compat behavior for re-hashing foreign dicts verbatim (Python dicts
  preserve insertion order, so decode→encode is byte-exact either way for
  well-formed canonical input).
- **Real byte buffers**: the encoder writes into one ``bytearray`` instead
  of the reference's push-spread ``number[]`` with 10k chunking
  (bencode.ts:35-42).
- **Strict bounds checks**: truncated ints/strings raise ``BencodeError``
  instead of scanning past the buffer (bencode.ts:77-106).
"""

from __future__ import annotations

from typing import Union

Bencodeable = Union[bytes, bytearray, memoryview, str, int, list, dict]


class BencodeError(ValueError):
    """Malformed bencode input or unencodable value."""


# ---------------------------------------------------------------- encode


def bencode(value: Bencodeable, sort_keys: bool = True) -> bytes:
    """Encode a value to canonical bencode bytes.

    ``str`` is encoded as UTF-8; dict keys may be ``bytes`` or ``str`` and
    are sorted as raw bytes when ``sort_keys`` (BEP 3 canonical form).
    Booleans are rejected (ambiguous — the wire has no bool type).
    """
    out = bytearray()
    _encode_into(value, out, sort_keys)
    return bytes(out)


def _encode_into(value: Bencodeable, out: bytearray, sort_keys: bool) -> None:
    if isinstance(value, bool):
        raise BencodeError("cannot bencode bool")
    if isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        out += str(len(raw)).encode("ascii")
        out += b":"
        out += raw
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out += str(len(raw)).encode("ascii")
        out += b":"
        out += raw
    elif isinstance(value, int):
        out += b"i"
        out += str(value).encode("ascii")
        out += b"e"
    elif isinstance(value, (list, tuple)):
        out += b"l"
        for item in value:
            _encode_into(item, out, sort_keys)
        out += b"e"
    elif isinstance(value, dict):
        out += b"d"
        items = []
        for k, v in value.items():
            if isinstance(k, str):
                kb = k.encode("utf-8")
            elif isinstance(k, (bytes, bytearray, memoryview)):
                kb = bytes(k)
            else:
                raise BencodeError(f"dict key must be bytes/str, got {type(k).__name__}")
            items.append((kb, v))
        if sort_keys:
            items.sort(key=lambda kv: kv[0])
        for kb, v in items:
            _encode_into(kb, out, sort_keys)
            _encode_into(v, out, sort_keys)
        out += b"e"
    else:
        raise BencodeError(f"cannot bencode {type(value).__name__}")


# ---------------------------------------------------------------- decode


def bdecode(data: bytes | bytearray | memoryview, strict: bool = True):
    """Decode bencode bytes into bytes/int/list/dict-with-bytes-keys.

    With ``strict`` (default), trailing bytes after the top-level value are
    an error — the reference silently ignores them.
    """
    buf = bytes(data)
    value, end = _decode_at(buf, 0)
    if strict and end != len(buf):
        raise BencodeError(f"trailing data after bencode value at {end}")
    return value


def bdecode_prefix(data: bytes | bytearray | memoryview):
    """Decode one value from the head of ``data``; return ``(value, end)``.

    ``end`` is the number of bytes consumed. Needed by BEP 9 ut_metadata
    framing, where a bencoded dict is immediately followed by raw piece
    bytes that are not part of the dict.
    """
    buf = bytes(data)
    return _decode_at(buf, 0)


def bdecode_with_info_span(data: bytes | bytearray | memoryview):
    """Decode a top-level dict, also returning the byte span of ``info``.

    Returns ``(value, (start, end) | None)``. The span covers the raw
    bencoded ``info`` dict value, so ``sha1(data[start:end])`` is the
    BEP 3 infohash computed over the *original* bytes — immune to
    key-order or formatting quirks that re-encoding (the reference's
    approach, metainfo.ts:141-143) would have to reproduce exactly.
    """
    buf = bytes(data)
    if not buf or buf[0:1] != b"d":
        raise BencodeError("top-level value is not a dict")
    i = 1
    result: dict = {}
    info_span: tuple[int, int] | None = None
    while True:
        if i >= len(buf):
            raise BencodeError("unterminated dict")
        if buf[i] == 0x65:  # 'e'
            i += 1
            break
        key, i = _decode_at(buf, i)
        if not isinstance(key, bytes):
            raise BencodeError("dict key is not a bytestring")
        start = i
        val, i = _decode_at(buf, i)
        if key == b"info":
            info_span = (start, i)
        result[key] = val
    if len(buf) != i:
        raise BencodeError(f"trailing data after bencode value at {i}")
    return result, info_span


def _decode_at(buf: bytes, i: int):
    if i >= len(buf):
        raise BencodeError(f"unexpected end of input at {i}")
    c = buf[i]
    if c == 0x69:  # 'i'
        end = buf.find(b"e", i + 1)
        if end < 0:
            raise BencodeError("unterminated integer")
        body = buf[i + 1 : end]
        _check_int_body(body)
        return int(body), end + 1
    if 0x30 <= c <= 0x39:  # digit: bytestring
        colon = buf.find(b":", i)
        if colon < 0:
            raise BencodeError("unterminated string length")
        lenbody = buf[i:colon]
        if not lenbody.isdigit():
            raise BencodeError(f"bad string length {lenbody!r}")
        if len(lenbody) > 1 and lenbody[0] == 0x30:
            raise BencodeError("string length has leading zero")
        n = int(lenbody)
        start = colon + 1
        if start + n > len(buf):
            raise BencodeError("truncated string")
        return buf[start : start + n], start + n
    if c == 0x6C:  # 'l'
        i += 1
        items = []
        while True:
            if i >= len(buf):
                raise BencodeError("unterminated list")
            if buf[i] == 0x65:
                return items, i + 1
            item, i = _decode_at(buf, i)
            items.append(item)
    if c == 0x64:  # 'd'
        i += 1
        d: dict = {}
        while True:
            if i >= len(buf):
                raise BencodeError("unterminated dict")
            if buf[i] == 0x65:
                return d, i + 1
            key, i = _decode_at(buf, i)
            if not isinstance(key, bytes):
                raise BencodeError("dict key is not a bytestring")
            val, i = _decode_at(buf, i)
            d[key] = val
    raise BencodeError(f"unexpected byte {c:#x} at {i}")


def _check_int_body(body: bytes) -> None:
    if not body:
        raise BencodeError("empty integer")
    digits = body[1:] if body[0:1] == b"-" else body
    if not digits.isdigit():
        raise BencodeError(f"bad integer {body!r}")
    if len(digits) > 1 and digits[0] == 0x30:
        raise BencodeError(f"integer has leading zero: {body!r}")
    if body == b"-0":
        raise BencodeError("negative zero")
