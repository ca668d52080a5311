"""Message Stream Encryption (MSE / "protocol encryption", PE).

The obfuscated peer handshake spoken by mainline, µTorrent, and
libtorrent swarms: a 768-bit Diffie-Hellman exchange derives RC4 keys
that encrypt the BitTorrent handshake (and optionally the whole
connection), so the stream never shows the plaintext protocol header.
The reference speaks only the plaintext handshake
(protocol.ts:25-34); real swarms widely require PE, so
this is a beyond-parity subsystem. Spec: the Azureus/Vuze
"Message_Stream_Encryption" wiki page (there is no BEP for it).

Design notes (this framework, not a translation of any client):

- RC4 rides the native C engine (native/io_engine.cpp tt_rc4_*) when the
  toolchain is available — RC4 is strictly sequential, one state update
  per keystream byte, so it can never ride the GPU hash plane; a C loop
  keeps encrypted connections off the session's critical path. A pure-
  Python fallback keeps the feature available without a compiler.
- The handshake works over ANY (reader, writer) pair that implements
  ``readexactly`` / ``write`` / ``drain`` — TCP StreamReader/Writer and
  the uTP transport (net/utp.py) both qualify, so encrypted-over-uTP
  comes for free.
- The responder resolves the torrent from HASH('req2', skey) across all
  registered torrents (v1 infohashes and truncated v2 hashes alike), the
  same routing point the plaintext accept path uses (session/client.py).

Wire flow (A = initiator, B = responder; '|' is concatenation):

  A→B  Ya | PadA                                   (96 + 0..512 bytes)
  B→A  Yb | PadB                                   (96 + 0..512 bytes)
  A→B  HASH('req1'|S) | HASH('req2'|SKEY) xor HASH('req3'|S)
       | E_a(VC | crypto_provide | len(PadC) | PadC | len(IA)) | E_a(IA)
  B→A  E_b(VC | crypto_select | len(PadD) | PadD)

S = DH secret (96 bytes), SKEY = infohash, VC = 8 zero bytes,
E_a/E_b = RC4('keyA'/'keyB' | S | SKEY) with the first 1024 keystream
bytes discarded. B syncs on HASH('req1'|S); A syncs on E_b(VC).
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterable

__all__ = [
    "MseError",
    "RC4",
    "CRYPTO_PLAIN",
    "CRYPTO_RC4",
    "WrappedReader",
    "WrappedWriter",
    "initiate",
    "respond",
]

# 768-bit prime from the MSE spec (same P as the BitTorrent DH group);
# generator 2. Keys of 160 random bits are within the spec's 128..180
# recommendation.
DH_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC"
    "74020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F"
    "14374FE1356D6D51C245E485B576625E7EC6F44C42E9A63A362100000000000"
    "90563",
    16,
)
DH_G = 2
_KEY_BYTES = 96

VC = b"\x00" * 8
CRYPTO_PLAIN = 0x01
CRYPTO_RC4 = 0x02

# sync-scan bounds from the spec: pad fields are 0..512 random bytes
_MAX_PAD = 512


class MseError(Exception):
    """Handshake failed: not MSE, bad VC/hash sync, or no method agreed."""


# ------------------------------------------------------------------- RC4


def _native_lib():
    try:
        from torrent_tpu_torch.native.build import load

        return load()
    except Exception:
        return None


_LIB = None
_LIB_TRIED = False


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _native_lib()
        _LIB_TRIED = True
    return _LIB


class RC4:
    """RC4 keystream xor, native (C) when available, pure Python otherwise.

    ``crypt`` is its own inverse — the same object must only ever be used
    in one direction (one per side per connection, as the spec keys them).
    """

    def __init__(self, key: bytes):
        if not key:
            raise ValueError("RC4 key must be non-empty")
        lib = _lib()
        if lib is not None:
            import ctypes

            self._state = ctypes.create_string_buffer(258)
            lib.tt_rc4_init(self._state, key, len(key))
            self._lib = lib
        else:
            self._lib = None
            s = list(range(256))
            j = 0
            for i in range(256):
                j = (j + s[i] + key[i % len(key)]) & 0xFF
                s[i], s[j] = s[j], s[i]
            self._s = s
            self._i = 0
            self._j = 0

    def crypt(self, data: bytes | bytearray) -> bytes:
        if self._lib is not None:
            import ctypes

            # copy of bytes already received: allocation is len(data),
            # bounded by the buffer the transport handed us
            buf = bytearray(data)  # sanitized-by: bounded-copy
            if buf:
                arr = (ctypes.c_ubyte * len(buf)).from_buffer(buf)
                self._lib.tt_rc4_crypt(self._state, arr, len(buf))
            return bytes(buf)
        s, i, j = self._s, self._i, self._j
        out = bytearray(len(data))
        for k, c in enumerate(data):
            i = (i + 1) & 0xFF
            j = (j + s[i]) & 0xFF
            s[i], s[j] = s[j], s[i]
            out[k] = c ^ s[(s[i] + s[j]) & 0xFF]
        self._i, self._j = i, j
        return bytes(out)

    def discard(self, n: int) -> None:
        self.crypt(b"\x00" * n)


# --------------------------------------------------------------- helpers


def _sha1(*parts: bytes) -> bytes:
    return hashlib.sha1(b"".join(parts)).digest()


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _keypair() -> tuple[int, bytes]:
    x = int.from_bytes(os.urandom(20), "big")
    return x, pow(DH_G, x, DH_P).to_bytes(_KEY_BYTES, "big")


def _shared(pub: bytes, priv: int) -> bytes:
    y = int.from_bytes(pub, "big")
    if not 1 < y < DH_P - 1:
        raise MseError("degenerate DH public key")
    return pow(y, priv, DH_P).to_bytes(_KEY_BYTES, "big")


def _pad() -> bytes:
    return os.urandom(int.from_bytes(os.urandom(2), "big") % (_MAX_PAD + 1))


def _streams(s: bytes, skey: bytes) -> tuple[RC4, RC4]:
    """(keyA stream, keyB stream), both with the 1024-byte spec discard."""
    a = RC4(_sha1(b"keyA", s, skey))
    b = RC4(_sha1(b"keyB", s, skey))
    a.discard(1024)
    b.discard(1024)
    return a, b


# ------------------------------------------------------- stream wrappers


class WrappedReader:
    """Decrypting (or prefix-replaying) view over a stream reader.

    ``prefix`` is plaintext already produced by the handshake (IA /
    leftover bytes, decrypted); ``rc4`` decrypts everything after it.
    ``rc4=None`` makes this a pure pushback reader for the plaintext-
    selected and handshake-detection paths.
    """

    def __init__(self, reader, rc4: RC4 | None = None, prefix: bytes = b""):
        self._r = reader
        self._rc4 = rc4
        self._prefix = bytearray(prefix)

    async def readexactly(self, n: int) -> bytes:
        take = bytes(self._prefix[:n])
        del self._prefix[: len(take)]
        if len(take) == n:
            return take
        rest = await self._r.readexactly(n - len(take))
        if self._rc4 is not None:
            rest = self._rc4.crypt(rest)
        return take + rest

    async def read(self, n: int = -1) -> bytes:
        if self._prefix:
            if n >= 0:
                take = bytes(self._prefix[:n])
                del self._prefix[: len(take)]
                return take
            take = bytes(self._prefix)
            self._prefix.clear()
            # read(-1) means read-to-EOF: the prefix alone would silently
            # truncate the stream
            rest = await self._r.read(-1)
            if self._rc4 is not None and rest:
                rest = self._rc4.crypt(rest)
            return take + rest
        data = await self._r.read(n)
        if self._rc4 is not None and data:
            data = self._rc4.crypt(data)
        return data

    def __getattr__(self, name):
        return getattr(self._r, name)


class WrappedWriter:
    """Encrypting view over a stream writer (RC4-selected connections)."""

    def __init__(self, writer, rc4: RC4):
        self._w = writer
        self._rc4 = rc4

    def write(self, data: bytes) -> None:
        self._w.write(self._rc4.crypt(data))

    def __getattr__(self, name):
        # drain/close/get_extra_info/wait_closed/is_closing pass through
        return getattr(self._w, name)


# ------------------------------------------------------------- initiator


async def initiate(
    reader,
    writer,
    skey: bytes,
    *,
    allow_plaintext: bool = True,
    allow_rc4: bool = True,
):
    """Run the A side over freshly connected streams.

    Returns ``(reader, writer, selected)`` where selected is CRYPTO_RC4
    or CRYPTO_PLAIN and the streams transparently carry the chosen
    encryption. Raises MseError (or OSError/IncompleteReadError from the
    transport) on failure — the caller owns closing the socket.
    """
    if not (allow_plaintext or allow_rc4):
        raise MseError("no crypto method enabled")
    priv, pub = _keypair()
    writer.write(pub + _pad())
    await writer.drain()

    s = _shared(await reader.readexactly(_KEY_BYTES), priv)
    enc, dec = _streams(s, skey)

    provide = (CRYPTO_PLAIN if allow_plaintext else 0) | (
        CRYPTO_RC4 if allow_rc4 else 0
    )
    msg = (
        _sha1(b"req1", s)
        + _xor(_sha1(b"req2", skey), _sha1(b"req3", s))
        + enc.crypt(
            VC
            + provide.to_bytes(4, "big")
            + (0).to_bytes(2, "big")  # len(PadC)
            + (0).to_bytes(2, "big")  # len(IA): handshake sent after select
        )
    )
    writer.write(msg)
    await writer.drain()

    # B replies Yb | PadB (plain) then E_b(VC | ...). The encrypted VC is
    # the first 8 post-discard keystream bytes (VC is zeros), a fixed
    # pattern we can scan for past the unknown-length pad. Scanning in
    # chunks (not byte-per-await) keeps the handshake to a few event-loop
    # round-trips; over-read bytes become the post-handshake prefix.
    sync = dec.crypt(VC)
    buf = bytearray(await reader.readexactly(len(sync)))
    while True:
        idx = bytes(buf).find(sync)
        if idx >= 0:
            del buf[: idx + len(sync)]
            break
        if len(buf) > _MAX_PAD + len(sync):
            raise MseError("encrypted VC not found")
        chunk = await reader.read(256)
        if not chunk:
            raise MseError("connection closed during VC sync")
        buf += chunk

    async def take(n: int) -> bytes:
        while len(buf) < n:
            buf.extend(await reader.readexactly(n - len(buf)))
        out = bytes(buf[:n])
        del buf[:n]
        return out

    select = int.from_bytes(dec.crypt(await take(4)), "big")
    pad_d = int.from_bytes(dec.crypt(await take(2)), "big")
    if pad_d > _MAX_PAD:
        raise MseError("oversized PadD")
    if pad_d:
        dec.crypt(await take(pad_d))

    leftover = bytes(buf)
    if select == CRYPTO_RC4 and allow_rc4:
        return (
            WrappedReader(reader, dec, prefix=dec.crypt(leftover)),
            WrappedWriter(writer, enc),
            select,
        )
    if select == CRYPTO_PLAIN and allow_plaintext:
        if leftover:
            return WrappedReader(reader, None, prefix=leftover), writer, select
        return reader, writer, select
    raise MseError(f"peer selected unsupported method {select:#x}")


# ------------------------------------------------------------- responder


async def respond(
    reader,
    writer,
    first_bytes: bytes,
    skeys: Iterable[bytes],
    *,
    allow_plaintext: bool = True,
    allow_rc4: bool = True,
):
    """Run the B side after inbound auto-detection.

    ``first_bytes`` are the bytes already consumed while deciding the
    stream is not a plaintext BT handshake. ``skeys`` are the candidate
    torrent identities (v1 infohashes / truncated v2 hashes). Returns
    ``(reader, writer, skey, selected)``; the BT handshake then proceeds
    over the returned streams.
    """
    buf = bytearray(first_bytes)
    while len(buf) < _KEY_BYTES:
        buf += await reader.readexactly(_KEY_BYTES - len(buf))
    priv, pub = _keypair()
    s = _shared(bytes(buf[:_KEY_BYTES]), priv)
    del buf[:_KEY_BYTES]
    writer.write(pub + _pad())
    await writer.drain()

    # sync on HASH('req1'|S) past PadA — chunked reads, not byte-per-await
    req1 = _sha1(b"req1", s)
    while True:
        idx = bytes(buf).find(req1)
        if idx >= 0:
            del buf[: idx + len(req1)]
            break
        if len(buf) > _MAX_PAD + len(req1):
            raise MseError("req1 sync not found")
        chunk = await reader.read(256)
        if not chunk:
            raise MseError("connection closed during req1 sync")
        buf += chunk

    async def take(n: int) -> bytes:
        while len(buf) < n:
            buf.extend(await reader.readexactly(n - len(buf)))
        out = bytes(buf[:n])
        del buf[:n]
        return out

    req2 = _xor(await take(20), _sha1(b"req3", s))
    skey = next((k for k in skeys if _sha1(b"req2", k) == req2), None)
    if skey is None:
        raise MseError("unknown stream key (no matching torrent)")

    dec, enc = _streams(s, skey)  # A encrypts with keyA; we decrypt with it
    if dec.crypt(await take(8)) != VC:
        raise MseError("bad VC")
    provide = int.from_bytes(dec.crypt(await take(4)), "big")
    pad_c = int.from_bytes(dec.crypt(await take(2)), "big")
    if pad_c > _MAX_PAD:
        raise MseError("oversized PadC")
    if pad_c:
        dec.crypt(await take(pad_c))
    ia_len = int.from_bytes(dec.crypt(await take(2)), "big")
    ia = dec.crypt(await take(ia_len)) if ia_len else b""

    if provide & CRYPTO_RC4 and allow_rc4:
        select = CRYPTO_RC4
    elif provide & CRYPTO_PLAIN and allow_plaintext:
        select = CRYPTO_PLAIN
    else:
        raise MseError(f"no common crypto method (peer provides {provide:#x})")

    writer.write(enc.crypt(VC + select.to_bytes(4, "big") + (0).to_bytes(2, "big")))
    await writer.drain()

    # anything still buffered arrived after the handshake proper: it is
    # the start of the peer's post-select stream
    leftover = bytes(buf)
    if select == CRYPTO_RC4:
        return (
            WrappedReader(reader, dec, prefix=ia + dec.crypt(leftover)),
            WrappedWriter(writer, enc),
            skey,
            select,
        )
    return WrappedReader(reader, None, prefix=ia + leftover), writer, skey, select
