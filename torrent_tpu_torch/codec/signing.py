"""BEP 35 torrent signing over the raw info-dict span.

Structure follows BEP 35: a root-level ``signatures`` dict keyed by the
signer's identity string; each entry holds an optional ``certificate``,
an optional extension-``info`` dict, and the ``signature``. The signed
message is the EXACT wire bytes of the ``info`` value (the infohash
preimage, taken from the original buffer the way the raw-span infohash
is — never a re-encode) concatenated with the bencoded extension-info
dict when one is present, per the BEP.

The supported scheme is Ed25519 — the keys BEP 46 mutable torrents and
BEP 44 DHT items already use — with the signer's 32-byte public key
carried in ``certificate``. BEP 35 leaves certificate contents to the
recognized scheme; x509/RSA chains are REFUSED (``verify_torrent``
returns False), never mis-verified.

Because ``signatures`` lives at the root, signing leaves the infohash
untouched: a signed and an unsigned copy are the same swarm. The
reference has no counterpart (rclarey/torrent implements no BEP 35).
"""

from __future__ import annotations

from torrent_tpu_torch.codec.bencode import (
    BencodeError,
    _decode_at,
    bdecode_with_info_span,
    bencode,
)
from torrent_tpu_torch.utils import ed25519

ED25519_PUB_LEN = 32
SIG_LEN = 64


def _enc_str(b: bytes) -> bytes:
    return str(len(b)).encode("ascii") + b":" + b


def _dict_entry_spans(buf: bytes, i: int) -> dict[bytes, tuple[int, int]]:
    """``key -> (value_start, value_end)`` for the bencoded dict whose
    ``d`` sits at ``buf[i]``. Wire-byte spans, no value decoding beyond
    what skipping requires; raises BencodeError on malformation."""
    if i >= len(buf) or buf[i] != 0x64:  # 'd'
        raise BencodeError("not a dict")
    i += 1
    out: dict[bytes, tuple[int, int]] = {}
    while True:
        if i >= len(buf):
            raise BencodeError("unterminated dict")
        if buf[i] == 0x65:  # 'e'
            return out
        key, i = _decode_at(buf, i)
        if not isinstance(key, bytes):
            raise BencodeError("dict key is not a bytestring")
        start = i
        _, i = _decode_at(buf, i)
        out[key] = (start, i)


def _top_value_span(buf: bytes, key: bytes) -> tuple[int, int] | None:
    try:
        return _dict_entry_spans(buf, 0).get(key)
    except BencodeError:
        return None


def sign_torrent(
    data: bytes,
    seed: bytes,
    signer: str,
    info_ext: dict | None = None,
) -> bytes:
    """Return new .torrent bytes with a ``signatures[signer]`` entry.

    ``seed`` is the 32-byte Ed25519 seed (same format the BEP 46 tools
    use); ``info_ext`` optionally carries BEP 35 extension fields, which
    are covered by the signature. Re-signing with the same identity
    replaces that identity's entry; other signers' entries survive
    BYTE-FOR-BYTE (their signatures cover their own wire ext bytes).

    The output is assembled by splicing: the ``info`` value and foreign
    signature entries are copied verbatim from the input buffer — never
    re-encoded — so a non-canonical wild torrent keeps its infohash and
    its existing signatures; only the top-level frame and our own entry
    are freshly (canonically) encoded.
    """
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    decoded, span = bdecode_with_info_span(data)
    if span is None:
        raise ValueError("not a .torrent: no info dict")
    raw_info = data[span[0] : span[1]]
    msg = raw_info

    entry: dict = {b"certificate": ed25519.publickey(seed)}
    if info_ext:
        # our entry is emitted via the same canonical encoder, so these
        # exact bytes appear on the wire — signed == emitted
        entry[b"info"] = info_ext
        msg += bencode(info_ext)
    entry[b"signature"] = ed25519.sign(seed, msg)

    # existing signers' entries: raw wire spans, preserved verbatim
    raw_entries: dict[bytes, bytes] = {}
    sig_span = _top_value_span(data, b"signatures")
    if sig_span is not None:
        try:
            for k, (s, e) in _dict_entry_spans(data, sig_span[0]).items():
                raw_entries[k] = data[s:e]
        except BencodeError:
            raw_entries = {}  # malformed signatures value: start fresh
    raw_entries[signer.encode("utf-8")] = bencode(entry)
    sig_wire = (
        b"d"
        + b"".join(_enc_str(k) + raw_entries[k] for k in sorted(raw_entries))
        + b"e"
    )

    out = bytearray(b"d")
    for k in sorted(set(decoded) | {b"signatures"}):
        out += _enc_str(k)
        if k == b"info":
            out += raw_info
        elif k == b"signatures":
            out += sig_wire
        else:
            out += bencode(decoded[k])
    out += b"e"
    return bytes(out)


def list_signers(data: bytes) -> list[str]:
    """Identity strings with a structurally-plausible signature entry."""
    try:
        decoded, _ = bdecode_with_info_span(data)
    except BencodeError:
        return []
    sigs = decoded.get(b"signatures")
    if not isinstance(sigs, dict):
        return []
    out = []
    for name, entry in sigs.items():
        if isinstance(entry, dict) and isinstance(entry.get(b"signature"), bytes):
            try:
                out.append(name.decode("utf-8"))
            except UnicodeDecodeError:
                continue
    return out


def ensure_signed(data: bytes, signer: str, pub: bytes) -> None:
    """THE gate: raise ValueError unless ``signer``'s signature verifies
    under the 32-byte trusted key. Every require-signed surface (library
    ``add_torrent_bytes``, CLI download/update, feed auto-add) funnels
    through here so the check — and its failure message — cannot drift.

    ``pub`` is mandatory and validated: a missing/short key must never
    silently degrade the gate to trusting the attacker-supplied embedded
    certificate."""
    if not isinstance(pub, bytes) or len(pub) != ED25519_PUB_LEN:
        raise ValueError("trusted key must be 32 bytes (Ed25519 public key)")
    if not verify_torrent(data, signer, pub):
        raise ValueError(
            f"no valid BEP 35 signature by {signer!r} under the trusted key"
        )


def has_embedded_certificate(data: bytes, signer: str) -> bool:
    """True when ``signer``'s entry carries a ``certificate`` field.

    The CLI uses this to distinguish "unverifiable without a trusted key
    (BEP 35 allows out-of-band keys)" from "the embedded key does not
    verify" — one classification, shared by every command."""
    try:
        decoded, _ = bdecode_with_info_span(data)
    except BencodeError:
        return False
    sigs = decoded.get(b"signatures")
    if not isinstance(sigs, dict):
        return False
    entry = sigs.get(signer.encode("utf-8"))
    return isinstance(entry, dict) and b"certificate" in entry


def verify_torrent(data: bytes, signer: str, pub: bytes | None = None) -> bool:
    """True iff ``signer``'s signature verifies over this torrent.

    ``pub`` is the trusted 32-byte public key. When given, an embedded
    certificate must MATCH it (an attacker replacing cert+signature
    together must not pass); when omitted, the embedded certificate is
    used — caller trusts whoever it names, which is only meaningful if
    the torrent arrived over a trusted channel. Anything structurally
    non-Ed25519 (x509 chains, wrong lengths) fails closed.
    """
    try:
        decoded, span = bdecode_with_info_span(data)
    except BencodeError:
        return False
    if span is None:
        return False
    sigs = decoded.get(b"signatures")
    if not isinstance(sigs, dict):
        return False
    entry = sigs.get(signer.encode("utf-8"))
    if not isinstance(entry, dict):
        return False
    sig = entry.get(b"signature")
    if not isinstance(sig, bytes) or len(sig) != SIG_LEN:
        return False
    cert = entry.get(b"certificate")
    if cert is not None and (
        not isinstance(cert, bytes) or len(cert) != ED25519_PUB_LEN
    ):
        return False  # not a raw Ed25519 key: refuse, don't guess
    if pub is not None:
        if len(pub) != ED25519_PUB_LEN:
            return False
        if cert is not None and cert != pub:
            return False
        key = pub
    else:
        if cert is None:
            return False
        key = cert
    msg = data[span[0] : span[1]]
    if entry.get(b"info") is not None:
        if not isinstance(entry[b"info"], dict):
            return False
        # spec-faithful: the signature covers the entry's ext dict WIRE
        # bytes — a foreign signer's non-canonical encoding must verify
        # as written, not as our encoder would have written it
        try:
            sig_span = _top_value_span(data, b"signatures")
            assert sig_span is not None
            entry_span = _dict_entry_spans(data, sig_span[0])[
                signer.encode("utf-8")
            ]
            ext_span = _dict_entry_spans(data, entry_span[0])[b"info"]
        except (BencodeError, KeyError, AssertionError):
            return False
        msg += data[ext_span[0] : ext_span[1]]
    return ed25519.verify(key, msg, sig)
