"""Magnet URI parsing (BEP 9 §magnet — a reference roadmap item).

The reference lists "Magnet Links" unchecked (README.md:39); this module
plus ``net/extension.py`` (BEP 10 extension protocol + ut_metadata) and
``session/metadata.py`` (the metadata fetch) complete it: a client can join
a swarm from ``magnet:?xt=urn:btih:...`` alone and learn the info dict
from its peers.

Supported fields: ``xt`` (btih, 40-hex or 32-base32), ``dn`` display
name, ``tr`` tracker URLs (repeatable), ``x.pe`` direct peer addresses
(repeatable, BEP 9 extension used by several clients for trackerless
bootstrap).
"""

from __future__ import annotations

import base64
import binascii
from dataclasses import dataclass, field
from urllib.parse import parse_qs, quote, urlparse


class MagnetError(ValueError):
    pass


# BEP 53 cap: magnet URIs are untrusted; a so= range may not select more
# files than any real torrent plausibly has (prevents range bombs)
MAX_SELECT_ONLY = 100_000


@dataclass(frozen=True)
class Magnet:
    # v1 (btih, 20 bytes) and/or v2 (btmh sha2-256 multihash, 32 bytes)
    # exact topics; hybrid magnets carry both, pure-v2 only the latter
    info_hash: bytes | None = None
    display_name: str | None = None
    trackers: tuple[str, ...] = ()
    peer_addrs: tuple[tuple[str, int], ...] = field(default_factory=tuple)
    info_hash_v2: bytes | None = None
    # BEP 53 "select only": file indices to download (None = everything)
    select_only: tuple[int, ...] | None = None
    # BEP 9 §"magnet URI format" / BEP 19: ws= webseed URLs
    web_seeds: tuple[str, ...] = ()
    # BEP 46 mutable pointer: xs=urn:btpk:<ed25519 pubkey hex> (+ s=<salt
    # hex>) — the infohash is resolved through a BEP 44 mutable item
    mutable_key: bytes | None = None
    mutable_salt: bytes = b""

    @property
    def wire_hash(self) -> bytes:
        """The 20-byte infohash used on the wire (registry key, handshake,
        tracker/DHT announces): btih as-is, or the TRUNCATED sha-256 for
        a pure-v2 (btmh-only) magnet per BEP 52."""
        if self.info_hash is not None:
            return self.info_hash
        if self.info_hash_v2 is None:
            raise MagnetError(
                "mutable (btpk) magnet has no wire hash until resolved via BEP 44"
            )
        return self.info_hash_v2[:20]

    def to_uri(self) -> str:
        topics = []
        if self.info_hash is not None:
            topics.append(f"xt=urn:btih:{self.info_hash.hex()}")
        if self.info_hash_v2 is not None:
            topics.append(f"xt=urn:btmh:1220{self.info_hash_v2.hex()}")
        if self.mutable_key is not None:
            topics.append(f"xs=urn:btpk:{self.mutable_key.hex()}")
            if self.mutable_salt:
                topics.append(f"s={self.mutable_salt.hex()}")
        if not topics:
            raise MagnetError("magnet needs at least one exact topic")
        parts = ["magnet:?" + topics[0]] + topics[1:]
        if self.display_name:
            parts.append(f"dn={quote(self.display_name)}")
        for tr in self.trackers:
            parts.append(f"tr={quote(tr, safe='')}")
        for host, port in self.peer_addrs:
            h = f"[{host}]" if ":" in host else host  # IPv6 re-bracketing
            parts.append(f"x.pe={h}:{port}")
        for ws in self.web_seeds:
            parts.append(f"ws={quote(ws, safe='')}")
        if self.select_only is not None:
            # BEP 53: compress consecutive runs ("0,2,4-7")
            runs: list[str] = []
            idxs = sorted(set(self.select_only))
            i = 0
            while i < len(idxs):
                j = i
                while j + 1 < len(idxs) and idxs[j + 1] == idxs[j] + 1:
                    j += 1
                runs.append(
                    str(idxs[i]) if i == j else f"{idxs[i]}-{idxs[j]}"
                )
                i = j + 1
            parts.append("so=" + ",".join(runs))
        return "&".join(parts)


def mutable_magnet_uri(pubkey: bytes, salt: bytes = b"") -> str:
    """BEP 46 shareable URI for a publisher's key (+ optional salt)."""
    if len(pubkey) != 32:
        raise MagnetError("btpk public key must be 32 bytes")
    return Magnet(mutable_key=pubkey, mutable_salt=salt).to_uri()


def _decode_btih(value: str) -> bytes:
    if len(value) == 40:
        try:
            return binascii.unhexlify(value)
        except binascii.Error as e:
            raise MagnetError(f"bad hex info hash {value!r}") from e
    if len(value) == 32:
        try:
            return base64.b32decode(value.upper())
        except binascii.Error as e:
            raise MagnetError(f"bad base32 info hash {value!r}") from e
    raise MagnetError(f"info hash must be 40 hex or 32 base32 chars, got {value!r}")


def parse_magnet(uri: str) -> Magnet:
    """Parse a magnet URI; raises ``MagnetError`` on anything malformed."""
    parsed = urlparse(uri)
    if parsed.scheme != "magnet":
        raise MagnetError(f"not a magnet URI: {uri!r}")
    params = parse_qs(parsed.query)
    # bare "so=" is meaningful (explicit empty selection) but parse_qs
    # drops blank values by default — look it up with blanks kept
    params_blank = parse_qs(parsed.query, keep_blank_values=True)
    info_hash = None
    info_hash_v2 = None
    for xt in params.get("xt", []):
        if xt.startswith("urn:btih:") and info_hash is None:
            info_hash = _decode_btih(xt[len("urn:btih:") :])
        elif xt.startswith("urn:btmh:") and info_hash_v2 is None:
            # BEP 52: sha2-256 multihash — 0x12 (sha2-256) 0x20 (32 bytes).
            # Unrecognized algos/shapes are SKIPPED, not fatal: a hybrid
            # magnet's btih topic must stay usable whatever rides beside it
            mh = xt[len("urn:btmh:") :]
            if len(mh) == 68 and mh.lower().startswith("1220"):
                try:
                    info_hash_v2 = binascii.unhexlify(mh[4:])
                except binascii.Error:
                    pass
    # BEP 46: xs=urn:btpk:<64 hex> names an ed25519 key whose BEP 44
    # mutable item carries the current infohash; s=<hex> is its salt.
    # Malformed btpk/s values SKIP the mutable pointer, same policy as
    # unrecognized btmh shapes above — a magnet with a usable btih/btmh
    # beside a bad pointer must still join; only a magnet whose SOLE
    # topic was the (unusable) pointer fails, via the no-topic error.
    mutable_key = None
    mutable_salt = b""
    for xs in params.get("xs", []):
        if xs.startswith("urn:btpk:") and mutable_key is None:
            pk_hex = xs[len("urn:btpk:") :]
            if len(pk_hex) == 64:
                try:
                    mutable_key = binascii.unhexlify(pk_hex)
                except binascii.Error:
                    pass
    if mutable_key is not None and params.get("s"):
        try:
            mutable_salt = binascii.unhexlify(params["s"][0])
        except binascii.Error:
            mutable_key = None  # pointer unusable without its salt
            mutable_salt = b""
    if info_hash is None and info_hash_v2 is None and mutable_key is None:
        raise MagnetError("magnet URI has no urn:btih/btmh/btpk topic")
    peers: list[tuple[str, int]] = []
    for pe in params.get("x.pe", []):
        host, _, port_s = pe.rpartition(":")
        try:
            port = int(port_s)
        except ValueError as e:
            raise MagnetError(f"bad x.pe address {pe!r}") from e
        if not host or not 0 < port < 65536:
            raise MagnetError(f"bad x.pe address {pe!r}")
        peers.append((host.strip("[]"), port))
    select_only: tuple[int, ...] | None = None
    if "so" in params_blank:
        # BEP 53: "so=0,2,4-7" — indices and inclusive ranges; a bare
        # "so=" is an explicit EMPTY selection (download nothing yet).
        # A magnet carrying an unparsable so= fails loudly (silently
        # downloading EVERYTHING would violate the user's selection),
        # and the total selection is capped: magnet URIs are untrusted
        # input and "so=0-9999999999" must not materialize a range bomb.
        picked: set[int] = set()
        for part in params_blank["so"][0].split(","):
            part = part.strip()
            if not part:
                continue
            lo, dash, hi = part.partition("-")
            try:
                a = int(lo)
                b = int(hi) if dash else a
                if a < 0 or b < a:
                    raise ValueError
            except ValueError as e:
                raise MagnetError(f"bad so= selection {part!r}") from e
            if b - a + 1 > MAX_SELECT_ONLY - len(picked):
                raise MagnetError(f"so= selection exceeds {MAX_SELECT_ONLY} files")
            picked.update(range(a, b + 1))
        select_only = tuple(sorted(picked))
    return Magnet(
        info_hash=info_hash,
        info_hash_v2=info_hash_v2,
        display_name=params["dn"][0] if params.get("dn") else None,
        trackers=tuple(params.get("tr", [])),
        peer_addrs=tuple(peers),
        select_only=select_only,
        web_seeds=tuple(u for u in params.get("ws", []) if u),
        mutable_key=mutable_key,
        mutable_salt=mutable_salt,
    )
