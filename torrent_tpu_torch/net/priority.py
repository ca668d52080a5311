"""BEP 40 canonical peer priority.

Orders connection candidates by a hash both endpoints compute
identically, so the swarm converges on the same neighbor graph instead
of each client keeping whatever random order its tracker response had
(better overlay mixing, and an attacker can't capture a victim's peer
slots just by announcing first). No reference counterpart — the
reference dials the tracker response in arrival order (torrent.ts:198).

Rule (IPv4): priority = CRC32-C over the two endpoint identities,
masked by how close they are. The ranking itself is pseudo-random but
identical at both ends; the masking makes an attacker's whole subnet
collapse onto a handful of distinct priorities, so address-block Sybils
can't flood a victim's top slots:

- same IP            → the two ports, ascending, 2 bytes each
- same /24           → the two full IPs, ascending, 4 bytes each
- same /16           → both masked with 0xFFFFFF55, ascending
- otherwise          → both masked with 0xFFFF5555, ascending

IPv6 uses the same scheme on the full 128-bit addresses, blurring the
low bits at /64 and /48 distance (ports only for identical IPs).
"""

from __future__ import annotations

import ipaddress

_POLY = 0x82F63B78  # CRC32-C (Castagnoli), reflected


def _make_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def peer_priority(a: tuple[str, int], b: tuple[str, int]) -> int:
    """Canonical connection priority between endpoints ``a`` and ``b``.

    Symmetric; higher = preferred. Returns 0 for unparseable addresses
    or mixed address families (no meaningful distance).
    """
    try:
        ip_a, ip_b = ipaddress.ip_address(a[0]), ipaddress.ip_address(b[0])
    except ValueError:
        return 0
    if ip_a.version != ip_b.version:
        return 0
    if ip_a.version == 4:
        ia, ib = int(ip_a), int(ip_b)
        if ia == ib:
            lo, hi = sorted((a[1] & 0xFFFF, b[1] & 0xFFFF))
            return crc32c(lo.to_bytes(2, "big") + hi.to_bytes(2, "big"))
        if ia ^ ib < 1 << 8:  # same /24
            mask = 0xFFFFFFFF
        elif ia ^ ib < 1 << 16:  # same /16
            mask = 0xFFFFFF55
        else:
            mask = 0xFFFF5555
        lo, hi = sorted((ia & mask, ib & mask))
        return crc32c(lo.to_bytes(4, "big") + hi.to_bytes(4, "big"))
    # IPv6: the same scheme over the FULL 128-bit addresses (truncating
    # would let distinct hosts in one /64 collide into the ports path);
    # the ports path is reserved for identical addresses, and the masks
    # blur the host/subnet bits at /64 and /48 distance
    ia, ib = int(ip_a), int(ip_b)
    if ia == ib:
        lo, hi = sorted((a[1] & 0xFFFF, b[1] & 0xFFFF))
        return crc32c(lo.to_bytes(2, "big") + hi.to_bytes(2, "big"))
    if ia ^ ib < 1 << 64:  # same /64: full addresses
        mask = (1 << 128) - 1
    elif ia ^ ib < 1 << 80:  # same /48: keep /64, blur the host bits
        mask = (((1 << 64) - 1) << 64) | 0x5555555555555555
    else:  # keep /48, blur the rest
        mask = (((1 << 48) - 1) << 80) | int("55" * 10, 16)
    lo, hi = sorted((ia & mask, ib & mask))
    return crc32c(lo.to_bytes(16, "big") + hi.to_bytes(16, "big"))
