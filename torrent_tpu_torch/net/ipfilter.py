"""CIDR-based peer blocklists.

No reference counterpart (the reference dials whatever the tracker
returns, torrent.ts:198-222). Real deployments filter known-bad ranges;
the filter sits on both connection directions — candidates are never
dialed and inbound connections drop pre-handshake-reply.
"""

from __future__ import annotations

import ipaddress


class IpFilter:
    """Compiled blocklist: ``blocked(ip)`` in O(#networks).

    Entries are CIDR strings or single addresses; unparseable entries
    raise at construction (a silently-ignored typo in a blocklist is a
    hole, not a convenience).
    """

    def __init__(self, entries=()):
        self._v4: list[ipaddress.IPv4Network] = []
        self._v6: list[ipaddress.IPv6Network] = []
        for entry in entries:
            net = ipaddress.ip_network(entry, strict=False)
            (self._v4 if net.version == 4 else self._v6).append(net)

    def __len__(self) -> int:
        return len(self._v4) + len(self._v6)

    def blocked(self, ip: str) -> bool:
        """True if ``ip`` falls in any configured range; unparseable
        addresses are treated as blocked (fail closed)."""
        if not (self._v4 or self._v6):
            return False
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return True
        if addr.version == 6:
            # dual-stack listeners surface v4 peers as ::ffff:a.b.c.d —
            # those must match the v4 ranges they actually live in
            mapped = addr.ipv4_mapped
            if mapped is not None:
                addr = mapped
        nets = self._v4 if addr.version == 4 else self._v6
        return any(addr in net for net in nets)
