"""BEP 14 Local Service Discovery — find swarm peers on the local network.

No reference counterpart (the reference's only peer source is its
tracker, torrent.ts:224-244). LSD multicasts a small HTTP-styled
``BT-SEARCH`` datagram to 239.192.152.143:6771 announcing
(info_hash, listen port); every local client in the swarm replies with
its own announce, so two laptops on one LAN find each other without any
tracker round-trip — and transfer at LAN speed.

Wire format (from the BEP)::

    BT-SEARCH * HTTP/1.1\r\n
    Host: 239.192.152.143:6771\r\n
    Port: 6881\r\n
    Infohash: <40 hex chars>\r\n
    cookie: <opaque>\r\n
    \r\n\r\n

``cookie`` is an opaque per-client token used to drop our own
multicast echoes. Multiple ``Infohash`` headers may appear in one
datagram (we both send and accept that form). Private torrents
(BEP 27) are never announced.

The group/port are constructor parameters so tests can run the whole
path over plain loopback UDP without multicast routing.
"""

from __future__ import annotations

import asyncio
import random
import socket
import time

from torrent_tpu_torch.utils.log import get_logger

log = get_logger("lsd")

LSD_GROUP = "239.192.152.143"
LSD_PORT = 6771

import ipaddress as _ipaddress

_CGNAT = _ipaddress.ip_network("100.64.0.0/10")  # RFC 6598 carrier-grade NAT
ANNOUNCE_INTERVAL = 300.0  # BEP 14 suggests ~5 min
MAX_INFOHASHES_PER_PACKET = 16


def encode_bt_search(host: str, port: int, info_hashes: list[bytes], cookie: str) -> bytes:
    lines = [
        "BT-SEARCH * HTTP/1.1",
        f"Host: {host}",
        f"Port: {port}",
    ]
    lines += [f"Infohash: {ih.hex().upper()}" for ih in info_hashes]
    lines.append(f"cookie: {cookie}")
    return ("\r\n".join(lines) + "\r\n\r\n\r\n").encode("ascii")


def decode_bt_search(data: bytes) -> tuple[int, list[bytes], str | None] | None:
    """→ (port, info_hashes, cookie) or None for anything malformed."""
    try:
        text = data.decode("ascii", "strict")
    except UnicodeDecodeError:
        return None
    lines = text.split("\r\n")
    if not lines or not lines[0].startswith("BT-SEARCH"):
        return None
    port = None
    cookie = None
    hashes: list[bytes] = []
    for line in lines[1:]:
        key, _, value = line.partition(":")
        key = key.strip().lower()
        value = value.strip()
        if key == "port":
            try:
                port = int(value)
            except ValueError:
                return None
        elif key == "infohash":
            if len(value) != 40:
                continue
            try:
                hashes.append(bytes.fromhex(value))
            except ValueError:
                continue
        elif key == "cookie":
            cookie = value
    if port is None or not 0 < port < 65536 or not hashes:
        return None
    return port, hashes[:MAX_INFOHASHES_PER_PACKET], cookie


class _Proto(asyncio.DatagramProtocol):
    def __init__(self, owner: "LocalServiceDiscovery"):
        self.owner = owner

    def datagram_received(self, data, addr):
        self.owner._on_datagram(data, addr)


class LocalServiceDiscovery:
    """One multicast endpoint shared by every torrent of a client.

    ``on_peer(info_hash, (ip, port))`` fires for every non-self announce
    matching a registered torrent. Registered torrents are re-announced
    every ``interval`` seconds and immediately on registration.
    """

    def __init__(
        self,
        listen_port: int,
        on_peer,
        group: str = LSD_GROUP,
        port: int = LSD_PORT,
        interval: float = ANNOUNCE_INTERVAL,
        multicast: bool = True,
        dest_port: int | None = None,
        allow_global: bool = False,
    ):
        self.allow_global = allow_global
        self.listen_port = listen_port
        self.on_peer = on_peer
        self.group = group
        self.port = port  # bind port (updated to the real one by start())
        # where announces are sent; in multicast mode the group port,
        # in loopback test mode the peer endpoint's bind port
        self.dest_port = port if dest_port is None else dest_port
        self.interval = interval
        self.multicast = multicast
        self.cookie = f"tt-{random.getrandbits(48):012x}"
        self._hashes: set[bytes] = set()
        self._transport = None
        self._task: asyncio.Task | None = None
        # rate-limit unicast replies per source (BEP 14 asks for reply
        # throttling so a flood of searches can't amplify), plus a global
        # replies/s ceiling that bounds both amplification and the dict
        self._last_reply: dict[str, float] = {}
        self._last_reply_any: float = -1e9

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if self.multicast:
                sock.bind(("", self.port))
                mreq = socket.inet_aton(self.group) + socket.inet_aton("0.0.0.0")
                sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
                sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
                sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
            else:  # test mode: plain UDP on loopback
                sock.bind((self.group, self.port))
                self.port = sock.getsockname()[1]
        except OSError:
            sock.close()  # no fd leak on hosts without multicast
            raise
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Proto(self), sock=sock
        )
        self._task = asyncio.create_task(self._announce_loop())

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self._transport is not None:
            self._transport.close()

    # ------------------------------------------------------------ torrents

    def register(self, info_hash: bytes) -> None:
        self._hashes.add(info_hash)
        self._send_announce([info_hash])

    def unregister(self, info_hash: bytes) -> None:
        self._hashes.discard(info_hash)

    # ------------------------------------------------------------ wire

    def _send_announce(self, hashes, dest=None) -> None:
        if self._transport is None or not hashes:
            return
        host = f"{self.group}:{self.dest_port}"
        for i in range(0, len(hashes), MAX_INFOHASHES_PER_PACKET):
            pkt = encode_bt_search(
                host,
                self.listen_port,
                list(hashes)[i : i + MAX_INFOHASHES_PER_PACKET],
                self.cookie,
            )
            try:
                self._transport.sendto(pkt, dest or (self.group, self.dest_port))
            except OSError as e:
                log.debug("lsd send failed: %s", e)

    def _on_datagram(self, data, addr) -> None:
        # LSD is a LOCAL discovery protocol, but the wildcard-bound UDP
        # port is reachable by plain unicast from anywhere: off-LAN
        # sources must be dropped, or a spoofed BT-SEARCH turns every
        # listener into a TCP-dial reflector against an arbitrary victim.
        # Accepted: RFC1918/link-local/loopback plus CGNAT (100.64/10).
        # LANs numbered with globally-routable addresses need
        # ``allow_global=True`` (the kernel gives us no way to tell a
        # TTL-1 multicast arrival from internet unicast here, so the
        # default stays closed).
        try:
            src = _ipaddress.ip_address(addr[0])
            local = (
                src.is_private
                or src.is_link_local
                or src.is_loopback
                or (src.version == 4 and src in _CGNAT)
            )
            if not local and not self.allow_global:
                return
        except ValueError:
            return
        parsed = decode_bt_search(data)
        if parsed is None:
            return
        port, hashes, cookie = parsed
        if cookie == self.cookie:
            return  # our own multicast echo
        matched = [ih for ih in hashes if ih in self._hashes]
        for ih in matched:
            try:
                self.on_peer(ih, (addr[0], port))
            except Exception as e:  # callback bugs must not kill the endpoint
                log.warning("lsd on_peer failed: %s", e)
        if matched:
            # unicast our own announce back so the searcher learns us
            # without waiting for our next multicast round; throttled
            # per-source against search floods
            now = time.monotonic()
            # membership test, not a 0.0 default: monotonic's epoch is
            # arbitrary (seconds-since-boot on Linux), and a 0.0 sentinel
            # would mute every first reply for the first minute of uptime
            if (
                addr[0] not in self._last_reply
                or now - self._last_reply[addr[0]] > 60.0
            ) and now - self._last_reply_any >= 0.5:
                # the global 2-replies/s ceiling both kills reflection
                # amplification toward spoofed victims and hard-bounds
                # the per-source dict (<=120 inserts/min regardless of
                # how many spoofed sources a flood uses)
                self._last_reply_any = now
                if len(self._last_reply) > 256:
                    self._last_reply = {
                        ip: t
                        for ip, t in self._last_reply.items()
                        if now - t <= 60.0
                    }
                self._last_reply[addr[0]] = now
                # reply to the datagram's source address: LSD senders
                # bind the shared group port, so this reaches their
                # endpoint in both multicast and loopback-test modes
                self._send_announce(matched, dest=addr)

    async def _announce_loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval * (0.9 + 0.2 * random.random()))
            self._send_announce(list(self._hashes))
