"""NAT-PMP (RFC 6886) port mapping — the lighter sibling of UPnP.

Many home gateways (notably Apple and several open-source firmwares)
speak NAT-PMP but not UPnP IGD; a listening port that peers can't reach
halves a client's connectability. The protocol is two tiny UDP
datagrams to the default gateway on port 5351:

  opcode 0      → external address (result carries the public IPv4)
  opcode 1 / 2  → map a UDP / TCP port (internal, suggested external,
                  lifetime seconds; the gateway answers with the actual
                  external port and lifetime granted)

Requests retry on the RFC's ladder (250 ms doubling) since the first
datagram routinely races the gateway's service start. Everything is
asyncio; the session uses it as a fallback when UPnP finds no IGD
(net/upnp.py) or standalone via ``ClientConfig.enable_natpmp``.
"""

from __future__ import annotations

import asyncio
import ipaddress
import socket
import struct

from torrent_tpu_torch.utils.log import get_logger

log = get_logger("net.natpmp")

NATPMP_PORT = 5351
VERSION = 0
OP_EXTERNAL = 0
OP_MAP_UDP = 1
OP_MAP_TCP = 2
RESULT_OK = 0
_RESULT_TEXT = {
    1: "unsupported version",
    2: "not authorized",
    3: "network failure",
    4: "out of resources",
    5: "unsupported opcode",
}
# RFC 6886 §3.1 ladder: 250 ms doubling; we cap the attempts so a
# gateway without NAT-PMP fails the whole operation in ~4 s, not 64
MAX_ATTEMPTS = 5
FIRST_TIMEOUT = 0.25


class NatPmpError(Exception):
    pass


def default_gateway() -> str | None:
    """The IPv4 default-route gateway from /proc/net/route (Linux)."""
    try:
        with open("/proc/net/route") as f:
            for line in f.readlines()[1:]:
                parts = line.split()
                if len(parts) >= 3 and parts[1] == "00000000":
                    raw = int(parts[2], 16)
                    return str(ipaddress.IPv4Address(socket.ntohl(raw)))
    except (OSError, ValueError):
        pass
    return None


class _Proto(asyncio.DatagramProtocol):
    def __init__(self):
        self.queue: asyncio.Queue = asyncio.Queue()

    def datagram_received(self, data, addr):
        self.queue.put_nowait((data, addr))


async def _request(gateway: str, payload: bytes, expect_opcode: int, port: int = NATPMP_PORT) -> bytes:
    """Send with the RFC retry ladder; return the matching response body."""
    loop = asyncio.get_running_loop()
    transport, proto = await loop.create_datagram_endpoint(
        _Proto, remote_addr=(gateway, port)
    )
    try:
        timeout = FIRST_TIMEOUT
        for _ in range(MAX_ATTEMPTS):
            transport.sendto(payload)
            try:
                deadline = loop.time() + timeout
                while True:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        raise asyncio.TimeoutError
                    data, _addr = await asyncio.wait_for(
                        proto.queue.get(), remaining
                    )
                    if len(data) >= 4 and data[0] == VERSION and data[1] == 128 + expect_opcode:
                        result = struct.unpack_from(">H", data, 2)[0]
                        if result != RESULT_OK:
                            raise NatPmpError(
                                f"gateway refused: {_RESULT_TEXT.get(result, result)}"
                            )
                        return data
                    # unrelated datagram (e.g. another op's late reply)
            except asyncio.TimeoutError:
                timeout *= 2
        raise NatPmpError(f"no NAT-PMP response from {gateway}")
    finally:
        transport.close()


async def external_address(gateway: str, port: int = NATPMP_PORT) -> str:
    """The gateway's public IPv4 address (opcode 0)."""
    data = await _request(gateway, struct.pack(">BB", VERSION, OP_EXTERNAL), OP_EXTERNAL, port)
    if len(data) < 12:
        raise NatPmpError("short external-address response")
    return str(ipaddress.IPv4Address(data[8:12]))


async def map_port(
    gateway: str,
    internal_port: int,
    external_port: int | None = None,
    lifetime: int = 3600,
    tcp: bool = True,
    port: int = NATPMP_PORT,
) -> tuple[int, int]:
    """Request a mapping; returns (granted external port, lifetime s).

    ``lifetime=0`` deletes the mapping (RFC 6886 §3.4)."""
    op = OP_MAP_TCP if tcp else OP_MAP_UDP
    payload = struct.pack(
        ">BBHHHI",
        VERSION,
        op,
        0,
        internal_port,
        external_port if external_port is not None else internal_port,
        lifetime,
    )
    data = await _request(gateway, payload, op, port)
    if len(data) < 16:
        raise NatPmpError("short mapping response")
    _epoch, internal, external, granted = struct.unpack_from(">IHHI", data, 4)
    if internal != internal_port:
        raise NatPmpError("mapping response for a different port")
    return external, granted
