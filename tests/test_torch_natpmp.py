"""NAT-PMP (RFC 6886) against a faithful fake gateway on loopback."""

import asyncio
import struct

import pytest

from torrent_tpu_torch.net import natpmp
from torrent_tpu_torch.session.client import Client, ClientConfig

from tests.test_torch_session import run


class FakeGateway(asyncio.DatagramProtocol):
    """Answers external-address and mapping requests like a home router."""

    def __init__(self, external=b"\xc0\x00\x02\x07", drop_first=0, refuse=None):
        self.external = external
        self.drop_first = drop_first  # exercise the retry ladder
        self.refuse = refuse  # result code to return instead of OK
        self.mappings = {}  # (proto_op, internal) -> (external, lifetime)
        self.requests = 0

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        self.requests += 1
        if self.drop_first > 0:
            self.drop_first -= 1
            return
        if len(data) < 2 or data[0] != 0:
            return
        op = data[1]
        if self.refuse is not None:
            self.transport.sendto(
                struct.pack(">BBHI", 0, 128 + op, self.refuse, 1), addr
            )
            return
        if op == natpmp.OP_EXTERNAL:
            self.transport.sendto(
                struct.pack(">BBHI", 0, 128, 0, 1) + self.external, addr
            )
            return
        if op in (natpmp.OP_MAP_UDP, natpmp.OP_MAP_TCP) and len(data) >= 12:
            _, _, _, internal, suggested, lifetime = struct.unpack_from(">BBHHHI", data)
            granted = suggested or internal
            if lifetime == 0:
                self.mappings.pop((op, internal), None)
            else:
                self.mappings[(op, internal)] = (granted, lifetime)
            self.transport.sendto(
                struct.pack(">BBHIHHI", 0, 128 + op, 0, 1, internal, granted, lifetime),
                addr,
            )


async def _gateway(**kw):
    loop = asyncio.get_running_loop()
    transport, proto = await loop.create_datagram_endpoint(
        lambda: FakeGateway(**kw), local_addr=("127.0.0.1", 0)
    )
    return transport, proto, transport.get_extra_info("sockname")[1]


class TestProtocol:
    def test_external_address_and_mapping(self):
        async def go():
            transport, gw, port = await _gateway()
            try:
                ip = await natpmp.external_address("127.0.0.1", port=port)
                assert ip == "192.0.2.7"
                ext, life = await natpmp.map_port(
                    "127.0.0.1", 6881, lifetime=7200, tcp=True, port=port
                )
                assert ext == 6881 and life == 7200
                assert gw.mappings[(natpmp.OP_MAP_TCP, 6881)] == (6881, 7200)
                # delete (lifetime 0)
                await natpmp.map_port("127.0.0.1", 6881, lifetime=0, tcp=True, port=port)
                assert (natpmp.OP_MAP_TCP, 6881) not in gw.mappings
            finally:
                transport.close()

        run(go())

    def test_retry_ladder_survives_dropped_datagrams(self):
        async def go():
            transport, gw, port = await _gateway(drop_first=2)
            try:
                ip = await natpmp.external_address("127.0.0.1", port=port)
                assert ip == "192.0.2.7"
                assert gw.requests >= 3  # two dropped + the answered one
            finally:
                transport.close()

        run(go())

    def test_gateway_refusal_raises(self):
        async def go():
            transport, gw, port = await _gateway(refuse=2)
            try:
                with pytest.raises(natpmp.NatPmpError, match="not authorized"):
                    await natpmp.map_port("127.0.0.1", 6881, port=port)
            finally:
                transport.close()

        run(go())

    def test_unresponsive_gateway_times_out(self):
        async def go():
            transport, gw, port = await _gateway(drop_first=10**6)
            try:
                with pytest.raises(natpmp.NatPmpError, match="no NAT-PMP response"):
                    await natpmp.external_address("127.0.0.1", port=port)
            finally:
                transport.close()

        run(go(), timeout=30)


class TestClientIntegration:
    def test_client_learns_external_ip_and_maps_both_protocols(self):
        async def go():
            transport, gw, port = await _gateway()
            c = Client(ClientConfig(host="127.0.0.1", enable_natpmp=True, hasher="cpu"))
            c._natpmp_gateway = "127.0.0.1"
            c._natpmp_port = port
            try:
                await c.start()
                assert c.external_ip == "192.0.2.7"
                assert (natpmp.OP_MAP_TCP, c.port) in gw.mappings
                assert (natpmp.OP_MAP_UDP, c.port) in gw.mappings
                assert c._natpmp_task is not None  # renewal armed
            finally:
                await c.close()
                transport.close()

        run(go())

    def test_granted_external_port_is_advertised(self):
        """A gateway that maps a DIFFERENT external port must see that
        port advertised to the swarm, and close() must delete mappings."""

        class _Remap(FakeGateway):
            def datagram_received(self, data, addr):
                # force a different external port for TCP mappings
                if len(data) >= 12 and data[1] in (1, 2):
                    version, op, _, internal, _sugg, lifetime = struct.unpack_from(
                        ">BBHHHI", data
                    )
                    granted = 49152 if lifetime else 0
                    if lifetime == 0:
                        self.mappings.pop((op, internal), None)
                    else:
                        self.mappings[(op, internal)] = (granted, lifetime)
                    self.transport.sendto(
                        struct.pack(
                            ">BBHIHHI", 0, 128 + op, 0, 1, internal, granted, lifetime
                        ),
                        addr,
                    )
                    return
                super().datagram_received(data, addr)

        async def go():
            loop = asyncio.get_running_loop()
            transport, gw = await loop.create_datagram_endpoint(
                _Remap, local_addr=("127.0.0.1", 0)
            )
            port = transport.get_extra_info("sockname")[1]
            c = Client(ClientConfig(host="127.0.0.1", enable_natpmp=True, hasher="cpu"))
            c._natpmp_gateway = "127.0.0.1"
            c._natpmp_port = port
            try:
                await c.start()
                assert c.external_port == 49152
                # torrents advertise the forwarded port, not the local one
                from tests.test_torch_session import build_torrent_bytes, fast_config
                from torrent_tpu_torch.codec.metainfo import parse_metainfo
                from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

                m = parse_metainfo(
                    build_torrent_bytes(b"\x00" * 32768, 32768, b"http://127.0.0.1:1/a")
                )
                c.config.torrent = fast_config()
                t = await c.add(m, Storage(MemoryStorage(), m.info))
                assert t.port == 49152
            finally:
                await c.close()
                assert not gw.mappings, "close() must delete the mappings"
                transport.close()

        run(go())

    def test_failure_is_best_effort(self):
        async def go():
            c = Client(ClientConfig(host="127.0.0.1", enable_natpmp=True, hasher="cpu"))
            c._natpmp_gateway = "127.0.0.1"
            c._natpmp_port = 1  # nothing listening
            try:
                await c.start()  # must not raise
                assert c.external_ip is None
            finally:
                await c.close()

        run(go(), timeout=60)
