"""uTP (BEP 29) transport tests: packet codec, live loopback streams,
loss/reordering recovery, connection lifecycle. (No reference
counterpart — the reference is TCP-only.)"""

import asyncio
import random

import pytest

from torrent_tpu_torch.net import utp
from tests.test_torch_session import run


class TestCodec:
    def test_roundtrip(self):
        pkt = utp.encode_packet(
            utp.ST_DATA, 0xBEEF, 123, 456, ts=7, ts_diff=9, wnd=1 << 16, payload=b"hi"
        )
        ptype, cid, ts, diff, wnd, seq, ack, payload, sack = utp.decode_packet(pkt)
        assert sack is None
        assert (ptype, cid, ts, diff, wnd, seq, ack, payload) == (
            utp.ST_DATA, 0xBEEF, 7, 9, 1 << 16, 123, 456, b"hi",
        )

    def test_decode_rejects_garbage(self):
        assert utp.decode_packet(b"") is None
        assert utp.decode_packet(b"\x00" * 10) is None  # short
        bad_ver = bytearray(utp.encode_packet(utp.ST_DATA, 1, 1, 1))
        bad_ver[0] = (utp.ST_DATA << 4) | 7
        assert utp.decode_packet(bytes(bad_ver)) is None
        bad_type = bytearray(utp.encode_packet(utp.ST_DATA, 1, 1, 1))
        bad_type[0] = (9 << 4) | utp.VERSION
        assert utp.decode_packet(bytes(bad_type)) is None

    def test_seq_lt_wraps(self):
        assert utp._seq_lt(0xFFFE, 2)
        assert not utp._seq_lt(2, 0xFFFE)
        assert not utp._seq_lt(5, 5)

    def test_pad_extension_roundtrip_and_chains(self):
        """Raise probes pad packets with chained PAD_EXT entries; the
        decoder must skip them (payload and sack unchanged) at any pad
        size, including multi-entry chains alongside a SACK."""
        for pad in (1, 255, 256, 600, 62 * 1024):
            pkt = utp.encode_packet(
                utp.ST_DATA, 1, 2, 3, payload=b"data", pad=pad
            )
            out = utp.decode_packet(pkt)
            assert out is not None
            assert out[7] == b"data" and out[8] is None
        pkt = utp.encode_packet(
            utp.ST_STATE, 1, 2, 3, sack=b"\x01\x00\x00\x00", pad=300
        )
        out = utp.decode_packet(pkt)
        assert out[7] == b"" and out[8] == b"\x01\x00\x00\x00"

    def test_decode_survives_hostile_extension_chains(self):
        """Truncated/cyclic/oversized extension chains must return None
        or parse cleanly — never raise (hostile-datagram surface)."""
        import random as _r

        base = utp.encode_packet(utp.ST_DATA, 1, 2, 3, payload=b"x", pad=600)
        rng = _r.Random(99)
        for _ in range(2000):
            buf = bytearray(base)
            for _ in range(rng.randrange(1, 6)):
                i = rng.randrange(len(buf))
                buf[i] = rng.randrange(256)
            cut = rng.randrange(len(buf) + 1)
            utp.decode_packet(bytes(buf[:cut]))  # must not raise


async def _echo_pair():
    """Acceptor echoes everything it reads back to the sender."""

    async def echo(reader, writer):
        while True:
            data = await reader.read(65536)
            if not data:
                break
            writer.write(data)
            await writer.drain()
        writer.close()

    server = await utp.create_utp_endpoint("127.0.0.1", 0, on_accept=echo)
    return server


class TestLoopback:
    def test_small_roundtrip(self):
        async def go():
            server = await _echo_pair()
            try:
                reader, writer = await utp.open_utp_connection(
                    "127.0.0.1", server.port, timeout=5
                )
                writer.write(b"hello utp")
                await writer.drain()
                got = await asyncio.wait_for(reader.readexactly(9), 5)
                assert got == b"hello utp"
                writer.close()
            finally:
                server.close()

        run(go())

    def test_large_transfer_multi_packet(self):
        async def go():
            server = await _echo_pair()
            try:
                reader, writer = await utp.open_utp_connection(
                    "127.0.0.1", server.port, timeout=5
                )
                payload = random.Random(7).randbytes(512 * 1024)
                writer.write(payload)
                await writer.drain()
                got = await asyncio.wait_for(reader.readexactly(len(payload)), 30)
                assert got == payload
                writer.close()
            finally:
                server.close()

        run(go())

    def test_dial_refused_when_no_acceptor(self):
        async def go():
            server = await utp.create_utp_endpoint("127.0.0.1", 0, on_accept=None)
            try:
                with pytest.raises((ConnectionError, OSError)):
                    await utp.open_utp_connection("127.0.0.1", server.port, timeout=5)
            finally:
                server.close()

        run(go())

    def test_fin_gives_reader_eof(self):
        async def go():
            done = asyncio.Event()
            got = bytearray()

            async def consume(reader, writer):
                while True:
                    data = await reader.read(65536)
                    if not data:
                        break
                    got.extend(data)
                done.set()

            server = await utp.create_utp_endpoint("127.0.0.1", 0, on_accept=consume)
            try:
                reader, writer = await utp.open_utp_connection(
                    "127.0.0.1", server.port, timeout=5
                )
                writer.write(b"x" * 5000)
                await writer.drain()
                writer.close()  # flush + FIN
                await asyncio.wait_for(done.wait(), 10)
                assert bytes(got) == b"x" * 5000
            finally:
                server.close()

        run(go())


class _LossyEndpoint(utp.UtpEndpoint):
    """Deterministically drops a fraction of outgoing packets (never the
    handshake) to force the retransmit machinery to do the work."""

    def __init__(self, *a, drop_every=4, **kw):
        super().__init__(*a, **kw)
        self._n = 0
        self._drop_every = drop_every

    def sendto(self, data, addr):
        parsed = utp.decode_packet(data)
        self._n += 1
        if (
            parsed is not None
            and parsed[0] == utp.ST_DATA
            and self._n % self._drop_every == 0
        ):
            return  # dropped on the floor
        super().sendto(data, addr)


class TestLossRecovery:
    def test_transfer_survives_25pct_data_loss(self):
        async def go():
            received = bytearray()
            done = asyncio.Event()
            total = 256 * 1024

            async def consume(reader, writer):
                while len(received) < total:
                    data = await reader.read(65536)
                    if not data:
                        break
                    received.extend(data)
                done.set()

            loop = asyncio.get_running_loop()
            _, server = await loop.create_datagram_endpoint(
                lambda: utp.UtpEndpoint(consume), local_addr=("127.0.0.1", 0)
            )
            _, client = await loop.create_datagram_endpoint(
                lambda: _LossyEndpoint(drop_every=4), local_addr=("127.0.0.1", 0)
            )
            try:
                reader, writer = await client.dial("127.0.0.1", server.port, timeout=5)
                payload = random.Random(3).randbytes(total)
                writer.write(payload)
                await writer.drain()
                await asyncio.wait_for(done.wait(), 60)
                assert bytes(received) == payload
            finally:
                client.close()
                server.close()

        run(go())

    def test_reordering_reassembles(self):
        async def go():
            # feed a connection three out-of-order DATA packets directly
            class _Sink:
                def sendto(self, data, addr):
                    pass

                def _forget(self, conn):
                    pass

            conn = utp.UtpConnection(_Sink(), ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 100
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 103, 0, b"c")
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 102, 0, b"b")
            assert conn.reader._buffer == bytearray()  # hole at 101
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 101, 0, b"a")
            assert bytes(conn.reader._buffer) == b"abc"
            assert conn.ack_nr == 103

        run(go())

    def test_max_retransmits_kills_connection(self):
        async def go():
            class _Blackhole:
                def sendto(self, data, addr):
                    pass

                def _forget(self, conn):
                    pass

            conn = utp.UtpConnection(_Blackhole(), ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.rto = 0.01
            await conn.send(b"doomed")
            for _ in range(400):
                if conn.closed:
                    break
                await asyncio.sleep(0.02)
            assert conn.closed and conn._reset

        run(go())


class TestSwarmOverUtp:
    def test_full_transfer_over_utp(self, tmp_path):
        """Real two-client swarm where the peer connection itself runs
        over uTP (BitTorrent handshake + all messages through the
        reliable-UDP stream), verified by the writer types."""
        import hashlib
        import os

        import numpy as np

        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.net.utp import _UtpWriter
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig

        async def go():
            plen = 32768
            payload = np.random.default_rng(21).integers(
                0, 256, 5 * plen + 77, dtype=np.uint8
            ).tobytes()
            digs = [
                hashlib.sha1(payload[i : i + plen]).digest()
                for i in range(0, len(payload), plen)
            ]
            server, _ = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            meta = bencode(
                {
                    b"announce": b"http://127.0.0.1:%d/announce" % server.http_port,
                    b"info": {
                        b"name": b"utp.bin",
                        b"piece length": plen,
                        b"pieces": b"".join(digs),
                        b"length": len(payload),
                    },
                }
            )
            m = parse_metainfo(meta)
            seed_dir, leech_dir = str(tmp_path / "s"), str(tmp_path / "l")
            os.makedirs(seed_dir)
            os.makedirs(leech_dir)
            open(os.path.join(seed_dir, "utp.bin"), "wb").write(payload)
            c1 = Client(ClientConfig(port=0, enable_upnp=False, enable_utp=True, hasher="cpu"))
            c2 = Client(ClientConfig(port=0, enable_upnp=False, enable_utp=True, hasher="cpu"))
            await c1.start()
            await c2.start()
            try:
                t1 = await c1.add(m, seed_dir)
                t2 = await c2.add(m, leech_dir)
                for _ in range(600):
                    if t2.bitfield.complete:
                        break
                    await asyncio.sleep(0.05)
                assert t2.bitfield.complete, f"uTP swarm stalled: {t2.status()}"
                got = open(os.path.join(leech_dir, "utp.bin"), "rb").read()
                assert got == payload
                writers = [
                    p.writer
                    for p in list(t1.peers.values()) + list(t2.peers.values())
                ]
                assert writers and all(
                    isinstance(w, _UtpWriter) for w in writers
                ), f"expected uTP transports, got {[type(w) for w in writers]}"
            finally:
                await c1.close()
                await c2.close()
                server.close()

        run(go())


class TestTcpFallback:
    def test_utp_client_reaches_tcp_only_seed(self, tmp_path):
        """Happy-eyeballs: a uTP-enabled leech must still connect (fast)
        to a TCP-only seed via the raced TCP dial."""
        import hashlib
        import os
        import time as _time

        import numpy as np

        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig

        async def go():
            plen = 32768
            payload = np.random.default_rng(31).integers(
                0, 256, 3 * plen, dtype=np.uint8
            ).tobytes()
            digs = [
                hashlib.sha1(payload[i : i + plen]).digest()
                for i in range(0, len(payload), plen)
            ]
            server, _ = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            meta = bencode(
                {
                    b"announce": b"http://127.0.0.1:%d/announce" % server.http_port,
                    b"info": {
                        b"name": b"fb.bin",
                        b"piece length": plen,
                        b"pieces": b"".join(digs),
                        b"length": len(payload),
                    },
                }
            )
            m = parse_metainfo(meta)
            seed_dir, leech_dir = str(tmp_path / "s2"), str(tmp_path / "l2")
            os.makedirs(seed_dir)
            os.makedirs(leech_dir)
            open(os.path.join(seed_dir, "fb.bin"), "wb").write(payload)
            c1 = Client(ClientConfig(port=0, enable_upnp=False, hasher="cpu"))  # TCP-only seed
            c2 = Client(ClientConfig(port=0, enable_upnp=False, enable_utp=True, hasher="cpu"))
            await c1.start()
            await c2.start()
            try:
                t1 = await c1.add(m, seed_dir)
                t0 = _time.monotonic()
                t2 = await c2.add(m, leech_dir)
                for _ in range(600):
                    if t2.bitfield.complete:
                        break
                    await asyncio.sleep(0.05)
                assert t2.bitfield.complete, f"fallback stalled: {t2.status()}"
                # fallback must be fast (happy-eyeballs), not a serial
                # 8 s uTP timeout before TCP starts
                assert _time.monotonic() - t0 < 15
            finally:
                await c1.close()
                await c2.close()
                server.close()

        run(go())


class TestFlowControl:
    def test_slow_consumer_pauses_sender(self):
        """A consumer that stops reading must close the advertised window
        and pause the sender (bounded receive buffer), then reopen it on
        drain — the uTP analogue of TCP backpressure that the session's
        download rate caps rely on."""

        async def go():
            hold = asyncio.Event()
            drained = asyncio.Event()
            total = 4 * 1024 * 1024  # 4x the receive window

            async def consume(reader, writer):
                got = 0
                await hold.wait()  # don't read until told
                while got < total:
                    data = await reader.read(65536)
                    if not data:
                        break
                    got += len(data)
                drained.set()

            server = await utp.create_utp_endpoint("127.0.0.1", 0, on_accept=consume)
            try:
                reader, writer = await utp.open_utp_connection(
                    "127.0.0.1", server.port, timeout=5
                )
                payload = b"z" * total
                send_task = asyncio.create_task(writer._conn.send(payload))
                await asyncio.sleep(1.0)
                # with the consumer stalled, the server-side buffer must
                # be capped near RECV_WINDOW, not hold all 4 MiB
                conn = list(server._conns.values())[0]
                buffered = len(conn.reader._buffer)
                assert buffered <= utp.RECV_WINDOW + 64 * utp.MTU, buffered
                assert not send_task.done()  # sender is paused
                hold.set()  # consumer drains -> window reopens
                await asyncio.wait_for(send_task, 60)
                await asyncio.wait_for(drained.wait(), 60)
            finally:
                server.close()

        run(go())


class TestUtpWithRateCap:
    def test_throttled_swarm_over_utp(self, tmp_path):
        """Download cap + uTP together: the token bucket pauses the peer
        loop, uTP's advertised window pushes the backpressure to the
        sender, and the transfer still completes at ~the capped rate."""
        import hashlib
        import os
        import time as _time

        import numpy as np

        from torrent_tpu_torch.codec.bencode import bencode
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.server.in_memory import run_tracker
        from torrent_tpu_torch.server.tracker import ServeOptions
        from torrent_tpu_torch.session.client import Client, ClientConfig

        async def go():
            plen = 32768
            payload = np.random.default_rng(41).integers(
                0, 256, 8 * plen, dtype=np.uint8
            ).tobytes()
            digs = [
                hashlib.sha1(payload[i : i + plen]).digest()
                for i in range(0, len(payload), plen)
            ]
            server, _ = await run_tracker(
                ServeOptions(http_port=0, udp_port=None, interval=1)
            )
            meta = bencode(
                {
                    b"announce": b"http://127.0.0.1:%d/announce" % server.http_port,
                    b"info": {
                        b"name": b"tu.bin",
                        b"piece length": plen,
                        b"pieces": b"".join(digs),
                        b"length": len(payload),
                    },
                }
            )
            m = parse_metainfo(meta)
            seed_dir = str(tmp_path / "tus")
            os.makedirs(seed_dir)
            open(os.path.join(seed_dir, "tu.bin"), "wb").write(payload)
            c1 = Client(ClientConfig(port=0, enable_upnp=False, enable_utp=True, hasher="cpu"))
            c2 = Client(
                ClientConfig(
                    port=0, enable_upnp=False, enable_utp=True,
                    max_download_bps=128 * 1024, hasher="cpu",
                )
            )
            await c1.start()
            await c2.start()
            try:
                await c1.add(m, seed_dir)
                d = str(tmp_path / "tul")
                os.makedirs(d)
                t0 = _time.monotonic()
                t = await c2.add(m, d)
                for _ in range(1200):
                    if t.bitfield.complete:
                        break
                    await asyncio.sleep(0.05)
                dt = _time.monotonic() - t0
                assert t.bitfield.complete, t.status()
                # 256 KiB at 128 KiB/s with a 1 s burst: >= ~1 s floor
                assert dt >= 0.9, f"cap ignored over uTP: {dt:.2f}s"
                got = open(os.path.join(d, "tu.bin"), "rb").read()
                assert got == payload
                from torrent_tpu_torch.net.utp import _UtpWriter

                assert all(
                    isinstance(p.writer, _UtpWriter) for p in t.peers.values()
                )
            finally:
                await c1.close()
                await c2.close()
                server.close()

        run(go(), timeout=90)


class TestSack:
    def test_sack_codec_roundtrip(self):
        mask = bytes([0b101, 0, 0, 0b10000000])
        pkt = utp.encode_packet(utp.ST_STATE, 5, 9, 11, sack=mask)
        ptype, cid, ts, diff, wnd, seq, ack, payload, sack = utp.decode_packet(pkt)
        assert (ptype, cid, seq, ack) == (utp.ST_STATE, 5, 9, 11)
        assert sack == mask and payload == b""

    def test_build_sack_sets_expected_bits(self):
        class _Sink:
            def sendto(self, data, addr):
                pass

            def _forget(self, conn):
                pass

        async def go():
            conn = utp.UtpConnection(_Sink(), ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 100
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 102, 0, b"b")  # bit 0
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 105, 0, b"e")  # bit 3
            mask = conn._build_sack()
            assert mask is not None and len(mask) % 4 == 0
            assert mask[0] == 0b1001

        run(go())

    def test_apply_sack_releases_and_fast_resends_hole(self):
        sent = []

        class _Record:
            def sendto(self, data, addr):
                sent.append(data)

            def _forget(self, conn):
                pass

        async def go():
            conn = utp.UtpConnection(_Record(), ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            for payload in (b"x" * 100, b"y" * 100, b"z" * 100, b"w" * 100):
                await conn.send(payload)
            first = min(conn._outstanding, key=lambda s: (conn.seq_nr - s) & 0xFFFF)
            # peer acks nothing cumulatively (ack = first-1) but SACKs
            # the three packets after the hole at `first`
            ack = (first - 1) & 0xFFFF
            mask = bytes([0b111, 0, 0, 0])  # first+1, first+2, first+3
            before = len(sent)
            conn.on_packet(utp.ST_STATE, 0, 0, 1 << 20, 0, ack, b"", mask)
            assert list(conn._outstanding) == [first]  # others released
            # the hole was fast-resent exactly once
            assert len(sent) == before + 1
            assert conn.retx_count == 1

        run(go())

    def test_sack_reduces_retransmitted_bytes(self):
        """Same lossy transfer with and without SACK: the SACK run must
        retransmit measurably fewer payload bytes (VERDICT r2 #6).

        The link adds real latency — on a zero-RTT loopback both paths
        retransmit only what was actually lost; with dup-acks arriving
        across a 25 ms RTT the cumulative-ack path re-resends the same
        hole every few duplicates while the SACK path resends it once."""

        class _DelayedLossy(_LossyEndpoint):
            def sendto(self, data, addr):
                parsed = utp.decode_packet(data)
                self._n += 1
                if (
                    parsed is not None
                    and parsed[0] == utp.ST_DATA
                    and self._n % self._drop_every == 0
                ):
                    return
                transport = self.transport
                asyncio.get_running_loop().call_later(
                    0.0125, lambda: transport and transport.sendto(data, addr)
                )

        async def transfer_with(sack_on: bool) -> int:
            old = utp.SACK_ENABLED
            old_ladder = utp.MTU_LADDER_LOOPBACK
            utp.SACK_ENABLED = sack_on
            # this test measures SACK at real-network packet sizes; the
            # loopback jumbo rung would fit the whole payload in ~4
            # packets and degenerate the loss pattern
            utp.MTU_LADDER_LOOPBACK = utp.MTU_LADDER
            try:
                received = bytearray()
                done = asyncio.Event()
                total = 256 * 1024

                async def consume(reader, writer):
                    while len(received) < total:
                        data = await reader.read(65536)
                        if not data:
                            break
                        received.extend(data)
                    done.set()

                loop = asyncio.get_running_loop()
                _, server = await loop.create_datagram_endpoint(
                    lambda: utp.UtpEndpoint(consume), local_addr=("127.0.0.1", 0)
                )
                # moderate loss: the window must stay large enough that a
                # single loss yields a long dup-ack train (heavy loss pins
                # cwnd at the floor where neither path resends spuriously)
                _, client = await loop.create_datagram_endpoint(
                    lambda: _DelayedLossy(drop_every=20),
                    local_addr=("127.0.0.1", 0),
                )
                try:
                    reader, writer = await client.dial(
                        "127.0.0.1", server.port, timeout=5
                    )
                    payload = random.Random(11).randbytes(total)
                    writer.write(payload)
                    await writer.drain()
                    await asyncio.wait_for(done.wait(), 60)
                    assert bytes(received) == payload
                    return writer._conn.retx_bytes
                finally:
                    client.close()
                    server.close()
            finally:
                utp.SACK_ENABLED = old
                utp.MTU_LADDER_LOOPBACK = old_ladder

        async def go():
            # single lossy runs have scheduling jitter: retry the
            # comparison once before declaring a regression
            for attempt in range(2):
                with_sack = await transfer_with(True)
                without = await transfer_with(False)
                if with_sack < without:
                    return
            assert with_sack < without, (with_sack, without)

        run(go(), timeout=300)


class _ClampedEndpoint(utp.UtpEndpoint):
    """Silently drops any datagram larger than `clamp` bytes — a
    path-MTU black hole (no ICMP comes back on the real internet
    either when a middlebox filters frag-needed)."""

    clamp = 1300

    def sendto(self, data, addr):
        if len(data) > self.clamp:
            return
        super().sendto(data, addr)


class TestPathMtu:
    def test_transfer_through_1280_clamped_link(self):
        """Dial-side SYN probing must settle on a payload budget that
        fits a 1300-byte datagram clamp and complete a bulk transfer
        (fixed 1400-byte payloads would black-hole forever)."""

        async def go():
            received = bytearray()
            done = asyncio.Event()
            total = 64 * 1024

            async def consume(reader, writer):
                while len(received) < total:
                    data = await reader.read(65536)
                    if not data:
                        break
                    received.extend(data)
                done.set()

            loop = asyncio.get_running_loop()
            _, server = await loop.create_datagram_endpoint(
                lambda: _ClampedEndpoint(consume), local_addr=("127.0.0.1", 0)
            )
            _, client = await loop.create_datagram_endpoint(
                _ClampedEndpoint, local_addr=("127.0.0.1", 0)
            )
            try:
                # shorten the probe RTOs so the ladder walks quickly
                reader, writer = await client.dial("127.0.0.1", server.port, timeout=15)
                conn = writer._conn
                assert conn.mtu <= 1280, conn.mtu
                payload = random.Random(13).randbytes(total)
                writer.write(payload)
                await writer.drain()
                await asyncio.wait_for(done.wait(), 60)
                assert bytes(received) == payload
                # the acceptor adopted the probed budget for its own sends
                srv_conn = list(server._conns.values())[0]
                assert srv_conn.mtu <= 1280, srv_conn.mtu
                # the incremental inflight counter survived the ladder's
                # in-place SYN re-encodes: drained connection == zero
                # phantom bytes (regression: re-encode leaked the pad
                # delta forever)
                for _ in range(100):
                    if not conn._outstanding:
                        break
                    await asyncio.sleep(0.05)
                assert conn._inflight_data == sum(
                    len(e[0]) - 20 for e in conn._outstanding.values()
                )
            finally:
                client.close()
                server.close()

        run(go(), timeout=120)

    def test_mtu_raises_after_link_unclamps_mid_transfer(self):
        """r3 verdict #7 (DPLPMTUD-style raise probing): a connection
        whose SYN ladder settled at 1280 behind a transient clamp climbs
        back up — all the way to the loopback jumbo rung — once the link
        un-clamps, within a few round trips of padded-DATA probes."""

        async def go():
            import time as _time

            done = asyncio.Event()
            got = bytearray()

            async def consume(reader, writer):
                while True:
                    data = await reader.read(1 << 20)
                    if not data:
                        break
                    got.extend(data)
                    if len(got) >= 2 << 20:
                        done.set()

            loop = asyncio.get_running_loop()
            _, server = await loop.create_datagram_endpoint(
                lambda: _ClampedEndpoint(consume), local_addr=("127.0.0.1", 0)
            )
            _, client = await loop.create_datagram_endpoint(
                _ClampedEndpoint, local_addr=("127.0.0.1", 0)
            )
            try:
                reader, writer = await client.dial("127.0.0.1", server.port, timeout=15)
                conn = writer._conn
                assert conn.mtu <= 1280, conn.mtu
                assert conn._mtu_raise_at > 0  # probing armed
                # un-clamp the path and make probes eligible immediately
                client.clamp = 1 << 30
                server.clamp = 1 << 30
                conn._mtu_raise_interval = 0.05
                conn._mtu_raise_at = _time.monotonic()
                payload = random.Random(17).randbytes(2 << 20)
                writer.write(payload)
                sent = [payload]
                deadline = _time.monotonic() + 45
                while (
                    conn.mtu < conn._mtu_ladder[0]
                    and _time.monotonic() < deadline
                ):
                    # keep full-budget chunks flowing: the jumbo probe is
                    # admitted only once cwnd has grown to carry it
                    extra = random.Random(len(sent)).randbytes(256 * 1024)
                    writer.write(extra)
                    sent.append(extra)
                    await writer.drain()
                    await asyncio.sleep(0.02)
                assert conn.mtu == conn._mtu_ladder[0], conn.mtu  # jumbo
                await writer.drain()
                whole = b"".join(sent)
                deadline = _time.monotonic() + 30
                while len(got) < len(whole) and _time.monotonic() < deadline:
                    await asyncio.sleep(0.05)
                assert bytes(got) == whole  # stream intact through probes
            finally:
                client.close()
                server.close()

        run(go(), timeout=90)

    def test_failed_raise_probe_backs_off_and_stream_survives(self):
        """A probe that vanishes (link still clamped) is retransmitted
        WITHOUT the pad — identical stream bytes — and the probe cadence
        backs off instead of hammering the black hole."""

        async def go():
            import time as _time

            done = asyncio.Event()
            got = bytearray()
            total = 256 * 1024

            async def consume(reader, writer):
                while len(got) < total:
                    data = await reader.read(1 << 20)
                    if not data:
                        break
                    got.extend(data)
                done.set()

            loop = asyncio.get_running_loop()
            _, server = await loop.create_datagram_endpoint(
                lambda: _ClampedEndpoint(consume), local_addr=("127.0.0.1", 0)
            )
            _, client = await loop.create_datagram_endpoint(
                _ClampedEndpoint, local_addr=("127.0.0.1", 0)
            )
            try:
                reader, writer = await client.dial("127.0.0.1", server.port, timeout=15)
                conn = writer._conn
                assert conn.mtu <= 1280, conn.mtu
                conn._mtu_raise_interval = 0.05
                conn._mtu_raise_at = _time.monotonic()
                payload = random.Random(19).randbytes(total)
                writer.write(payload)
                await writer.drain()
                await asyncio.wait_for(done.wait(), 60)
                assert bytes(got) == payload  # bare retransmit: no corruption
                # still clamped: budget unchanged, cadence backed off
                assert conn.mtu <= 1280, conn.mtu
                assert conn._mtu_raise_interval > 0.05
            finally:
                client.close()
                server.close()

        run(go(), timeout=120)

    def test_duplicate_syn_tighten_rearms_raise_probing(self):
        """A stale duplicate SYN with a smaller pad tightens an existing
        connection's budget — that clamp must re-arm upward probing (and
        the loopback acceptor's raise ladder tops at the jumbo rung), or
        the connection is pinned low forever."""

        async def go():
            server = await _echo_pair()
            try:
                reader, writer = await utp.open_utp_connection(
                    "127.0.0.1", server.port, timeout=5
                )
                (addr, rid), srv_conn = next(iter(server._conns.items()))
                assert srv_conn.mtu == utp.JUMBO_MTU
                assert srv_conn._mtu_ladder[0] == utp.JUMBO_MTU  # loopback
                assert srv_conn._mtu_raise_at == 0  # at the top: off
                dup_syn = utp.encode_packet(
                    utp.ST_SYN, (rid - 1) & 0xFFFF, 1, 0, payload=b"\x00" * 1400
                )
                server.datagram_received(dup_syn, addr)
                assert srv_conn.mtu == 1400  # tightened
                assert srv_conn._mtu_raise_at > 0  # ...and re-armed
                writer.close()
            finally:
                server.close()

        run(go())

    def test_unclamped_dial_keeps_full_mtu(self):
        """An unclamped LOOPBACK dial adopts the jumbo first rung (local
        paths carry ~64 KiB datagrams); the standard ladder's top is what
        non-loopback dials see (covered by the clamped-link tests, whose
        relays force the step-down)."""

        async def go():
            server = await _echo_pair()
            try:
                reader, writer = await utp.open_utp_connection(
                    "127.0.0.1", server.port, timeout=5
                )
                assert writer._conn.mtu == utp.JUMBO_MTU
                writer.close()
            finally:
                server.close()

        run(go())


class TestAcceptCap:
    """bounded-state hardening: a spoofed-source SYN flood must not grow
    per-connection state past MAX_LIVE_CONNS — at capacity fresh SYNs
    get ST_RESET and no UtpConnection is allocated."""

    def test_syn_flood_refused_at_capacity(self, monkeypatch):
        monkeypatch.setattr(utp, "MAX_LIVE_CONNS", 1)

        async def go():
            server = await _echo_pair()
            try:
                reader, writer = await utp.open_utp_connection(
                    "127.0.0.1", server.port, timeout=5
                )
                assert len(server._conns) == 1
                sent = []
                monkeypatch.setattr(
                    server, "sendto", lambda data, addr: sent.append((data, addr))
                )
                syn = utp.encode_packet(utp.ST_SYN, 777, 1, 0)
                server.datagram_received(syn, ("127.0.0.2", 40000))
                assert len(server._conns) == 1  # refused, not grown
                assert sent, "capacity refusal must answer, not black-hole"
                ptype = utp.decode_packet(sent[-1][0])[0]
                assert ptype == utp.ST_RESET
                writer.close()
            finally:
                server.close()

        run(go())


class TestAdviceFixes:
    """Round-2 ADVICE items: ooo FIN, hostile-sender windows, dial keying."""

    class _Sink:
        def sendto(self, data, addr):
            pass

        def _forget(self, conn):
            pass

    def test_out_of_order_fin_closes_without_rto(self):
        async def go():
            conn = utp.UtpConnection(self._Sink(), ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 100
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 102, 0, b"b")
            conn.on_packet(utp.ST_FIN, 0, 0, 1 << 20, 103, 0, b"")  # ooo FIN
            assert not conn.closed  # hole at 101 still open
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 101, 0, b"a")
            assert bytes(conn.reader._buffer) == b"ab"
            assert conn.closed and not conn._reset  # graceful, immediate

        run(go())

    def test_hostile_sender_cannot_overrun_recv_window(self):
        async def go():
            conn = utp.UtpConnection(self._Sink(), ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 0
            chunk = b"q" * 65536
            for seq in range(1, 100):  # ~6.2 MiB in-order, never consumed
                conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, seq, 0, chunk)
            assert len(conn.reader._buffer) <= utp.RECV_WINDOW
            # over-window packets were not acked: sender must retransmit
            assert conn.ack_nr < 99

        run(go())

    def test_ooo_buffer_bytes_capped(self):
        async def go():
            conn = utp.UtpConnection(self._Sink(), ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 0
            chunk = b"q" * 65536
            for seq in range(2, 120):  # hole at 1; all buffered out-of-order
                conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, seq, 0, chunk)
            assert conn._ooo_bytes <= utp.RECV_WINDOW

        run(go())

    def test_dial_by_hostname_resolves(self):
        async def go():
            server = await _echo_pair()
            try:
                reader, writer = await utp.open_utp_connection(
                    "localhost", server.port, timeout=5
                )
                writer.write(b"named")
                await writer.drain()
                assert await asyncio.wait_for(reader.readexactly(5), 5) == b"named"
                writer.close()
            finally:
                server.close()

        run(go())

    def test_dial_noncanonical_ipv6_text(self):
        async def go():
            try:
                server = await utp.create_utp_endpoint("::1", 0, on_accept=None)
            except OSError:
                pytest.skip("no IPv6 loopback")

            async def echo(reader, writer):
                writer.write(await reader.read(5))
                await writer.drain()

            server.on_accept = echo
            loop = asyncio.get_running_loop()
            _, client = await loop.create_datagram_endpoint(
                utp.UtpEndpoint, local_addr=("::1", 0)
            )
            try:
                # "0:0:0:0:0:0:0:1" must canonicalize to "::1" so inbound
                # datagrams (keyed by the kernel's text) find the conn
                reader, writer = await client.dial(
                    "0:0:0:0:0:0:0:1", server.port, timeout=5
                )
                writer.write(b"six66")
                await writer.drain()
                assert await asyncio.wait_for(reader.readexactly(5), 5) == b"six66"
            finally:
                client.close()
                server.close()

        run(go())


class TestBareSynFallback:
    def test_peer_dropping_padded_syns_still_connects(self):
        """BEP 29 says SYN carries no data — a strict peer may discard
        padded probe SYNs. The ladder must reach the bare-SYN fallback
        within the default dial timeout (no RTO backoff while probing)."""

        class _NoPaddedSyn(utp.UtpEndpoint):
            def sendto(self, data, addr):
                parsed = utp.decode_packet(data)
                if (
                    parsed is not None
                    and parsed[0] == utp.ST_SYN
                    and parsed[7]  # payload present
                ):
                    return  # strict peer never sees padded SYNs
                super().sendto(data, addr)

        async def go():
            async def echo(reader, writer):
                writer.write(await reader.read(4))
                await writer.drain()

            loop = asyncio.get_running_loop()
            _, server = await loop.create_datagram_endpoint(
                lambda: utp.UtpEndpoint(echo), local_addr=("127.0.0.1", 0)
            )
            _, client = await loop.create_datagram_endpoint(
                _NoPaddedSyn, local_addr=("127.0.0.1", 0)
            )
            try:
                reader, writer = await client.dial("127.0.0.1", server.port, timeout=10)
                assert writer._conn.mtu == utp.MTU_LADDER[-1]
                writer.write(b"bare")
                await writer.drain()
                assert await asyncio.wait_for(reader.readexactly(4), 5) == b"bare"
            finally:
                client.close()
                server.close()

        run(go(), timeout=30)


class TestLateDataAfterClose:
    def test_inflight_data_after_local_close_is_acked_not_crash(self):
        """Regression: data still in flight when we close() used to hit
        asyncio's 'feed_data after feed_eof' assertion and kill the
        datagram handler. It must be acked (so the peer's retransmit
        timers settle) and dropped."""
        sent = []

        class _Record:
            def sendto(self, data, addr):
                sent.append(utp.decode_packet(data))

            def _forget(self, conn):
                pass

        async def go():
            conn = utp.UtpConnection(_Record(), ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 100
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 101, 0, b"a")
            conn.close()  # reader EOF'd; FIN out; conn still alive
            # late in-flight data arrives — must not raise
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 102, 0, b"b")
            assert conn.ack_nr == 102  # acked (dropped, not delivered)
            acks = [p for p in sent if p and p[0] == utp.ST_STATE]
            assert acks and acks[-1][6] == 102
            # and the peer's FIN completes the close without a crash
            conn.on_packet(utp.ST_FIN, 0, 0, 1 << 20, 103, 0, b"")
            assert conn.closed and not conn._reset

        run(go())


class TestDelayedAcks:
    class _Record:
        def __init__(self):
            self.sent = []

        def sendto(self, data, addr):
            self.sent.append(utp.decode_packet(data))

        def _forget(self, conn):
            pass

        def states(self):
            return [p for p in self.sent if p and p[0] == utp.ST_STATE]

    def test_two_in_order_packets_one_ack(self):
        async def go():
            ep = self._Record()
            conn = utp.UtpConnection(ep, ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 100
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 101, 0, b"a")
            assert len(ep.states()) == 0  # first packet: ack delayed
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 102, 0, b"b")
            assert len(ep.states()) == 1  # 2nd packet flushes ONE ack
            assert ep.states()[-1][6] == 102

        run(go())

    def test_lone_packet_acks_via_timer(self):
        async def go():
            ep = self._Record()
            conn = utp.UtpConnection(ep, ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 100
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 101, 0, b"a")
            assert len(ep.states()) == 0
            await asyncio.sleep(0.12)  # > 50 ms delack timer
            assert len(ep.states()) == 1 and ep.states()[-1][6] == 101

        run(go())

    def test_hole_acks_immediately(self):
        """Out-of-order arrivals must ack NOW — the sender's dup-ack
        fast-resend and SACK feedback depend on prompt dup STATEs."""

        async def go():
            ep = self._Record()
            conn = utp.UtpConnection(ep, ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 100
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 103, 0, b"c")  # hole
            assert len(ep.states()) == 1  # immediate dup-ack w/ SACK
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 104, 0, b"d")
            assert len(ep.states()) == 2

        run(go())

    def test_sacked_data_before_close_completes_fin_handshake(self):
        """Regression for the _rx_closed stall: 102/103 buffered (and
        SACKed — the peer will NOT retransmit them), local close, then
        the hole fills and the FIN arrives. Sequencing must advance
        THROUGH the discarded ooo data so the FIN handshake completes."""

        async def go():
            ep = self._Record()
            conn = utp.UtpConnection(ep, ("1.2.3.4", 1), 10, 11)
            conn.connected.set()
            conn.ack_nr = 100
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 102, 0, b"b")
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 103, 0, b"c")
            conn.close()  # reader EOF'd; 102/103 still in _ooo
            conn.on_packet(utp.ST_DATA, 0, 0, 1 << 20, 101, 0, b"a")
            assert conn.ack_nr == 103  # drained through in discard mode
            conn.on_packet(utp.ST_FIN, 0, 0, 1 << 20, 104, 0, b"")
            assert conn.closed and not conn._reset  # graceful completion

        run(go())


class TestRaiseProbeGating:
    """Advisor r4: PAD_EXT is a non-standard extension id — raise
    probing needs a global kill-switch and must only arm against peers
    that demonstrated extension tolerance."""

    class _Ep:
        def sendto(self, data, addr):
            pass

        def _forget(self, conn):
            pass

    def test_kill_switch_and_extension_tolerance(self, monkeypatch):
        async def go():
            # loopback peer: our own stack, tolerant by construction
            lo = utp.UtpConnection(self._Ep(), ("127.0.0.1", 1), 1, 2)
            lo.mtu = 576
            lo._arm_mtu_raise()
            assert lo._mtu_raise_at > 0

            # global kill-switch wins even on loopback
            monkeypatch.setattr(utp, "MTU_RAISE_ENABLED", False)
            off = utp.UtpConnection(self._Ep(), ("127.0.0.1", 1), 1, 2)
            off.mtu = 576
            off._arm_mtu_raise()
            assert off._mtu_raise_at == 0
            monkeypatch.setattr(utp, "MTU_RAISE_ENABLED", True)

            # WAN peer: never probed until tolerance is demonstrated...
            wan = utp.UtpConnection(self._Ep(), ("203.0.113.5", 1), 1, 2)
            wan.mtu = 576
            assert not wan._ext_tolerant
            wan._arm_mtu_raise()
            assert wan._mtu_raise_at == 0
            # ...and a peer that itself sends a BEP 29 extension (SACK)
            # proves its decoder walks the extension framing — arm now
            wan.connected.set()
            wan.ack_nr = 100
            wan.on_packet(
                utp.ST_STATE, 0, 0, 1 << 20, 101, wan.seq_nr, b"",
                sack=b"\x00\x00\x00\x00",
            )
            assert wan._ext_tolerant and wan._mtu_raise_at > 0

        run(go())


class TestTransportTeardown:
    def test_closed_transport_silences_timers(self):
        """A retransmit timer that outlives the UDP socket must not
        raise from inside the event loop: closing the *transport*
        directly (not endpoint.close()) kills the connections via
        connection_lost, and a straggler sendto is a no-op."""

        async def go():
            got = asyncio.Event()

            async def consume(r, w):
                await r.read(1 << 16)
                got.set()

            server = await utp.create_utp_endpoint(
                "127.0.0.1", 0, on_accept=consume
            )
            try:
                reader, writer = await utp.open_utp_connection(
                    "127.0.0.1", server.port, timeout=5
                )
                writer.write(b"x" * 4096)
                await writer.drain()
                await asyncio.wait_for(got.wait(), 5)
                conn = writer._conn
                ep = conn.endpoint
                # close the raw transport out from under the endpoint
                ep.transport.close()
                await asyncio.sleep(0)  # let connection_lost run
                assert ep.transport is None
                assert conn.closed
                # a late timer firing through the dead endpoint: no-op,
                # no AttributeError from asyncio's fatal-error path
                ep.sendto(b"stray", ("127.0.0.1", server.port))
            finally:
                server.close()

        run(go())
