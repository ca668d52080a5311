"""Peer wire protocol tests — loopback over real asyncio streams.

The reference left protocol.ts untested (SURVEY §4 gap); these are the
loopback tests it should have had.
"""

import asyncio

import pytest

from torrent_tpu_torch.net.protocol import (
    BitfieldMsg,
    Cancel,
    Choke,
    Have,
    Interested,
    KeepAlive,
    MAX_MESSAGE_LEN,
    NotInterested,
    Piece,
    ProtocolError,
    Request,
    Unchoke,
    decode_message,
    encode_message,
    handshake_bytes,
    read_handshake_head,
    read_handshake_peer_id,
    read_message,
    send_handshake,
    send_message,
)
from torrent_tpu_torch.utils.bitfield import Bitfield

INFO_HASH = bytes(range(20))
PEER_A = b"-TT0001-aaaaaaaaaaaa"
PEER_B = b"-TT0001-bbbbbbbbbbbb"


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 15))


async def loopback():
    """Real socket pair on localhost."""
    conns = {}
    ready = asyncio.Event()

    async def on_conn(reader, writer):
        conns["server"] = (reader, writer)
        ready.set()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    creader, cwriter = await asyncio.open_connection("127.0.0.1", port)
    await ready.wait()
    sreader, swriter = conns["server"]
    return server, (creader, cwriter), (sreader, swriter)


class TestHandshake:
    def test_bytes_layout(self):
        hs = handshake_bytes(INFO_HASH, PEER_A)
        assert len(hs) == 68
        assert hs[0] == 19 and hs[1:20] == b"BitTorrent protocol"
        assert hs[28:48] == INFO_HASH and hs[48:68] == PEER_A

    def test_two_phase_roundtrip(self):
        async def go():
            server, (cr, cw), (sr, sw) = await loopback()
            await send_handshake(cw, INFO_HASH, PEER_A)
            # accept side routes on the hash before replying
            ih, reserved = await read_handshake_head(sr)
            assert ih == INFO_HASH and reserved == b"\x00" * 8
            await send_handshake(sw, INFO_HASH, PEER_B)
            pid = await read_handshake_peer_id(sr)
            assert pid == PEER_A
            (ih2, _), pid2 = await read_handshake_head(cr), await read_handshake_peer_id(cr)
            assert ih2 == INFO_HASH and pid2 == PEER_B
            cw.close(); sw.close(); server.close()

        run(go())

    def test_bad_protocol_string(self):
        async def go():
            server, (cr, cw), (sr, sw) = await loopback()
            cw.write(bytes([5]) + b"HTTP/" + b"\x00" * 62)
            await cw.drain()
            with pytest.raises(ProtocolError, match="unknown protocol"):
                await read_handshake_head(sr)
            cw.close(); sw.close(); server.close()

        run(go())

    def test_truncated_handshake(self):
        async def go():
            server, (cr, cw), (sr, sw) = await loopback()
            cw.write(handshake_bytes(INFO_HASH, PEER_A)[:30])
            cw.close()
            with pytest.raises(ProtocolError, match="truncated"):
                await read_handshake_head(sr)
            sw.close(); server.close()

        run(go())

    def test_invalid_lengths(self):
        with pytest.raises(ProtocolError):
            handshake_bytes(b"short", PEER_A)


ALL_MSGS = [
    KeepAlive(),
    Choke(),
    Unchoke(),
    Interested(),
    NotInterested(),
    Have(index=123456),
    BitfieldMsg(raw=b"\xf0\x80"),
    Request(index=7, begin=16384, length=16384),
    Piece(index=7, begin=16384, block=b"\xab" * 100),
    Cancel(index=7, begin=16384, length=16384),
]


class TestMessages:
    def test_roundtrip_all_nine(self):
        async def go():
            server, (cr, cw), (sr, sw) = await loopback()
            for msg in ALL_MSGS:
                await send_message(cw, msg)
            got = [await read_message(sr) for _ in ALL_MSGS]
            assert got == ALL_MSGS
            cw.close(); sw.close(); server.close()

        run(go())

    def test_eof_returns_none(self):
        async def go():
            server, (cr, cw), (sr, sw) = await loopback()
            cw.close()
            assert await read_message(sr) is None
            sw.close(); server.close()

        run(go())

    def test_unknown_id_skipped_iteratively(self):
        async def go():
            server, (cr, cw), (sr, sw) = await loopback()
            # hundreds of unknown-id frames then a real one — the
            # reference's recursive reader would blow the stack pattern
            for _ in range(500):
                cw.write(b"\x00\x00\x00\x02\x63\x00")  # id 99, 1-byte payload
            await send_message(cw, Have(index=5))
            assert await read_message(sr) == Have(index=5)
            cw.close(); sw.close(); server.close()

        run(go())

    def test_oversized_frame_rejected(self):
        async def go():
            server, (cr, cw), (sr, sw) = await loopback()
            cw.write((MAX_MESSAGE_LEN + 100).to_bytes(4, "big"))
            await cw.drain()
            with pytest.raises(ProtocolError, match="exceeds cap"):
                await read_message(sr)
            cw.close(); sw.close(); server.close()

        run(go())

    def test_malformed_known_id(self):
        with pytest.raises(ProtocolError, match="malformed"):
            decode_message(4, b"\x00")  # have with 1-byte payload

    def test_keepalive_is_bare_length(self):
        assert encode_message(KeepAlive()) == b"\x00\x00\x00\x00"


class TestBitfield:
    def test_set_get_count(self):
        bf = Bitfield(10)
        bf.set(0); bf.set(9)
        assert bf.has(0) and bf.has(9) and not bf.has(5)
        assert bf.count() == 2 and not bf.complete
        assert bf.to_bytes() == b"\x80\x40"

    def test_wire_roundtrip(self):
        bf = Bitfield(12, b"\xa5\xf0")
        assert [i for i in range(12) if bf.has(i)] == [0, 2, 5, 7, 8, 9, 10, 11]

    def test_spare_bits_rejected(self):
        with pytest.raises(ValueError, match="spare bits"):
            Bitfield(9, b"\x80\x7f")

    def test_wrong_size_rejected(self):
        with pytest.raises(ValueError):
            Bitfield(9, b"\x80")

    def test_from_numpy(self):
        import numpy as np

        bf = Bitfield(5)
        bf.from_numpy(np.array([True, False, True, False, True]))
        assert bf.to_bytes() == b"\xa8"
        assert bf.count() == 3

    def test_bounds(self):
        bf = Bitfield(8)
        with pytest.raises(IndexError):
            bf.has(8)
        with pytest.raises(IndexError):
            bf.set(-1)
