"""BEP 40 canonical peer priority tests."""


from torrent_tpu_torch.net.priority import crc32c, peer_priority
from torrent_tpu_torch.net.types import AnnouncePeer
from tests.test_torch_session import run
from tests.test_torch_session_selection import make_multifile_torrent


class TestCrc32c:
    def test_known_vectors(self):
        # RFC 3720 appendix B test pattern
        assert crc32c(b"123456789") == 0xE3069283
        assert crc32c(b"") == 0
        assert crc32c(b"\x00" * 32) == 0x8A9136AA


class TestPeerPriority:
    def test_bep40_published_example(self):
        # the worked example in BEP 40's text
        assert peer_priority(("123.213.32.10", 0), ("98.76.54.32", 0)) == 0xEC2D7224

    def test_symmetric(self):
        a, b = ("1.2.3.4", 6881), ("5.6.7.8", 51413)
        assert peer_priority(a, b) == peer_priority(b, a)

    def test_same_ip_uses_ports(self):
        a = ("9.9.9.9", 1000)
        assert peer_priority(a, ("9.9.9.9", 2000)) == crc32c(
            (1000).to_bytes(2, "big") + (2000).to_bytes(2, "big")
        )
        # port order must not matter
        assert peer_priority(("9.9.9.9", 2000), a) == peer_priority(a, ("9.9.9.9", 2000))

    def test_same_slash24_uses_full_ips(self):
        p = peer_priority(("10.0.0.1", 1), ("10.0.0.2", 2))
        want = crc32c(bytes([10, 0, 0, 1, 10, 0, 0, 2]))
        assert p == want

    def test_mixed_family_and_garbage(self):
        assert peer_priority(("1.2.3.4", 1), ("::1", 1)) == 0
        assert peer_priority(("nope", 1), ("1.2.3.4", 1)) == 0

    def test_ipv6_full_addresses(self):
        a, b = ("2001:db8::1", 10), ("2001:db8::2", 20)
        # distinct hosts in one /64 hash their FULL addresses — the
        # ports path is reserved for identical IPs, so same-port peers
        # in a /64 must NOT collide
        assert peer_priority(a, b) == peer_priority(b, a) != 0
        assert peer_priority(("2001:db8::1", 5), ("2001:db8::2", 5)) != peer_priority(
            ("2001:db8::3", 5), ("2001:db8::4", 5)
        )
        same_host = peer_priority(("2001:db8::1", 10), ("2001:db8::1", 20))
        assert same_host == crc32c((10).to_bytes(2, "big") + (20).to_bytes(2, "big"))


class TestDialOrdering:
    def test_candidates_sorted_by_priority(self):
        async def go():
            t, _ = make_multifile_torrent([32768 * 2])
            t.external_ip = "123.213.32.10"
            t.config.max_peers = 1  # only the top candidate gets dialed
            dialed = []
            t._spawn = lambda coro, name=None: (dialed.append(coro), coro.close())
            cands = [
                AnnouncePeer(ip="98.76.54.32", port=1),
                AnnouncePeer(ip="123.213.32.234", port=1),
            ]
            me = (t.external_ip, t.port)
            winner = max(
                cands, key=lambda c: peer_priority(me, (c.ip, c.port))
            )
            t._connect_new_peers(cands)
            assert len(t._dialing) == 1
            assert (winner.ip, winner.port) in t._dialing
            # and the ranking is canonical, not list-order dependent
            t._dialing.clear()
            t._connect_new_peers(list(reversed(cands)))
            assert (winner.ip, winner.port) in t._dialing

        run(go())


class TestBep24ExternalIp:
    def test_announce_parses_external_ip_forms(self):
        from torrent_tpu_torch.net.tracker import _parse_http_announce
        from torrent_tpu_torch.codec.bencode import bencode

        base = {b"interval": 60, b"peers": b""}
        packed = _parse_http_announce(
            bencode({**base, b"external ip": bytes([1, 2, 3, 4])})
        )
        assert packed.external_ip == "1.2.3.4"
        text = _parse_http_announce(
            bencode({**base, b"external ip": b"203.0.113.7"})
        )
        assert text.external_ip == "203.0.113.7"
        v6 = _parse_http_announce(
            bencode({**base, b"external ip": bytes(range(16))})
        )
        assert v6.external_ip is not None and ":" in v6.external_ip
        junk = _parse_http_announce(bencode({**base, b"external ip": b"xx"}))
        assert junk.external_ip is None
        # 4-char TEXT address must parse as text, not as packed bytes
        short_v6 = _parse_http_announce(bencode({**base, b"external ip": b"1::1"}))
        assert short_v6.external_ip == "1::1"
