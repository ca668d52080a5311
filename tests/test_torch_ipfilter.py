"""CIDR peer blocklist tests."""

import pytest

from torrent_tpu_torch.net.ipfilter import IpFilter
from torrent_tpu_torch.net.types import AnnouncePeer
from tests.test_torch_session_selection import make_multifile_torrent
from tests.test_torch_session import run


class TestIpFilter:
    def test_cidr_and_single_addresses(self):
        f = IpFilter(["10.0.0.0/8", "203.0.113.7", "2001:db8::/32"])
        assert len(f) == 3
        assert f.blocked("10.200.3.4")
        assert f.blocked("203.0.113.7")
        assert not f.blocked("203.0.113.8")
        assert f.blocked("2001:db8:ffff::1")
        assert not f.blocked("2001:db9::1")

    def test_empty_filter_blocks_nothing(self):
        f = IpFilter()
        assert not f.blocked("anything")  # fast path, no parse

    def test_unparseable_ip_fails_closed(self):
        f = IpFilter(["10.0.0.0/8"])
        assert f.blocked("not-an-ip")

    def test_bad_entry_raises_at_construction(self):
        with pytest.raises(ValueError):
            IpFilter(["10.0.0.0/8", "nope/99"])


class TestSessionGates:
    def test_dial_and_accept_gated(self):
        async def go():
            t, _ = make_multifile_torrent([32768])
            t.ip_filter = IpFilter(["198.51.100.0/24"])
            spawned = []
            t._spawn = lambda coro, name=None: (spawned.append(coro), coro.close())
            t._connect_new_peers(
                [
                    AnnouncePeer(ip="198.51.100.9", port=1),
                    AnnouncePeer(ip="198.51.101.9", port=1),
                ]
            )
            assert ("198.51.100.9", 1) not in t._dialing
            assert ("198.51.101.9", 1) in t._dialing

            class _W:
                closed = False

                def write(self, b):
                    pass

                def close(self):
                    self.closed = True

            w = _W()
            await t.add_peer(b"Z" * 20, object(), w, address=("198.51.100.9", 5))
            assert w.closed and b"Z" * 20 not in t.peers

        run(go())


class TestReviewRegressions:
    def test_ipv4_mapped_ipv6_matches_v4_ranges(self):
        f = IpFilter(["10.0.0.0/8"])
        assert f.blocked("::ffff:10.1.2.3")  # dual-stack peername form
        assert not f.blocked("::ffff:11.1.2.3")

    def test_metadata_fetch_skips_blocked_candidates(self):
        import asyncio

        import pytest

        from torrent_tpu_torch.codec.magnet import Magnet
        from torrent_tpu_torch.session.metadata import MetadataError, fetch_metadata

        async def go():
            m = Magnet(
                info_hash=b"\x01" * 20,
                peer_addrs=(("10.5.5.5", 6881),),  # only candidate: blocked
            )
            with pytest.raises(MetadataError, match="no reachable peer sources"):
                await fetch_metadata(
                    m, peer_id=b"P" * 20, ip_filter=IpFilter(["10.0.0.0/8"])
                )

        asyncio.run(asyncio.wait_for(go(), 30))
