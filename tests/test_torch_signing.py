"""BEP 35 torrent signing: Ed25519 over the raw info-dict span.

No reference counterpart (rclarey/torrent implements no BEP 35); the
scheme choice (raw Ed25519 keys in ``certificate``, the BEP 46 key
format) is documented in codec/signing.py.
"""

import numpy as np
import pytest

from torrent_tpu_torch.codec import signing
from torrent_tpu_torch.codec.bencode import bdecode, bencode
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.tools.make_torrent import make_torrent
from torrent_tpu_torch.utils import ed25519

ANNOUNCE = "http://127.0.0.1:1/announce"
SEED_A = bytes(range(32))
SEED_B = bytes(range(32, 64))


@pytest.fixture
def torrent_bytes(tmp_path):
    payload = np.random.default_rng(21).integers(
        0, 256, 50_000, dtype=np.uint8
    ).tobytes()
    (tmp_path / "p.bin").write_bytes(payload)
    return make_torrent(str(tmp_path / "p.bin"), ANNOUNCE, piece_length=16384, hasher="cpu")


class TestSignVerify:
    def test_roundtrip_and_infohash_preserved(self, torrent_bytes):
        signed = signing.sign_torrent(torrent_bytes, SEED_A, "alice")
        assert signing.list_signers(signed) == ["alice"]
        assert signing.verify_torrent(signed, "alice")  # embedded cert
        assert signing.verify_torrent(
            signed, "alice", ed25519.publickey(SEED_A)
        )
        # root-level signing: same info bytes, same swarm
        assert (
            parse_metainfo(signed).info_hash
            == parse_metainfo(torrent_bytes).info_hash
        )
        # canonical output: strict re-encode is byte-identical
        assert signed == bencode(bdecode(signed))

    def test_tampered_info_fails(self, torrent_bytes):
        signed = signing.sign_torrent(torrent_bytes, SEED_A, "alice")
        top = bdecode(signed)
        top[b"info"][b"name"] = b"evil.bin"
        tampered = bencode(top)
        assert not signing.verify_torrent(tampered, "alice")

    def test_wrong_key_and_unknown_signer(self, torrent_bytes):
        signed = signing.sign_torrent(torrent_bytes, SEED_A, "alice")
        assert not signing.verify_torrent(
            signed, "alice", ed25519.publickey(SEED_B)
        )
        assert not signing.verify_torrent(signed, "bob")

    def test_cert_substitution_attack_fails_against_trusted_key(
        self, torrent_bytes
    ):
        """An attacker re-signing with their own key (valid embedded
        cert!) must not pass a verifier holding the real public key."""
        signed = signing.sign_torrent(torrent_bytes, SEED_A, "alice")
        top = bdecode(signed)
        top[b"info"][b"name"] = b"evil.bin"
        resigned = signing.sign_torrent(bencode(top), SEED_B, "alice")
        assert signing.verify_torrent(resigned, "alice")  # embedded: "valid"
        assert not signing.verify_torrent(
            resigned, "alice", ed25519.publickey(SEED_A)
        )  # trusted key: caught

    def test_multiple_signers_coexist(self, torrent_bytes):
        signed = signing.sign_torrent(torrent_bytes, SEED_A, "alice")
        signed = signing.sign_torrent(signed, SEED_B, "bob")
        assert sorted(signing.list_signers(signed)) == ["alice", "bob"]
        assert signing.verify_torrent(signed, "alice", ed25519.publickey(SEED_A))
        assert signing.verify_torrent(signed, "bob", ed25519.publickey(SEED_B))

    def test_extension_info_is_covered(self, torrent_bytes):
        signed = signing.sign_torrent(
            torrent_bytes, SEED_A, "alice", info_ext={b"expires": 123}
        )
        assert signing.verify_torrent(signed, "alice")
        top = bdecode(signed)
        top[b"signatures"][b"alice"][b"info"][b"expires"] = 999
        assert not signing.verify_torrent(bencode(top), "alice")

    def test_non_ed25519_certificate_refused(self, torrent_bytes):
        signed = signing.sign_torrent(torrent_bytes, SEED_A, "alice")
        top = bdecode(signed)
        top[b"signatures"][b"alice"][b"certificate"] = b"\x30\x82" + b"x" * 500
        assert not signing.verify_torrent(bencode(top), "alice")

    def test_non_canonical_input_keeps_info_bytes(self, torrent_bytes):
        """Wild torrents with unsorted info keys must keep their exact
        info span (and thus infohash) through signing — splice, never
        re-encode."""
        top = bdecode(torrent_bytes)
        info = top[b"info"]
        scrambled = dict(reversed(list(info.items())))  # unsorted on wire
        wild = bencode({**top, b"info": scrambled}, sort_keys=False)
        from torrent_tpu_torch.codec.bencode import bdecode_with_info_span

        _, span0 = bdecode_with_info_span(wild)
        raw0 = wild[span0[0] : span0[1]]
        signed = signing.sign_torrent(wild, SEED_A, "alice")
        _, span1 = bdecode_with_info_span(signed)
        assert signed[span1[0] : span1[1]] == raw0  # byte-identical
        assert signing.verify_torrent(signed, "alice")

    def test_foreign_non_canonical_ext_verifies_and_survives_resigning(
        self, torrent_bytes
    ):
        """A foreign signer's entry whose ext dict is NOT canonically
        sorted must verify over its wire bytes as written, and must
        survive our re-signing byte-for-byte."""
        from torrent_tpu_torch.codec.bencode import bdecode_with_info_span

        _, span = bdecode_with_info_span(torrent_bytes)
        raw_info = torrent_bytes[span[0] : span[1]]
        # hand-build the entry with unsorted ext keys (z before a)
        ext_wire = b"d1:zi1e1:ai2ee"
        sig = ed25519.sign(SEED_B, raw_info + ext_wire)
        entry_wire = (
            b"d11:certificate32:" + ed25519.publickey(SEED_B)
            + b"4:info" + ext_wire
            + b"9:signature64:" + sig + b"e"
        )
        top = bdecode(torrent_bytes)
        body = bencode(top)  # canonical, no signatures yet
        # splice a signatures dict manually at the end of the top dict
        assert body[-1:] == b"e"
        foreign = (
            body[:-1]
            + b"10:signaturesd7:foreign" + entry_wire + b"e"
            + b"e"
        )
        assert signing.verify_torrent(foreign, "foreign")
        resigned = signing.sign_torrent(foreign, SEED_A, "alice")
        assert sorted(signing.list_signers(resigned)) == ["alice", "foreign"]
        assert signing.verify_torrent(resigned, "alice")
        assert signing.verify_torrent(
            resigned, "foreign", ed25519.publickey(SEED_B)
        )
        assert entry_wire in resigned  # foreign entry preserved verbatim

    def test_hybrid_torrent_signs_and_keeps_both_identities(self, tmp_path):
        """Signing a BEP 52 hybrid (v1+v2 in one info dict) preserves
        both parsed identities byte-for-byte and verifies."""
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2

        rng = np.random.default_rng(27)
        src = tmp_path / "h"
        src.mkdir()
        (src / "a.bin").write_bytes(
            rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
        )
        from torrent_tpu_torch.models.v2 import build_hybrid

        data, _ = build_hybrid(
            [(("a.bin",), (src / "a.bin").read_bytes())],
            name="h",
            piece_length=16384,
            hasher="cpu",
            announce=ANNOUNCE,
        )
        m1, m2 = parse_metainfo(data), parse_metainfo_v2(data)
        assert m1 is not None and m2 is not None
        signed = signing.sign_torrent(data, SEED_A, "publisher")
        assert signing.verify_torrent(signed, "publisher")
        s1, s2 = parse_metainfo(signed), parse_metainfo_v2(signed)
        assert s1.info_hash == m1.info_hash
        assert s2.info_hash_v2 == m2.info_hash_v2

    def test_garbage_inputs(self):
        assert signing.list_signers(b"not bencode") == []
        assert not signing.verify_torrent(b"not bencode", "x")
        with pytest.raises(ValueError):
            signing.sign_torrent(b"de", SEED_A, "x")
        with pytest.raises(ValueError):
            signing.sign_torrent(b"de", b"short", "x")


class TestSessionGate:
    def test_add_torrent_bytes_gate_and_autodetect(self, tmp_path):
        """Client.add_torrent_bytes: the library-level BEP 35 gate plus
        v1 auto-detection — refused bytes register nothing."""
        import asyncio

        from torrent_tpu_torch.session.client import Client, ClientConfig

        async def go():
            payload = np.random.default_rng(23).integers(
                0, 256, 40_000, dtype=np.uint8
            ).tobytes()
            (tmp_path / "s.bin").write_bytes(payload)
            data = make_torrent(
                str(tmp_path / "s.bin"), ANNOUNCE, piece_length=16384, hasher="cpu"
            )
            c = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            await c.start()
            try:
                gate = ("publisher", ed25519.publickey(SEED_A))
                with pytest.raises(ValueError, match="BEP 35"):
                    await c.add_torrent_bytes(data, str(tmp_path), gate)
                assert not c.torrents  # nothing registered on refusal
                signed = signing.sign_torrent(data, SEED_A, "publisher")
                t = await c.add_torrent_bytes(signed, str(tmp_path), gate)
                assert t.metainfo.info_hash in c.torrents
                assert t.bitfield.complete  # payload on disk: full recheck
            finally:
                await c.close()

        asyncio.run(asyncio.wait_for(go(), 60))


class TestSecurePublishingPipeline:
    def test_feed_to_gated_update_end_to_end(self, tmp_path):
        """The whole signed-publishing story composes: a publisher's
        signed torrent enters via a GATED feed, its signed BEP 39
        successor passes the update gate and switches in place; an
        attacker's re-signed successor at the same update-url is
        refused. One trusted key end to end."""
        import asyncio

        from tests.test_torch_feed import _serve_routes
        from torrent_tpu_torch.codec.bencode import bdecode, bencode
        from torrent_tpu_torch.session.client import Client, ClientConfig
        from torrent_tpu_torch.tools.feed import FeedPoller
        from torrent_tpu_torch.tools.make_torrent import make_torrent

        async def go():
            pub_key = ed25519.publickey(SEED_A)
            gate = ("publisher", pub_key)
            rng = np.random.default_rng(61)
            keep = rng.integers(0, 256, 32 * 1024, dtype=np.uint8).tobytes()
            old = rng.integers(0, 256, 16 * 1024, dtype=np.uint8).tobytes()
            new = rng.integers(0, 256, 16 * 1024, dtype=np.uint8).tobytes()

            # publisher's v1 dataset (seeded locally so the feed's add
            # completes its recheck from disk)
            src = tmp_path / "dl" / "ds"
            src.mkdir(parents=True)
            (src / "keep.bin").write_bytes(keep)
            (src / "change.bin").write_bytes(old)
            base_holder = [""]
            v1_plain = make_torrent(
                str(src), ANNOUNCE, piece_length=16384, hasher="gpu", device="cpu"
            )

            # v2 successor: one file changed, same names
            src2 = tmp_path / "v2src" / "ds"
            src2.mkdir(parents=True)
            (src2 / "keep.bin").write_bytes(keep)
            (src2 / "change.bin").write_bytes(new)
            v2_plain = make_torrent(
                str(src2), ANNOUNCE, piece_length=16384, hasher="gpu", device="cpu"
            )
            v2_signed = signing.sign_torrent(v2_plain, SEED_A, "publisher")
            # attacker: different payload, validly self-signed wrong key
            evil = signing.sign_torrent(v2_plain, SEED_B, "publisher")

            serving = {"successor": evil}
            base, shutdown = _serve_routes(
                {
                    "/feed.xml": lambda: (
                        '<rss version="2.0"><channel><item><title>ds</title>'
                        f'<enclosure url="{base_holder[0]}/ds.torrent"/>'
                        "</item></channel></rss>"
                    ).encode(),
                    "/ds.torrent": lambda: v1_final[0],
                    "/next.torrent": lambda: serving["successor"],
                }
            )
            base_holder[0] = base
            # v1 carries the update-url, then is signed (root keys only)
            top = bdecode(v1_plain)
            top[b"update-url"] = f"{base}/next.torrent".encode()
            v1_final = [
                signing.sign_torrent(bencode(top), SEED_A, "publisher")
            ]

            c = Client(ClientConfig(host="127.0.0.1", enable_upnp=False, hasher="cpu"))
            await c.start()
            try:
                poller = FeedPoller(
                    c, f"{base}/feed.xml", str(tmp_path / "dl"),
                    require_signed=gate,
                )
                added = await poller.poll_once()
                assert len(added) == 1
                t1 = added[0]
                assert t1.bitfield.complete  # payload was on disk

                # attacker's successor: gate refuses at the raw bytes
                from torrent_tpu_torch.session.client import fetch_update

                raw_out: list = []
                succ = await fetch_update(
                    t1.metainfo, raw_bytes_out=raw_out
                )
                assert succ is not None
                with pytest.raises(ValueError, match="BEP 35"):
                    signing.ensure_signed(raw_out[0], *gate)

                # publisher's real successor: passes, switches in place
                serving["successor"] = v2_signed
                raw_out.clear()
                succ = await fetch_update(t1.metainfo, raw_bytes_out=raw_out)
                assert succ is not None
                signing.ensure_signed(raw_out[0], *gate)  # no raise
                t2 = await c.apply_update(t1, succ)
                assert t2.metainfo.info_hash in c.torrents
                # unchanged file adopted from the predecessor in place
                assert any(
                    t2.bitfield.has(i) for i in range(t2.info.num_pieces)
                )
            finally:
                await c.close()
                shutdown()

        asyncio.run(asyncio.wait_for(go(), 90))
