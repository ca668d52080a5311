"""BEP 44 DHT storage (net/dht.py get/put) + the ed25519 it rides on.

ed25519 is checked against the RFC 8032 published vectors and the BEP 44
derivations (signature blob format, sha1 targets); the item store is
driven over real loopback DHT networks — immutable and mutable round
trips, seq/cas semantics, signature enforcement, expiry.
"""

import asyncio
import hashlib

import pytest

from torrent_tpu_torch.codec.bencode import bencode
from torrent_tpu_torch.net.dht import (
    DHTError,
    DHTNode,
    DHTRemoteError,
    ITEM_TTL_SECS,
    item_signature_blob,
)
from torrent_tpu_torch.utils import ed25519 as ed


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# BEP 44's published test key (libsodium expanded form: scalar || prefix)
SK = bytes.fromhex(
    "e06d3183d14159228433ed599221b80bd0a5ce8352e4bdf0262f76786ef1c74d"
    "b7e7a9fea2c0eb269d61e3b38e450a22e754941ac78479d6c54e1faf6037881d"
)
PK = bytes.fromhex("77ff84905a91936367c01360803104f92432fcd904a43511876df5cdf3e7e548")


class TestEd25519:
    def test_rfc8032_vector_1_empty_message(self):
        seed = bytes.fromhex(
            "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"
        )
        pub = bytes.fromhex(
            "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
        )
        sig = bytes.fromhex(
            "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
            "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
        )
        assert ed.publickey(seed) == pub
        assert ed.sign(seed, b"") == sig
        assert ed.verify(pub, b"", sig)
        assert not ed.verify(pub, b"x", sig)
        assert not ed.verify(pub, b"", sig[:-1] + bytes([sig[-1] ^ 1]))

    def test_rfc8032_vector_2_one_byte(self):
        seed = bytes.fromhex(
            "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb"
        )
        pub = bytes.fromhex(
            "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c"
        )
        sig = bytes.fromhex(
            "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
            "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"
        )
        assert ed.publickey(seed) == pub
        assert ed.sign(seed, b"r") == sig
        assert ed.verify(pub, b"r", sig)

    def test_bep44_published_key_and_targets(self):
        """The BEP's mutable vectors: the expanded secret maps to the
        published public key; targets derive per spec; our signatures
        verify under the published key (the signed blobs below are the
        BEP's own examples)."""
        assert ed.publickey_expanded(SK) == PK
        assert (
            hashlib.sha1(b"12:Hello World!").hexdigest()
            == "e5f96f6f38320f0f33959cb4d3d656452117aadb"  # immutable target
        )
        assert (
            hashlib.sha1(PK).hexdigest()
            == "4a533d47ec9c7d95b1ad75f576cffc641853b750"  # mutable target
        )
        blob = item_signature_blob(b"", 1, bencode("Hello World!"))
        assert blob == b"3:seqi1e1:v12:Hello World!"
        assert ed.verify(PK, blob, ed.sign_expanded(SK, blob))
        blob_salt = item_signature_blob(b"foobar", 1, bencode("Hello World!"))
        assert blob_salt == b"4:salt6:foobar3:seqi1e1:v12:Hello World!"
        assert ed.verify(PK, blob_salt, ed.sign_expanded(SK, blob_salt))

    def test_seed_and_expanded_forms_agree(self):
        seed = hashlib.sha256(b"determinism").digest()
        pub = ed.publickey(seed)
        sig = ed.sign(seed, b"message")
        assert ed.verify(pub, b"message", sig)
        with pytest.raises(ValueError):
            ed.sign(b"short", b"m")
        with pytest.raises(ValueError):
            ed.sign_expanded(b"short", b"m")

    def test_garbage_inputs_dont_verify(self):
        assert not ed.verify(b"\x00" * 32, b"m", b"\x00" * 64)
        assert not ed.verify(b"", b"m", b"\x00" * 64)
        assert not ed.verify(PK, b"m", b"")


async def _network(n):
    nodes = [await DHTNode(host="127.0.0.1").start() for _ in range(n)]
    seed = ("127.0.0.1", nodes[0].port)
    for node in nodes[1:]:
        await node.bootstrap([seed])
    for node in nodes:
        await node.lookup_nodes(node.node_id)
    return nodes


def _close(nodes):
    for n in nodes:
        n.close()


class TestImmutableItems:
    def test_put_get_roundtrip(self):
        async def go():
            nodes = await _network(8)
            try:
                target, stored = await nodes[1].put_immutable("Hello World!")
                assert stored > 0
                assert target == bytes.fromhex(
                    "e5f96f6f38320f0f33959cb4d3d656452117aadb"
                )
                item = await nodes[6].get_item(target)
                assert item is not None and item.value == b"Hello World!"
                assert item.k is None  # immutable
            finally:
                _close(nodes)

        run(go())

    def test_compound_values_roundtrip(self):
        async def go():
            nodes = await _network(6)
            try:
                value = {b"files": [b"a", b"b"], b"n": 7}
                target, stored = await nodes[2].put_immutable(value)
                assert stored > 0
                item = await nodes[5].get_item(target)
                assert item is not None
                assert item.value == {b"files": [b"a", b"b"], b"n": 7}
            finally:
                _close(nodes)

        run(go())

    def test_forged_value_is_rejected_by_getter(self):
        """A node holding a value that doesn't hash to the target must
        not poison the caller."""

        async def go():
            nodes = await _network(4)
            try:
                target, _ = await nodes[1].put_immutable(b"real")
                # poison every store: replace the item under the target
                for n in nodes:
                    if target in n.item_store:
                        n.item_store[target]["v"] = b"forged"
                assert await nodes[3].get_item(target) is None
            finally:
                _close(nodes)

        run(go())

    def test_oversized_value_rejected(self):
        async def go():
            nodes = await _network(2)
            try:
                with pytest.raises(ValueError):
                    await nodes[0].put_immutable(b"x" * 1001)
            finally:
                _close(nodes)

        run(go())


class TestMutableItems:
    def test_put_get_update_roundtrip(self):
        async def go():
            nodes = await _network(8)
            try:
                target, stored = await nodes[1].put_mutable(SK, "Hello World!", seq=1)
                assert stored > 0
                assert target == hashlib.sha1(PK).digest()
                item = await nodes[6].get_item(target)
                assert item is not None
                assert item.value == b"Hello World!" and item.seq == 1
                assert item.k == PK
                # monotonic update wins
                _, stored2 = await nodes[2].put_mutable(SK, "v2", seq=2)
                assert stored2 > 0
                item2 = await nodes[7].get_item(target)
                assert item2.value == b"v2" and item2.seq == 2
            finally:
                _close(nodes)

        run(go())

    def test_salted_identities_are_distinct(self):
        async def go():
            nodes = await _network(6)
            try:
                t1, s1 = await nodes[1].put_mutable(SK, b"a", seq=1, salt=b"one")
                t2, s2 = await nodes[1].put_mutable(SK, b"b", seq=1, salt=b"two")
                assert s1 > 0 and s2 > 0 and t1 != t2
                i1 = await nodes[4].get_item(t1, salt=b"one")
                i2 = await nodes[4].get_item(t2, salt=b"two")
                assert i1.value == b"a" and i2.value == b"b"
                # wrong salt → signature check fails client-side
                assert await nodes[4].get_item(t1, salt=b"two") is None
            finally:
                _close(nodes)

        run(go())

    def test_stale_seq_rejected_by_store(self):
        async def go():
            nodes = await _network(4)
            try:
                await nodes[1].put_mutable(SK, b"new", seq=5)
                target, stored = await nodes[2].put_mutable(SK, b"old", seq=3)
                assert stored == 0  # every node holds seq 5, rejects 3
                item = await nodes[3].get_item(target)
                assert item.value == b"new" and item.seq == 5
            finally:
                _close(nodes)

        run(go())

    def test_cas_precondition(self):
        async def go():
            nodes = await _network(4)
            try:
                await nodes[1].put_mutable(SK, b"base", seq=1)
                # wrong cas: every store rejects with 301
                _, stored = await nodes[1].put_mutable(SK, b"won't", seq=2, cas=9)
                assert stored == 0
                # right cas: accepted
                _, stored = await nodes[1].put_mutable(SK, b"will", seq=2, cas=1)
                assert stored > 0
            finally:
                _close(nodes)

        run(go())

    def test_bad_signature_rejected_by_store(self):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                await a.ping(("127.0.0.1", b.port))
                _, _, token = await a.get_rpc(("127.0.0.1", b.port), b"\x01" * 20)
                with pytest.raises(DHTError, match="signature"):
                    await a.put_rpc(
                        ("127.0.0.1", b.port),
                        token,
                        {
                            b"v": b"evil",
                            b"k": PK,
                            b"seq": 1,
                            b"sig": b"\x00" * 64,
                        },
                    )
                assert not b.item_store
            finally:
                a.close()
                b.close()

        run(go())

    def test_seq_arg_suppresses_current_value(self):
        """The update-check fast path: a getter already at seq N gets no
        redundant v back."""

        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                await a.ping(("127.0.0.1", b.port))
                _, _, token = await a.get_rpc(("127.0.0.1", b.port), b"\x00" * 20)
                blob = item_signature_blob(b"", 4, bencode(b"val"))
                await a.put_rpc(
                    ("127.0.0.1", b.port),
                    token,
                    {
                        b"v": b"val",
                        b"k": ed.publickey_expanded(SK),
                        b"seq": 4,
                        b"sig": ed.sign_expanded(SK, blob),
                    },
                )
                target = hashlib.sha1(PK).digest()
                r = await a._query(
                    ("127.0.0.1", b.port), "get", {b"target": target, b"seq": 4}
                )
                assert r[b"seq"] == 4 and b"v" not in r
                r2 = await a._query(
                    ("127.0.0.1", b.port), "get", {b"target": target, b"seq": 3}
                )
                assert r2[b"v"] == b"val"
            finally:
                a.close()
                b.close()

        run(go())

    def test_error_reply_is_not_a_liveness_failure(self):
        """A node that answers 'get' with a KRPC error (e.g. a non-BEP44
        implementation's 204) proves it is alive; a lookup touching it
        must not mark it failed in the routing table."""

        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                # make b answer every 'get' like a pre-BEP44 node
                b._handle_get = lambda addr, tid, args: b._error(
                    addr, tid, 204, "method unknown"
                )
                await a.ping(("127.0.0.1", b.port))
                with pytest.raises(DHTRemoteError):
                    await a.get_rpc(("127.0.0.1", b.port), b"\x01" * 20)
                await a.get_item(b"\x01" * 20)  # full lookup touches b
                entry = next(
                    n for bucket in a.table.buckets for n in bucket
                    if n.node_id == b.node_id
                )
                assert entry.failed == 0
            finally:
                a.close()
                b.close()

        run(go())

    def test_hostile_query_fuzz_never_kills_the_endpoint(self):
        """Randomized malformed get/put/sample_infohashes datagrams (the
        round-3 handlers) must never kill the endpoint or corrupt its
        stores; a legitimate round trip still works afterwards."""
        import random as _random

        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            await a.ping(("127.0.0.1", b.port))
            rng = _random.Random(44)
            junk_values = [
                b"", b"x", b"\x00" * 20, b"\x00" * 32, b"\x00" * 64,
                -1, 0, 2**70, [], [b"x"], {}, {b"a": b"b"}, b"\xff" * 1000,
            ]
            for i in range(300):
                q = rng.choice([b"get", b"put", b"sample_infohashes", b"get_peers"])
                args = {b"id": rng.choice(junk_values)}
                for key in (b"target", b"v", b"k", b"sig", b"seq", b"salt",
                            b"cas", b"token", b"info_hash", b"scrape"):
                    if rng.random() < 0.5:
                        args[key] = rng.choice(junk_values)
                pkt = bencode({b"t": i.to_bytes(2, "big"), b"y": b"q", b"q": q, b"a": args})
                b._on_datagram(pkt, ("127.0.0.1", 40000 + (i % 1000)))
            await asyncio.sleep(0.1)  # let any scheduled put verifies run
            # the endpoint survived and a real put/get still round-trips
            target, stored = await a.put_immutable(b"still alive")
            assert stored > 0
            item = await a.get_item(target)
            assert item is not None and item.value == b"still alive"
            # no malformed junk leaked into the item store
            for ent in b.item_store.values():
                assert isinstance(ent["v_raw"], bytes)
            a.close()
            b.close()

        run(go())

    def test_routing_table_persists_across_restart(self, tmp_path):
        """save_state/load_state round trip + a Client rejoining via its
        persisted nodes with NO bootstrap seeds configured."""
        from torrent_tpu_torch.session.client import Client, ClientConfig

        async def go():
            path = str(tmp_path / "dht.state")
            nodes = [await DHTNode(host="127.0.0.1").start() for _ in range(5)]
            seed = ("127.0.0.1", nodes[0].port)
            for n in nodes[1:]:
                await n.bootstrap([seed])
            # first client session: joins via explicit bootstrap, saves
            c1 = Client(
                ClientConfig(
                    host="127.0.0.1",
                    enable_dht=True,
                    dht_bootstrap=(seed,),
                    dht_state_path=path, hasher="cpu",
                )
            )
            await c1.start()
            first_id = c1.dht.node_id
            assert len(c1.dht.table) >= 1
            await c1.close()
            node_id, addrs = DHTNode.load_state(path)
            assert node_id == first_id
            assert ("127.0.0.1", nodes[0].port) in addrs or len(addrs) >= 1
            # second session: NO bootstrap seeds — rejoins from the file
            c2 = Client(
                ClientConfig(
                    host="127.0.0.1", enable_dht=True, dht_state_path=path, hasher="cpu"
                )
            )
            await c2.start()
            try:
                assert c2.dht.node_id == first_id  # identity persisted
                assert len(c2.dht.table) >= 1, "failed to rejoin from saved nodes"
                target, stored = await c2.dht.put_immutable(b"rejoined")
                assert stored > 0  # the rejoined table actually works
            finally:
                await c2.close()
                for n in nodes:
                    n.close()
            # corrupted file falls back safely
            (tmp_path / "dht.state").write_bytes(b"garbage")
            assert DHTNode.load_state(path) == (None, [])

        run(go())

    def test_items_expire(self, monkeypatch):
        async def go():
            a = await DHTNode(host="127.0.0.1").start()
            b = await DHTNode(host="127.0.0.1").start()
            try:
                await a.ping(("127.0.0.1", b.port))
                target, stored = await a.put_immutable(b"ephemeral")
                assert stored > 0 and b._live_item(target) is not None
                b.item_store[target]["ts"] -= ITEM_TTL_SECS + 1
                assert b._live_item(target) is None
                assert target not in b.item_store
            finally:
                a.close()
                b.close()

        run(go())
