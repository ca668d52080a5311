"""State and settings that cross from the reference into the port, and
the SOCKS5 dial paths the port had no module for.

- ``compat.client_config_from_reference`` carries the discovery and
  transport options (DHT, uTP, LSD, UPnP, NAT-PMP, BEP 34, the IP
  filter, the proxy), and the port's ``Client`` accepts what it carries.
- A DHT routing-table file (``dht_state_path``) written by one
  package's node is read by the other's with the same id and nodes, and
  a client started on it keeps that id.
- ``net.tracker.announce(..., proxy=...)`` and a ``Torrent`` built with
  ``proxy=`` dial through a SOCKS5 stub (both imported a module the port
  lacked until ``net/socks.py`` was ported).
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from tests.test_torch_session import build_torrent_bytes, fast_config, run
from tests.test_torch_socks import Socks5Server

DISCOVERY = dict(
    enable_dht=True,
    dht_port=0,
    dht_bootstrap=(("127.0.0.1", 1),),
    dht_enforce_bep42=True,
    dht_read_only=True,
    enable_utp=True,
    enable_lsd=True,
    enable_upnp=True,
    enable_natpmp=True,
    dns_tracker_prefs=True,
    ip_filter=("10.0.0.0/8", "192.0.2.7"),
)


@pytest.mark.parametrize(
    "fields",
    [DISCOVERY, {"proxy": "socks5://u:p@127.0.0.1:1080", "enable_utp": True, "dns_tracker_prefs": True}],
    ids=["discovery", "proxy"],
)
def test_client_config_from_reference_carries_discovery_and_transport(fields, tmp_path):
    from torrent_tpu.session.client import Client as RefClient
    from torrent_tpu.session.client import ClientConfig as RefClientConfig
    from torrent_tpu_torch.compat import client_config_from_reference
    from torrent_tpu_torch.session.client import Client

    ref = RefClientConfig(hasher="cpu", dht_state_path=str(tmp_path / "dht.dat"), **fields)
    port = client_config_from_reference(ref, device="cpu")
    for f in dataclasses.fields(RefClientConfig):
        if f.name not in ("torrent", "hasher"):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    mine, theirs = Client(port), RefClient(ref)
    assert (mine.ip_filter is None) == (theirs.ip_filter is None)
    assert (mine.proxy is None) == (theirs.proxy is None)
    assert (mine.dns_prefs is None) == (theirs.dns_prefs is None)
    if mine.proxy is not None:
        assert dataclasses.asdict(mine.proxy) == dataclasses.asdict(theirs.proxy)


def test_converted_client_starts_its_dht_and_utp():
    from torrent_tpu.session.client import ClientConfig as RefClientConfig
    from torrent_tpu_torch.compat import client_config_from_reference
    from torrent_tpu_torch.session.client import Client

    async def go():
        cfg = client_config_from_reference(
            RefClientConfig(host="127.0.0.1", hasher="cpu", enable_dht=True, enable_utp=True, dht_read_only=True)
        )
        c = Client(cfg)
        await c.start()
        try:
            assert c.dht is not None and c.dht.read_only and c.utp is not None
            assert c.utp.port == c.port
        finally:
            await c.close()

    run(go())


def _table_node(mod, node_id):
    node = mod.DHTNode(node_id=node_id, host="127.0.0.1")
    for i in range(1, 9):
        node.table.update(bytes([i]) * 20, f"10.2.{i}.1", 6000 + i)
    node.table.update(b"\xf0" * 20, "2001:db8::5", 6100)
    return node


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_dht_state_file_crosses_packages(writer, reader, tmp_path):
    """A routing table saved by one package's node loads in the other's
    with the same id and nodes, and a client of the reading package
    started on the file keeps the id."""
    from torrent_tpu.net import dht as ref_dht
    from torrent_tpu.session.client import Client as RefClient
    from torrent_tpu.session.client import ClientConfig as RefClientConfig
    from torrent_tpu_torch.net import dht as port_dht
    from torrent_tpu_torch.session.client import Client, ClientConfig

    mods = {"ref": ref_dht, "port": port_dht}
    clients = {"ref": (RefClient, RefClientConfig), "port": (Client, ClientConfig)}
    path = str(tmp_path / "dht.dat")
    node_id = bytes(range(20))
    _table_node(mods[writer], node_id).save_state(path)
    loaded = mods[reader].DHTNode.load_state(path)
    assert loaded == mods[writer].DHTNode.load_state(path)
    assert loaded[0] == node_id and len(loaded[1]) == 9

    async def go():
        make, config = clients[reader]
        c = make(config(host="127.0.0.1", hasher="cpu", enable_dht=True, dht_state_path=path))
        await c.start()
        try:
            return c.dht.node_id
        finally:
            await c.close()

    assert run(go(), timeout=60) == node_id


def test_tracker_announce_through_socks5_stub():
    """``net.tracker.announce(url, info, proxy=...)`` reaches the tracker
    through the proxy's CONNECT."""
    from torrent_tpu_torch.net.socks import ProxySpec
    from torrent_tpu_torch.net.tracker import announce
    from torrent_tpu_torch.net.types import AnnounceEvent, AnnounceInfo
    from torrent_tpu_torch.server.in_memory import run_tracker
    from torrent_tpu_torch.server.tracker import ServeOptions

    async def go():
        srv = await Socks5Server().start()
        tracker, pump = await run_tracker(ServeOptions(http_port=0, udp_port=None, host="127.0.0.1", interval=2))
        try:
            info = AnnounceInfo(
                info_hash=b"\x21" * 20, peer_id=b"-TT0001-socksrepair0", port=6881,
                uploaded=0, downloaded=0, left=1, event=AnnounceEvent.STARTED,
            )
            res = await announce(
                f"http://127.0.0.1:{tracker.http_port}/announce", info, proxy=ProxySpec("127.0.0.1", srv.port)
            )
            assert res.interval == 2
            assert srv.connects == [("127.0.0.1", tracker.http_port)]
        finally:
            srv.close()
            tracker.close()
            await asyncio.wait_for(pump, 5)

    run(go())


def test_torrent_built_with_proxy_dials_through_socks5_stub():
    """A ``Torrent`` built directly (no ``Client``) with ``proxy=`` dials
    its peer through the stub and downloads the payload."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.net.socks import ProxySpec
    from torrent_tpu_torch.net.types import AnnouncePeer
    from torrent_tpu_torch.session.client import Client, ClientConfig, generate_peer_id
    from torrent_tpu_torch.session.torrent import Torrent
    from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

    payload = np.random.default_rng(52).bytes(3 * 32768 + 7)
    m = parse_metainfo(build_torrent_bytes(payload, 32768, b"http://127.0.0.1:1/announce"))

    async def go():
        srv = await Socks5Server().start()
        seed = Client(ClientConfig(host="127.0.0.1", hasher="cpu"))
        seed.config.torrent = fast_config()
        await seed.start()
        t = None
        try:
            store = Storage(MemoryStorage(), m.info)
            store.set(0, payload)
            await seed.add(m, store)
            t = Torrent(
                metainfo=m, storage=Storage(MemoryStorage(), m.info), peer_id=generate_peer_id(),
                port=6881, config=fast_config(), proxy=ProxySpec("127.0.0.1", srv.port),
            )
            await t.start()
            t._connect_new_peers([AnnouncePeer(ip="127.0.0.1", port=seed.port)])
            await asyncio.wait_for(t.on_complete.wait(), 30)
            assert t.storage.get(0, len(payload)) == payload
            assert ("127.0.0.1", seed.port) in srv.connects
        finally:
            if t is not None:
                await t.stop()
            await seed.close()
            srv.close()

    run(go())
