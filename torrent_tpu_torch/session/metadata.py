"""Magnet join: fetch the info dict from the swarm via BEP 9 ut_metadata.

The reference lists magnet links as roadmap (README.md:39). This module
completes the path: announce with just the magnet's info hash, dial
peers, negotiate BEP 10, pull metadata pieces, SHA1-verify the assembled
blob against the info hash, and return a full ``Metainfo`` ready for
``Client.add``.

Peers are tried concurrently and independently — each attempt fetches
the whole (typically few-KiB) dict, and the first complete verified copy
wins; losers are cancelled. ``max_concurrent`` bounds the redundant
bandwidth. Within a peer, piece requests are pipelined.
"""

from __future__ import annotations

import asyncio

from torrent_tpu_torch.codec.magnet import Magnet
from torrent_tpu_torch.codec.metainfo import Metainfo, metainfo_from_info_bytes
from torrent_tpu_torch.net import extension as ext
from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.net.types import AnnounceEvent, AnnounceInfo
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("session.metadata")


class MetadataError(Exception):
    pass


async def _fetch_layers_on_conn(
    reader, writer, info_v2, timeout: float
) -> dict[bytes, tuple[bytes, ...]]:
    """Pull every multi-piece file's piece layer over an already-open
    peer connection (BEP 52 messages 21-23), each run proven against the
    file's trusted ``pieces root`` before acceptance.

    A btmh magnet joiner needs this immediately after ut_metadata: the
    info dict carries only per-file roots; the per-piece expected digests
    (the piece layers) live outside it. Reuses the metadata connection —
    the peer that served the info dict is the one best placed to serve
    the layers, and no session object exists yet to route futures.
    """
    from torrent_tpu_torch.models.hashes import (
        MAX_RUN,
        HashRequestFields,
        _layer_height,
        verify_hash_response,
    )
    from torrent_tpu_torch.session.v2 import multi_piece_roots

    plen = info_v2.piece_length
    base = _layer_height(plen)
    layers: dict[bytes, tuple[bytes, ...]] = {}
    for root, n_pieces in multi_piece_roots(info_v2):
        padded = 1 << (n_pieces - 1).bit_length()
        run = min(padded, MAX_RUN)
        # runs beyond MAX_RUN chain to the root via uncle proofs
        proofs = (padded.bit_length() - 1) - (run.bit_length() - 1)
        got_all: list[bytes] = []
        for start in range(0, min(padded, n_pieces), run):
            fields = (root, base, start, run, proofs)
            req = HashRequestFields(*fields)
            writer.write(proto.encode_message(proto.HashRequest(*fields)))
            await writer.drain()
            while True:
                msg = await asyncio.wait_for(proto.read_message(reader), timeout=timeout)
                if msg is None:
                    raise MetadataError("peer closed during layer fetch")
                if isinstance(msg, (proto.Hashes, proto.HashReject)) and (
                    msg.pieces_root,
                    msg.base_layer,
                    msg.index,
                    msg.length,
                    msg.proof_layers,
                ) == fields:
                    if isinstance(msg, proto.HashReject):
                        raise MetadataError("peer rejected piece-layer request")
                    got = msg.hash_list()
                    break
                # bitfield/have/choke etc. — irrelevant, keep draining
            if not verify_hash_response(req, got):
                raise MetadataError("piece-layer response failed merkle proof")
            got_all.extend(got[:run])
        layers[root] = tuple(got_all[:n_pieces])
    return layers


async def _fetch_from_peer(
    addr: tuple[str, int],
    info_hash: bytes,
    peer_id: bytes,
    timeout: float,
    v2_hash: bytes | None = None,
    proxy=None,
) -> tuple[bytes, dict | None]:
    """Dial one peer and pull the whole info dict from it.

    ``v2_hash`` switches validation to BEP 52 (SHA-256 of the blob must
    equal the btmh topic) and additionally fetches the piece layers on
    the same connection → ``(blob, layers)``; v1 returns ``(blob, None)``.
    """
    if proxy is not None:
        from torrent_tpu_torch.net.socks import open_connection as socks_open

        reader, writer = await asyncio.wait_for(
            socks_open(proxy, addr[0], addr[1]), timeout=timeout * 2
        )
    else:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(addr[0], addr[1]), timeout=timeout
        )
    try:
        await proto.send_handshake(writer, info_hash, peer_id, ext.extension_reserved())
        ih, reserved = await asyncio.wait_for(proto.read_handshake_head(reader), timeout=timeout)
        await asyncio.wait_for(proto.read_handshake_peer_id(reader), timeout=timeout)
        if ih != info_hash:
            raise MetadataError("handshake info hash mismatch")
        if not ext.supports_extensions(reserved):
            raise MetadataError("peer has no extension protocol")
        state = ext.ExtensionState(enabled=True)
        writer.write(proto.encode_message(proto.Extended(0, ext.encode_extended_handshake())))
        await writer.drain()

        assembler: ext.MetadataAssembler | None = None
        deadline = asyncio.get_running_loop().time() + timeout * 10

        while True:
            if asyncio.get_running_loop().time() > deadline:
                raise MetadataError("metadata fetch deadline exceeded")
            msg = await asyncio.wait_for(proto.read_message(reader), timeout=timeout)
            if msg is None:
                raise MetadataError("peer closed during metadata fetch")
            if not isinstance(msg, proto.Extended):
                continue  # bitfield / have etc. — irrelevant pre-metadata
            if msg.ext_id == 0:
                ext.decode_extended_handshake(msg.payload, state)
                if state.ut_metadata_id == 0 or state.metadata_size == 0:
                    raise MetadataError("peer does not serve ut_metadata")
                if assembler is not None:
                    continue  # BEP 10 allows repeat handshakes; keep progress
                assembler = ext.MetadataAssembler(state.metadata_size)
                for piece in assembler.missing():
                    writer.write(
                        proto.encode_message(
                            proto.Extended(
                                state.ut_metadata_id, ext.encode_metadata_request(piece)
                            )
                        )
                    )
                await writer.drain()
                continue
            if msg.ext_id != ext.LOCAL_EXT_IDS[ext.UT_METADATA] or assembler is None:
                continue
            mm = ext.decode_metadata_message(msg.payload)
            if mm is None:
                continue
            if mm.msg_type == ext.MsgType.REJECT:
                raise MetadataError(f"peer rejected metadata piece {mm.piece}")
            if mm.msg_type == ext.MsgType.DATA:
                assembler.add(mm)
                if not assembler.complete:
                    continue
                if v2_hash is None:
                    blob = assembler.result(info_hash)
                    if blob is None:
                        raise MetadataError("metadata failed hash verification")
                    return blob, None
                blob = assembler.result_v2(v2_hash)
                if blob is None:
                    raise MetadataError("metadata failed sha-256 verification")
                from torrent_tpu_torch.codec.bencode import BencodeError, bdecode
                from torrent_tpu_torch.codec.metainfo_v2 import parse_v2_info_dict

                # a btmh topic minted from a non-bencode blob passes the
                # sha-256 check; the decode failure must stay a
                # MetadataError so other candidate peers are still tried
                try:
                    info_v2 = parse_v2_info_dict(bdecode(blob, strict=False))
                except BencodeError as e:
                    raise MetadataError(f"fetched v2 info dict not bencode: {e}")
                if info_v2 is None:
                    raise MetadataError("fetched v2 info dict failed validation")
                layers = await _fetch_layers_on_conn(reader, writer, info_v2, timeout)
                return blob, layers
    finally:
        writer.close()


async def fetch_metadata(
    magnet: Magnet,
    peer_id: bytes,
    port: int = 6881,
    peer_timeout: float = 10.0,
    max_concurrent: int = 8,
    dht=None,
    ip_filter=None,  # optional net.ipfilter.IpFilter: candidates never dialed
    proxy=None,  # optional net.socks.ProxySpec for peer dials + trackers
) -> "Metainfo":
    """Resolve a magnet to a full session metainfo using trackers + x.pe
    peers + (when a ``net.dht.DHTNode`` is supplied) mainline-DHT
    discovery.

    v1/hybrid magnets (btih) return a ``Metainfo``; pure-v2 magnets
    (btmh only) fetch the info dict AND the piece layers (BEP 52 hash
    transfer) and return a ``session.v2.V2SessionMeta``. Either result
    drops straight into ``Client.add``. Raises ``MetadataError`` if no
    reachable peer can serve a verified copy.
    """
    v2_only = magnet.info_hash is None
    # BEP 52: a pure-v2 swarm announces and handshakes with the
    # TRUNCATED sha-256 infohash (the v2 analogue of protocol.ts:36-67)
    wire_hash = magnet.wire_hash
    candidates: list[tuple[str, int]] = list(magnet.peer_addrs)
    if dht is not None:
        try:
            candidates.extend(await dht.lookup_peers(wire_hash))
        except Exception as e:
            log.warning("dht peer lookup failed: %s", e)
    if magnet.trackers:
        from torrent_tpu_torch.net.tracker import TrackerError, announce

        info = AnnounceInfo(
            info_hash=wire_hash,
            peer_id=peer_id,
            port=port,
            uploaded=0,
            downloaded=0,
            left=1,  # unknown size: nonzero = we're a leecher
            event=AnnounceEvent.STARTED,
        )
        for tr in magnet.trackers:
            try:
                res = await announce(tr, info, proxy=proxy)
                candidates.extend((p.ip, p.port) for p in res.peers)
            except (TrackerError, OSError, asyncio.TimeoutError) as e:
                log.warning("magnet announce to %s failed: %s", tr, e)
    seen: set[tuple[str, int]] = set()
    candidates = [c for c in candidates if not (c in seen or seen.add(c))]
    if ip_filter is not None:
        # the blocklist covers the metadata fetch too — "never dialed"
        # must hold before the torrent object even exists
        candidates = [c for c in candidates if not ip_filter.blocked(c[0])]
    if not candidates:
        raise MetadataError("magnet has no reachable peer sources")

    sem = asyncio.Semaphore(max_concurrent)
    errors: list[str] = []

    async def attempt(addr):
        async with sem:
            try:
                return await _fetch_from_peer(
                    addr,
                    wire_hash,
                    peer_id,
                    peer_timeout,
                    v2_hash=magnet.info_hash_v2 if v2_only else None,
                    proxy=proxy,
                )
            except (MetadataError, proto.ProtocolError, OSError, asyncio.TimeoutError) as e:
                errors.append(f"{addr}: {e}")
                return None

    tasks = [asyncio.ensure_future(attempt(a)) for a in candidates]
    got = None
    try:
        for fut in asyncio.as_completed(tasks):
            got = await fut
            if got is not None:
                break
    finally:
        for t in tasks:
            t.cancel()
    if got is None:
        raise MetadataError(f"all metadata sources failed: {errors[:5]}")
    blob, layers = got
    if v2_only:
        from torrent_tpu_torch.session.v2 import V2Error, v2_session_meta_from_parts

        try:
            return v2_session_meta_from_parts(
                blob,
                magnet.info_hash_v2,
                layers or {},
                announce=magnet.trackers[0] if magnet.trackers else "",
            )
        except V2Error as e:
            raise MetadataError(f"fetched v2 metadata unusable: {e}")
    mi = metainfo_from_info_bytes(
        blob,
        announce=magnet.trackers[0] if magnet.trackers else "",
        announce_list=[[t] for t in magnet.trackers] if magnet.trackers else None,
    )
    if mi is None:
        raise MetadataError("fetched info dict failed metainfo validation")
    if mi.info_hash != magnet.info_hash:
        # A dict that doesn't re-encode byte-exactly (e.g. duplicate keys)
        # would otherwise be registered/announced under the wrong hash.
        raise MetadataError("info dict does not round-trip to the magnet hash")
    return mi
