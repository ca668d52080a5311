"""Client: TCP listener, torrent registry, accept loop (ref L6: client.ts).

Owns the listening socket and peer identity, routes inbound handshakes to
torrents by info hash *before* replying so unknown torrents are dropped
silently (client.ts:85-104), and shares one GPUVerifier across torrents
when the 'gpu' hasher is selected (the default: on ``device``, where None
means CUDA and a host without it refuses to start, before any TCP or
UDP socket opens).

The port of the JAX package's client, with every subsystem it has:
UPnP, NAT-PMP, the DHT (BEP 5/44/46), LSD, uTP, BEP 34 DNS preferences,
the IP filter, the SOCKS5 proxy, magnets and signed-torrent checks.

Fixed vs the reference: config defaults are copied per-instance instead
of mutating a shared defaults object (client.ts:47, SURVEY §8.2), and the
broken ``fileStorage`` import (§8.1) has no analogue — storage backends
are injected explicitly.
"""

from __future__ import annotations

import asyncio
import random
import string
import dataclasses
from dataclasses import dataclass, field

from torrent_tpu_torch.codec.metainfo import Metainfo
from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig
from torrent_tpu_torch.storage.storage import FsStorage, Storage, StorageMethod
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("session.client")

PEER_ID_PREFIX = b"-TT0100-"  # torrent-tpu 0.1 (client.ts:19-31 analogue)


def generate_peer_id() -> bytes:
    suffix = "".join(random.choices(string.ascii_letters + string.digits, k=12))
    return PEER_ID_PREFIX + suffix.encode("ascii")


@dataclass
class ClientConfig:
    """(client.ts:13-23). Fresh instance per Client — never shared."""

    port: int = 0  # 0 = ephemeral
    host: str = "0.0.0.0"
    peer_id: bytes = field(default_factory=generate_peer_id)
    hasher: str = "gpu"  # 'gpu' | 'cpu' piece verification (BASELINE API)
    # the card of the "gpu" hasher: None means CUDA (start() raises on a
    # host without it); "cpu" runs the plain PyTorch kernels
    device: str | None = None
    # Shared hash-plane scheduler (torrent_tpu_torch.sched): when set, every
    # torrent's resume/self-heal recheck submits to this queue as a
    # low-priority tenant instead of dispatching private device batches
    scheduler: object | None = None
    torrent: TorrentConfig = field(default_factory=TorrentConfig)
    enable_upnp: bool = False  # optional, off by default (SURVEY §7.8)
    # NAT-PMP (RFC 6886): lighter port mapping many gateways speak when
    # they don't do UPnP IGD; also used as a fallback when enable_upnp
    # finds no gateway. Renewed at half-lifetime while running.
    enable_natpmp: bool = False
    resume: bool = True  # fastresume checkpoints for path-based storage
    enable_dht: bool = False  # BEP 5 mainline DHT (net/dht.py)
    dht_port: int = 0  # 0 = ephemeral UDP port
    dht_bootstrap: tuple = ()  # ((host, port), ...) seed nodes
    # Routing-table persistence: node id + good entries saved here on
    # close and rejoined on start (fast restart without public seeds)
    dht_state_path: str = ""
    # BEP 42: reject routing-table nodes whose ids don't derive from
    # their IP (id-targeting defense; off by default for compat)
    dht_enforce_bep42: bool = False
    # BEP 43: mark our queries ro=1 and answer none — for nodes that
    # can't serve (NAT'd/firewalled) and shouldn't pollute peers' tables
    dht_read_only: bool = False
    # Client-global transfer caps in bytes/s (0 = unlimited): one token
    # bucket per direction shared by every torrent (utils/ratelimit.py)
    max_upload_bps: int = 0
    max_download_bps: int = 0
    enable_lsd: bool = False  # BEP 14 local service discovery (net/lsd.py)
    # BEP 34 DNS tracker preferences: expand each announce URL through
    # the host's published TXT record (deny/port/protocol hints) before
    # announcing; resolver trouble fails open. Off by default.
    dns_tracker_prefs: bool = False
    # BEP 29 uTP transport (net/utp.py): accept uTP peers on the same
    # port (UDP) and prefer uTP for outbound dials, TCP fallback
    enable_utp: bool = False
    # CIDR blocklist ("10.0.0.0/8", "2001:db8::/32", single IPs too):
    # matching peers are neither dialed nor accepted
    ip_filter: tuple = ()
    # SOCKS5 proxy URL ("socks5://[user:pass@]host:port", net/socks.py):
    # routes TCP peer dials, HTTP(S) trackers, and metadata fetches.
    # UDP paths can't ride a CONNECT tunnel, so UDP trackers are skipped
    # and outbound uTP + webseeds are disabled (no leaks around it).
    proxy: str = ""


class Client:
    def __init__(self, config: ClientConfig | None = None):
        from torrent_tpu_torch.utils.ratelimit import TokenBucket

        self.config = config or ClientConfig()
        self.torrents: dict[bytes, Torrent] = {}
        self._server: asyncio.AbstractServer | None = None
        self._verifier_cache: dict[int, object] = {}
        self.external_ip: str | None = None
        self.port: int | None = None  # assigned by start()
        self.dht = None  # net.dht.DHTNode when enable_dht
        self._dht_maintenance: asyncio.Task | None = None
        self.upload_bucket = TokenBucket(self.config.max_upload_bps)
        self.download_bucket = TokenBucket(self.config.max_download_bps)
        self.lsd = None  # net.lsd.LocalServiceDiscovery when enable_lsd
        self.utp = None  # net.utp.UtpEndpoint when enable_utp
        self._natpmp_task: asyncio.Task | None = None
        # test seams: a fake gateway address/port instead of the route table
        self._natpmp_gateway: str | None = None
        self._natpmp_port: int = 5351
        # the port the gateway actually forwards (differs from self.port
        # when the NAT-PMP suggestion wasn't honored); announces use it
        self.external_port: int | None = None
        if self.config.ip_filter:
            from torrent_tpu_torch.net.ipfilter import IpFilter

            self.ip_filter = IpFilter(self.config.ip_filter)
        else:
            self.ip_filter = None
        if self.config.proxy:
            from torrent_tpu_torch.net.socks import ProxySpec

            self.proxy = ProxySpec.parse(self.config.proxy)  # fails loudly
            # raw-UDP subsystems would announce the client's real address
            # around the tunnel; refusing the combination keeps the
            # no-leak promise explicit instead of silently partial
            if self.config.enable_dht:
                raise ValueError(
                    "enable_dht with a SOCKS5 proxy would announce your real "
                    "address over raw UDP around the tunnel; disable one"
                )
            if self.config.enable_lsd:
                raise ValueError(
                    "enable_lsd with a SOCKS5 proxy would multicast your real "
                    "address on the LAN; disable one"
                )
        else:
            self.proxy = None
        self.dns_prefs = None  # net.dnsprefs.TrackerPrefs when enabled
        if self.config.dns_tracker_prefs:
            if self.proxy is not None:
                # the TXT lookup is raw UDP from THIS host: under a SOCKS
                # proxy it would leak tracker hostnames around the tunnel
                # the user configured for exactly that traffic — and a
                # UDP-only preference record would route announces onto a
                # transport the proxy cannot carry. Fail safe: disabled.
                log.warning(
                    "dns_tracker_prefs disabled: BEP 34 lookups would "
                    "bypass the SOCKS proxy"
                )
            else:
                from torrent_tpu_torch.net.dnsprefs import TrackerPrefs

                # one shared cache for every torrent's tracker rotation
                self.dns_prefs = TrackerPrefs()

    async def __aenter__(self) -> "Client":
        try:
            await self.start()
        except BaseException:
            # __aexit__ never runs when __aenter__ raises: release the
            # listener/mappings a partial start() may have acquired
            await self.close()
            raise
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # ------------------------------------------------------------- startup

    async def start(self) -> None:
        """listen → learn real port → (optional UPnP) → accept loop
        (client.ts:69-83). With the "gpu" hasher the device is resolved
        first: a host without the card raises before a socket opens."""
        if self.config.hasher == "gpu":
            from torrent_tpu_torch.utils.device import resolve_device

            resolve_device(self.config.device)
        self._server = await asyncio.start_server(
            self._accept, self.config.host, self.config.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.config.enable_upnp:
            # before DHT: a learned external IP lets the DHT node mint a
            # BEP 42-compliant id at construction
            try:
                from torrent_tpu_torch.net.upnp import get_ip_addrs_and_map_port

                ips = await get_ip_addrs_and_map_port(self.port)
                self.external_ip = ips.external_ip
            except Exception as e:  # UPnP is best-effort
                log.warning("UPnP setup failed: %s", e)
        if self.config.enable_natpmp and self.external_ip is None:
            # explicit: worth blocking start briefly — the learned
            # external IP lets the DHT mint a BEP 42 id below
            await self._try_natpmp()
        elif self.config.enable_upnp and self.external_ip is None:
            # fallback after a failed UPnP probe: run in the background —
            # a gateway speaking NEITHER protocol would otherwise add the
            # whole retry ladder (~8 s) to every start
            self._natpmp_task = asyncio.create_task(self._try_natpmp())
        if self.config.enable_dht:
            from torrent_tpu_torch.net.dht import DHTNode

            from torrent_tpu_torch.net.dht import bep42_valid

            saved_id, saved_nodes = (
                DHTNode.load_state(self.config.dht_state_path)
                if self.config.dht_state_path
                else (None, [])
            )
            # a persisted id keeps our routing-table position (and other
            # nodes' entries for us) across restarts; it survives a
            # learned external IP as long as it is still BEP 42-valid
            # for it (the common unchanged-IP case), else a compliant id
            # is minted fresh
            keep_id = saved_id is not None and (
                self.external_ip is None or bep42_valid(saved_id, self.external_ip)
            )
            self.dht = await DHTNode(
                node_id=saved_id if keep_id else None,
                port=self.config.dht_port,
                host=self.config.host,
                enforce_bep42=self.config.dht_enforce_bep42,
                external_ip=self.external_ip,
                read_only=self.config.dht_read_only,
            ).start()
            seeds = [tuple(a) for a in self.config.dht_bootstrap] + saved_nodes
            if seeds:
                await self.dht.bootstrap(seeds)
            # table housekeeping for quiet nodes: stale pings + bucket
            # refresh + peer-store expiry (net/dht.py maintain_once)
            self._dht_maintenance = asyncio.create_task(self.dht.maintain())
        if self.config.enable_lsd:
            try:
                from torrent_tpu_torch.net.lsd import LocalServiceDiscovery

                self.lsd = LocalServiceDiscovery(self.port, self._on_lsd_peer)
                await self.lsd.start()
            except Exception as e:  # multicast may be unavailable
                log.warning("LSD setup failed: %s", e)
                self.lsd = None
        if self.config.enable_utp:
            from torrent_tpu_torch.net.utp import create_utp_endpoint

            # same port number as the TCP listener, UDP side — inbound
            # uTP streams run the ordinary BitTorrent handshake through
            # the same accept path as TCP connections
            self.utp = await create_utp_endpoint(
                self.config.host, self.port, on_accept=self._accept
            )

    async def _try_natpmp(self) -> None:
        """Best-effort NAT-PMP mapping + external IP, renewed at half of
        each GRANTED lifetime (gateways may shorten grants over time)."""
        from torrent_tpu_torch.net import natpmp

        gateway = self._natpmp_gateway or natpmp.default_gateway()
        if gateway is None:
            log.warning("NAT-PMP: no default gateway found")
            return
        try:
            self.external_ip = await natpmp.external_address(
                gateway, port=self._natpmp_port
            )
            granted, lifetime = await natpmp.map_port(
                gateway, self.port, tcp=True, port=self._natpmp_port
            )
            await natpmp.map_port(
                gateway, self.port, external_port=granted, tcp=False,
                port=self._natpmp_port,
            )  # uTP/DHT share the port number over UDP
        except (natpmp.NatPmpError, OSError) as e:
            log.warning("NAT-PMP setup failed: %s", e)
            return
        if granted != self.port:
            # the suggestion is only a hint — announces must advertise
            # the port the gateway actually forwards
            self.external_port = granted
        self._natpmp_gateway = gateway
        log.info(
            "NAT-PMP: external %s, port %d -> %d", self.external_ip, self.port, granted
        )

        async def renew():
            life = lifetime
            ext = granted
            while True:
                await asyncio.sleep(min(3600, max(30, life // 2)))
                try:
                    ext, life = await natpmp.map_port(
                        gateway, self.port, external_port=ext, tcp=True,
                        port=self._natpmp_port,
                    )
                    await natpmp.map_port(
                        gateway, self.port, external_port=ext, tcp=False,
                        port=self._natpmp_port,
                    )
                except (natpmp.NatPmpError, OSError) as e:
                    log.warning("NAT-PMP renewal failed: %s", e)

        self._natpmp_task = asyncio.create_task(renew())

    async def _natpmp_unmap(self) -> None:
        """Delete our mappings (RFC 6886 §3.4): the gateway must not keep
        forwarding to a dead socket for the rest of the lease."""
        from torrent_tpu_torch.net import natpmp

        if self._natpmp_gateway is None or self.port is None:
            return
        for tcp in (True, False):
            try:
                await natpmp.map_port(
                    self._natpmp_gateway, self.port, lifetime=0, tcp=tcp,
                    port=self._natpmp_port,
                )
            except (natpmp.NatPmpError, OSError):
                pass

    def _on_lsd_peer(self, info_hash: bytes, addr: tuple[str, int]) -> None:
        """BEP 14 callback: a local client announced this swarm."""
        torrent = self.torrents.get(info_hash)
        if torrent is not None and not torrent.private:
            from torrent_tpu_torch.net.types import AnnouncePeer

            torrent._connect_new_peers([AnnouncePeer(ip=addr[0], port=addr[1])])

    async def close(self) -> None:
        for torrent in list(self.torrents.values()):
            await torrent.stop()
        self.torrents.clear()
        if self.lsd is not None:
            self.lsd.close()
            self.lsd = None
        if self.utp is not None:
            self.utp.close()
            self.utp = None
        if self._dht_maintenance is not None:
            self._dht_maintenance.cancel()
            self._dht_maintenance = None
        if self._natpmp_task is not None:
            self._natpmp_task.cancel()
            self._natpmp_task = None
            await self._natpmp_unmap()
        if self.dht is not None:
            if self.config.dht_state_path:
                try:
                    self.dht.save_state(self.config.dht_state_path)
                except OSError as e:
                    log.warning("dht state save failed: %s", e)
            self.dht.close()
            self.dht = None
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------ torrents

    def _verifier_for(self, piece_length: int):
        """One shared GPUVerifier per piece geometry (built once)."""
        if self.config.hasher != "gpu":
            return None
        v = self._verifier_cache.get(piece_length)
        if v is None:
            from torrent_tpu_torch.models.verifier import GPUVerifier

            v = GPUVerifier(
                piece_length=piece_length,
                batch_size=self.config.torrent.verify_batch_size,
                device=self.config.device,
            )
            self._verifier_cache[piece_length] = v
        return v

    async def add(
        self,
        metainfo: Metainfo,
        storage: Storage | StorageMethod | str,
        wanted_files: list[int] | None = None,
        _adopt_from: tuple = (),  # Torrent donors (BEP 39 predecessor)
    ) -> Torrent:
        """Register + start a torrent (client.ts:53-67).

        ``storage`` may be a ready Storage, a StorageMethod, or a
        directory path (convenience, mirrors `Client.add(metainfo, dir)`).
        ``metainfo`` may also be a parsed pure-v2 ``MetainfoV2`` (BEP 52):
        it is wrapped into the flat-piece-space session view
        (session/v2.py) and keyed/announced by the truncated SHA-256.
        ``wanted_files`` applies a file selection BEFORE the torrent
        starts (out-of-range indices dropped) — selecting after start
        would let pieces of unselected files be requested and written
        during the announce/connect window.
        """
        if self.port is None:
            raise RuntimeError("Client.start() must be awaited before add()")
        from torrent_tpu_torch.codec.metainfo_v2 import MetainfoV2

        if isinstance(metainfo, MetainfoV2):
            from torrent_tpu_torch.session.v2 import v2_session_meta

            metainfo = v2_session_meta(metainfo)
        if metainfo.info_hash in self.torrents:
            raise ValueError("torrent already added")
        resume_store = None
        if isinstance(storage, str):
            if self.config.resume:
                from torrent_tpu_torch.session.resume import FsResumeStore

                resume_store = FsResumeStore(storage)
            storage = Storage(FsStorage(storage), metainfo.info)
        elif not isinstance(storage, Storage):
            storage = Storage(storage, metainfo.info)
        # Derive (never mutate) the per-torrent config: the client-level
        # hasher choice is applied to a copy, so a TorrentConfig shared by
        # the caller across clients stays untouched (the same
        # shared-mutation bug class the reference had, SURVEY §8.2).
        torrent_config = dataclasses.replace(
            self.config.torrent,
            hasher=self.config.hasher,
            device=self.config.device,
            scheduler=(
                self.config.scheduler
                if self.config.scheduler is not None
                else self.config.torrent.scheduler
            ),
        )
        torrent = Torrent(
            metainfo=metainfo,
            storage=storage,
            peer_id=self.config.peer_id,
            port=self.external_port or self.port,
            config=torrent_config,
            # the shared GPUVerifier is the SHA-1 plane — v2 pieces verify
            # against merkle roots instead (session/torrent.py v2 branch)
            verifier=None
            if getattr(metainfo.info, "v2", False)
            else self._verifier_for(metainfo.info.piece_length),
            resume_store=resume_store,
            dht=self.dht,
            upload_bucket=self.upload_bucket,
            download_bucket=self.download_bucket,
            external_ip=self.external_ip,
            utp_dial=self.utp.dial if self.utp is not None else None,
            ip_filter=self.ip_filter,
            proxy=self.proxy,
            dns_prefs=self.dns_prefs,
        )
        self.torrents[metainfo.info_hash] = torrent
        if wanted_files is not None:
            n_files = len(torrent.file_ranges())
            await torrent.select_files(
                [i for i in wanted_files if 0 <= i < n_files]
            )
        await self._adopt_similar(torrent, donor_torrents=tuple(_adopt_from))
        await torrent.start()
        if self.lsd is not None and not torrent.private:
            self.lsd.register(metainfo.info_hash)  # BEP 27: never private
        return torrent

    async def _adopt_similar(
        self,
        torrent: Torrent,
        donor_torrents: tuple[Torrent, ...] = (),
    ) -> None:
        """BEP 38 local-data reuse: pre-fill the new torrent's storage
        from identical files of already-registered torrents.

        Torrents are related when either names the other in ``similar``
        or they share a ``collections`` entry. Files match on (basename,
        size) — BEP 38's v1 criterion — and only fully-verified donor
        spans are copied, BEFORE ``start()`` so the normal recheck adopts
        the bytes (boundary pieces spanning non-shared neighbours simply
        fail the hash and download as usual). Writes go through the
        storage method directly: ``Storage.set``'s duplicate-write marks
        must stay clear so the swarm can overwrite an adopted span whose
        piece hash didn't pan out.
        """
        meta = torrent.metainfo
        # session-meta wrappers (pure-v2) may not carry the BEP 38
        # surface; they can still be adopted INTO when a donor names them
        hints = set(getattr(meta, "similar", ()) or ())
        cols = set(getattr(meta, "collections", ()) or ())
        # explicit donors (BEP 39: the already-STOPPED predecessor — it
        # must not be registered/serving while the successor overwrites
        # shared files, so it can't be found via self.torrents)
        donors = list(donor_torrents)
        for d in self.torrents.values():
            if d is torrent:
                continue
            dm = d.metainfo
            related = (
                dm.info_hash in hints
                or meta.info_hash in (getattr(dm, "similar", ()) or ())
                or (cols and cols.intersection(getattr(dm, "collections", ()) or ()))
            )
            if related:
                donors.append(d)
        if not donors:
            return

        def files_of(t):
            if t.info.files is None:
                off, ln = t.file_ranges()[0]
                return [(t.info.name, off, ln)]
            out = []
            for fe, (off, ln) in zip(t.info.files, t.file_ranges()):
                if getattr(fe, "pad", False) or ln == 0:
                    continue
                out.append((fe.path[-1], off, ln))
            return out

        # donor file index; first fully-verified donor span per key wins
        index: dict[tuple[str, int], tuple[Torrent, int]] = {}
        for d in donors:
            plen = d.info.piece_length
            have = d.bitfield.as_numpy()
            for name, off, ln in files_of(d):
                key = (name, ln)
                if key in index:
                    continue
                lo, hi = off // plen, -(-(off + ln) // plen)
                if have[lo:hi].all():
                    index[key] = (d, off)

        jobs = []  # (donor_storage, donor_off, our_off, length)
        plen_t = torrent.info.piece_length
        prio = torrent._piece_priority
        for name, off, ln in files_of(torrent):
            hit = index.get((name, ln))
            if hit is None:
                continue
            donor, d_off = hit
            if self._same_backing_file(donor.storage, d_off, torrent.storage, off):
                continue  # in-place update: the bytes are already there;
                # the recheck adopts them without a self-copy
            # Copy only spans under WANTED pieces: a file the user
            # deselected contributes just the boundary bytes a wanted
            # neighbour's piece needs, not its full (possibly huge) body.
            lo, hi = off // plen_t, -(-(off + ln) // plen_t)
            run_start = None
            prev = None

            def flush(a, b):
                start = max(off, (lo + a) * plen_t)
                end = min(off + ln, (lo + b + 1) * plen_t)
                if end > start:
                    jobs.append(
                        (donor.storage, d_off + (start - off), start, end - start)
                    )

            for w in range(hi - lo):
                if prio[lo + w] <= 0:
                    continue
                if run_start is None:
                    run_start = w
                elif w != prev + 1:
                    flush(run_start, prev)
                    run_start = w
                prev = w
            if run_start is not None:
                flush(run_start, prev)
        if not jobs:
            return

        def copy_spans():
            copied = 0
            for donor_storage, d_off, t_off, length in jobs:
                try:
                    pos = 0
                    while pos < length:
                        n = min(1 << 20, length - pos)
                        data = donor_storage.get(d_off + pos, n)
                        p = 0
                        for path, foff, chunk in torrent.storage.segments(
                            t_off + pos, len(data)
                        ):
                            if path is not None:
                                torrent.storage.method.set(
                                    path, foff, data[p : p + chunk]
                                )
                            p += chunk
                        pos += n
                    copied += length
                except Exception as e:  # best-effort: recheck is the gate
                    log.warning("BEP 38 adoption failed mid-file: %s", e)
            return copied

        copied = await asyncio.to_thread(copy_spans)
        if copied:
            log.info(
                "BEP 38: adopted %d bytes across %d files from %d related torrents",
                copied,
                len(jobs),
                len(donors),
            )

    @staticmethod
    def _same_backing_file(
        donor_storage: Storage, d_off: int, storage: Storage, t_off: int
    ) -> bool:
        """True when both offsets resolve to the same on-disk file (an
        in-place BEP 39 update over the old torrent's directory) — a
        copy would just rewrite the file onto itself."""
        try:
            d_seg = next(iter(donor_storage.segments(d_off, 1)))
            t_seg = next(iter(storage.segments(t_off, 1)))
        except StopIteration:
            return False
        if d_seg[0] is None or t_seg[0] is None:
            return False  # BEP 47 pad span: nothing on disk to compare
        dm, tm = donor_storage.method, storage.method
        if dm is tm and d_seg[0] == t_seg[0]:
            return True
        if isinstance(dm, FsStorage) and isinstance(tm, FsStorage):
            try:
                import os

                return os.path.samefile(
                    dm._abspath(d_seg[0]), tm._abspath(t_seg[0])
                )
            except OSError:
                return False
        return False

    async def check_for_update(self, torrent: Torrent):
        """BEP 39: fetch the torrent's ``update-url``; a metainfo with a
        DIFFERENT infohash means an update exists (None = current, or no
        update-url). Delegates to module-level :func:`fetch_update` with
        the client's proxy so the poll never leaks the real IP."""
        return await fetch_update(torrent.metainfo, proxy=self.proxy)

    @staticmethod
    def _carry_selection(old: Torrent, new_meta) -> list[int] | None:
        """Map the old torrent's file selection onto the successor by
        relative path: a file the user deselected stays deselected if it
        reappears; new files default to wanted. None = no selection to
        carry (everything was wanted)."""
        if not any(p <= 0 for p in old.file_priorities.values()):
            return None

        def paths(info):
            if getattr(info, "files", None) is None:
                return [(info.name,)]
            return [tuple(fe.path) for fe in info.files]

        old_unwanted = {
            p
            for i, p in enumerate(paths(old.info))
            if old.file_priorities.get(i, 1) <= 0
        }
        new_info = getattr(new_meta, "info", new_meta)
        return [
            i for i, p in enumerate(paths(new_info)) if p not in old_unwanted
        ]

    async def apply_update(
        self,
        torrent: Torrent,
        new_meta: Metainfo | None = None,
        storage: Storage | StorageMethod | str | None = None,
        wanted_files: list[int] | None = None,
    ) -> Torrent | None:
        """BEP 39: switch to the updated torrent. Fetches the update when
        ``new_meta`` is None (returning None if already current), adds it
        with the old torrent as a BEP 38 adoption donor — unchanged files
        carry over without touching the swarm — then removes the old one.
        ``storage`` defaults to the old torrent's directory (in-place
        update) when it lives on the filesystem. The old torrent's file
        selection carries over by relative path (a deselected 100 GB file
        must not start downloading because the dataset was re-published);
        pass ``wanted_files`` to override."""
        if new_meta is None:
            new_meta = await self.check_for_update(torrent)
            if new_meta is None:
                return None
        if storage is None:
            method = torrent.storage.method
            if isinstance(method, FsStorage):
                storage = method.root
            else:
                raise ValueError(
                    "apply_update needs an explicit storage for non-filesystem torrents"
                )
        if wanted_files is None:
            wanted_files = self._carry_selection(torrent, new_meta)
        # Deregister + stop the predecessor BEFORE the successor starts:
        # the two share files in an in-place update, and a still-serving
        # old seed would hand out offsets the new download is rewriting
        # (peers would hash-fail those pieces and strike us). It stays
        # available as an adoption donor by reference; on a failed add it
        # is re-registered and restarted.
        await self.remove(torrent.metainfo.info_hash)
        try:
            new_torrent = await self.add(
                new_meta,
                storage,
                wanted_files=wanted_files,
                _adopt_from=(torrent,),
            )
        except BaseException:
            self.torrents[torrent.metainfo.info_hash] = torrent
            # remove() unregistered the predecessor from local-service
            # discovery; a rollback must restore that announcement too
            if self.lsd is not None and not torrent.private:
                self.lsd.register(torrent.metainfo.info_hash)
            await torrent.start()
            raise
        # successful switch: the predecessor's fastresume checkpoint is
        # stale forever (its info hash will never be added again here)
        if torrent.resume_store is not None:
            torrent.resume_store.delete(torrent.metainfo.info_hash)
        return new_torrent

    async def add_torrent_bytes(
        self,
        data: bytes,
        storage: "Storage | StorageMethod | str",
        require_signed: "tuple[str, bytes] | None" = None,
        wanted_files: "list[int] | None" = None,
    ) -> "Torrent":
        """Parse raw .torrent bytes (v1 OR pure v2) and ``add`` them —
        the library-level twin of the CLI's auto-detecting load path.

        ``require_signed = (signer, trusted_pub)`` applies the BEP 35
        gate on the RAW bytes before any parse result is trusted (the
        same check ``download/update/feed --require-signed`` run);
        refusal raises ValueError and nothing is registered.
        """
        if require_signed is not None:
            from torrent_tpu_torch.codec import signing

            signer, pub = require_signed
            signing.ensure_signed(data, signer, pub)
        from torrent_tpu_torch.codec.metainfo import parse_any_metainfo

        parsed = parse_any_metainfo(data)
        if parsed is None:
            raise ValueError("not a valid .torrent (neither v1 nor v2)")
        return await self.add(parsed[0], storage, wanted_files=wanted_files)

    async def add_hybrid(
        self, torrent_bytes: bytes, storage_dir: str
    ) -> "tuple[Torrent, Torrent]":
        """Register a BEP 52 hybrid torrent under BOTH its identities —
        the SHA-1 infohash (v1 swarm) and the truncated SHA-256 (v2
        swarm) — seeding/downloading the same directory. Returns
        ``(v1_torrent, v2_torrent)``.

        The v2 view's piece space is file-aligned while v1's is packed,
        but hybrids carry BEP 47 pad files that make the two byte layouts
        coincide on disk, so one directory serves both swarms.
        """
        from torrent_tpu_torch.codec.metainfo import parse_metainfo
        from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2

        m1 = parse_metainfo(torrent_bytes)
        m2 = parse_metainfo_v2(torrent_bytes)
        if m1 is None or m2 is None:
            raise ValueError("not a valid hybrid .torrent (needs both planes)")
        t1 = await self.add(m1, storage_dir)
        try:
            t2 = await self.add(m2, storage_dir)
        except BaseException:
            # all-or-nothing: a half-registered hybrid would leave the v1
            # identity silently announcing with no handle for the caller
            await self.remove(m1.info_hash)
            raise
        return t1, t2

    async def add_magnet(
        self, magnet, storage: Storage | StorageMethod | str
    ) -> Torrent:
        """Join a swarm from a magnet link (BEP 9/10 — reference roadmap
        README.md:39): fetch the info dict from peers, then ``add``.

        ``magnet`` is a ``codec.magnet.Magnet`` or a ``magnet:?...`` URI.
        """
        from torrent_tpu_torch.codec.magnet import Magnet, parse_magnet
        from torrent_tpu_torch.session.metadata import fetch_metadata

        if self.port is None:
            raise RuntimeError("Client.start() must be awaited before add_magnet()")
        if isinstance(magnet, str):
            magnet = parse_magnet(magnet)
        if not isinstance(magnet, Magnet):
            raise TypeError("magnet must be a Magnet or magnet URI string")
        if (
            magnet.mutable_key is not None
            and magnet.info_hash is None
            and magnet.info_hash_v2 is None
        ):
            # BEP 46: resolve the pointer first (no recursion — the
            # resolved magnet carries a concrete btih)
            return await self.add_mutable_magnet(magnet, storage)
        if magnet.wire_hash in self.torrents:
            raise ValueError("torrent already added")
        # Throwaway peer id for the metadata connections: if the fetch
        # socket's EOF hasn't been reaped by the seeder when the real
        # download dials in, our own id would trip its duplicate-peer
        # guard and the data connection would be dropped.
        metainfo = await fetch_metadata(
            magnet,
            peer_id=generate_peer_id(),
            port=self.external_port or self.port,
            dht=self.dht,
            ip_filter=self.ip_filter,
            proxy=self.proxy,
        )
        # BEP 53: the magnet's file selection is applied BEFORE the
        # torrent starts (out-of-range indices dropped — the selection
        # was minted against metadata the author may have mis-remembered;
        # an empty valid set means "download nothing yet")
        torrent = await self.add(
            metainfo,
            storage,
            wanted_files=list(magnet.select_only)
            if magnet.select_only is not None
            else None,
        )
        for ws in magnet.web_seeds:
            torrent.add_web_seed(ws)  # BEP 19 ws= params
        if magnet.peer_addrs:
            # Trackerless magnets (x.pe bootstrap): hand the known peers
            # straight to the scheduler instead of waiting on an announce.
            from torrent_tpu_torch.net.types import AnnouncePeer

            torrent._connect_new_peers(
                [AnnouncePeer(ip=h, port=p) for h, p in magnet.peer_addrs]
            )
        return torrent

    # ---------------------------------------------- BEP 46 mutable magnets

    async def resolve_mutable(self, magnet) -> bytes:
        """Resolve a BEP 46 ``btpk`` magnet to its CURRENT 20-byte
        infohash via the key's BEP 44 mutable item (``{"ih": <hash>}``).

        Raises ValueError when the magnet isn't mutable, the DHT is off,
        the item can't be found, or its payload is malformed.
        """
        import hashlib as _hashlib

        from torrent_tpu_torch.codec.magnet import Magnet, parse_magnet

        if isinstance(magnet, str):
            magnet = parse_magnet(magnet)
        if not isinstance(magnet, Magnet) or magnet.mutable_key is None:
            raise ValueError("not a mutable (urn:btpk) magnet")
        if self.dht is None:
            raise ValueError("mutable magnets need the DHT (enable_dht=True)")
        target = _hashlib.sha1(magnet.mutable_key + magnet.mutable_salt).digest()
        item = await self.dht.get_item(target, salt=magnet.mutable_salt)
        if item is None or item.seq is None:
            raise ValueError("mutable item not found in the DHT")
        v = item.value
        ih = v.get(b"ih") if isinstance(v, dict) else None
        if not isinstance(ih, bytes) or len(ih) != 20:
            raise ValueError("mutable item carries no valid 'ih' pointer")
        return ih

    async def add_mutable_magnet(
        self, magnet, storage: Storage | StorageMethod | str
    ) -> Torrent:
        """BEP 46: resolve the key's current infohash, then join that
        swarm like any magnet (metadata over ut_metadata, BEP 53/19
        params preserved)."""
        from dataclasses import replace

        from torrent_tpu_torch.codec.magnet import Magnet, parse_magnet

        if isinstance(magnet, str):
            magnet = parse_magnet(magnet)
        ih = await self.resolve_mutable(magnet)
        return await self.add_magnet(
            replace(magnet, info_hash=ih, mutable_key=None, mutable_salt=b""),
            storage,
        )

    async def publish_mutable(
        self, secret: bytes, info_hash: bytes, seq: int, salt: bytes = b""
    ) -> tuple[bytes, int]:
        """Publisher side of BEP 46: sign ``{"ih": info_hash}`` as the
        key's BEP 44 mutable item. Returns (dht_target, nodes_stored);
        the shareable URI is ``mutable_magnet_uri(publickey, salt)``.
        Bump ``seq`` on every new revision of the content."""
        if self.dht is None:
            raise ValueError("publishing needs the DHT (enable_dht=True)")
        if len(info_hash) != 20:
            raise ValueError("info_hash must be 20 bytes")
        return await self.dht.put_mutable(secret, {b"ih": info_hash}, seq, salt=salt)

    def status(self) -> dict:
        """Aggregate client observability: per-torrent status plus
        session-wide totals (SURVEY §5 'metrics' — the reference has no
        counters beyond never-updated announce fields, torrent.ts:66-69)."""
        torrents = {
            t.metainfo.info_hash.hex(): t.status() for t in self.torrents.values()
        }
        return {
            "port": self.port,
            "external_ip": self.external_ip,
            "dht": self.dht is not None,
            "lsd": self.lsd is not None,
            "peers": sum(len(t.peers) for t in self.torrents.values()),
            "downloaded": sum(t.downloaded for t in self.torrents.values()),
            "uploaded": sum(t.uploaded for t in self.torrents.values()),
            "upload_cap_bps": self.upload_bucket.rate,
            "download_cap_bps": self.download_bucket.rate,
            "torrents": torrents,
        }

    async def pause_all(self) -> None:
        """Suspend every torrent's transfers (connections kept)."""
        for t in list(self.torrents.values()):
            await t.pause()

    async def resume_all(self) -> None:
        for t in list(self.torrents.values()):
            await t.resume()

    async def remove(self, info_hash: bytes) -> None:
        torrent = self.torrents.pop(info_hash, None)
        if self.lsd is not None:
            self.lsd.unregister(info_hash)
        if torrent:
            await torrent.stop()

    # -------------------------------------------------------------- accept

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        """Inbound handshake: route on info hash before replying
        (client.ts:85-104).

        MSE/PE auto-detection (net/mse.py): a plaintext BT handshake
        starts with the 20-byte protocol header; anything else under an
        encryption-accepting policy is treated as an MSE initiator and
        answered with the obfuscated handshake, after which the BT
        handshake proceeds over the (possibly RC4) streams.
        """
        from torrent_tpu_torch.net import mse

        policy = self.config.torrent.encryption
        try:
            peername = writer.get_extra_info("peername")
            if (
                peername
                and self.ip_filter is not None
                and self.ip_filter.blocked(peername[0])
            ):
                writer.close()  # blocklisted: drop before reading ANY bytes
                return
            head = await asyncio.wait_for(reader.readexactly(20), timeout=15)
            if head == bytes([len(proto.PROTOCOL_STRING)]) + proto.PROTOCOL_STRING[:19]:
                if policy == "required":
                    writer.close()  # plaintext refused on sight
                    return
                # head IS the whole pstrlen+pstr header: finish phase 1
                # on the raw reader (no wrapper on the plaintext hot path)
                reserved = await asyncio.wait_for(reader.readexactly(8), timeout=15)
                info_hash = await asyncio.wait_for(reader.readexactly(20), timeout=15)
            else:
                if policy == "disabled":
                    writer.close()
                    return
                reader, writer, _skey, _sel = await asyncio.wait_for(
                    mse.respond(
                        reader,
                        writer,
                        head,
                        list(self.torrents.keys()),
                        allow_plaintext=policy != "required",
                    ),
                    timeout=15,
                )
                info_hash, reserved = await asyncio.wait_for(
                    proto.read_handshake_head(reader), timeout=15
                )
            torrent = self.torrents.get(info_hash)
            if torrent is None:
                writer.close()  # unknown torrent: drop pre-reply
                return
            from torrent_tpu_torch.net.extension import extension_reserved

            await proto.send_handshake(
                writer,
                info_hash,
                self.config.peer_id,
                proto.merge_reserved(extension_reserved(), proto.fast_reserved()),
            )
            peer_id = await asyncio.wait_for(proto.read_handshake_peer_id(reader), timeout=15)
            if peer_id == self.config.peer_id:
                writer.close()
                return
            addr = writer.get_extra_info("peername")
            from torrent_tpu_torch.net.types import normalize_peer_host

            await torrent.add_peer(
                peer_id,
                reader,
                writer,
                # dual-stack listeners report v4 peers as ::ffff:a.b.c.d;
                # one canonical form keeps dial dedup and PEX routing sane
                address=(normalize_peer_host(addr[0]), addr[1]) if addr else None,
                reserved=reserved,
                inbound=True,
            )
        except (
            proto.ProtocolError,
            mse.MseError,
            asyncio.TimeoutError,
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
        ):
            writer.close()


async def fetch_update(metainfo, proxy=None, raw_bytes_out: list | None = None):
    """BEP 39 poll, usable without a running Client (the CLI's `update`).

    Fetches ``metainfo.update_url`` (http/https only — the URL is
    untrusted metainfo content, same SSRF stance as webseeds; the body
    size-caps WHILE streaming) and returns the successor's parsed
    metainfo — ``Metainfo`` or ``MetainfoV2`` — or None when there is no
    update-url or the served torrent has the same infohash. Passing
    ``raw_bytes_out`` collects the fetched .torrent bytes (so a caller
    can write the successor to disk verbatim).
    """
    url = getattr(metainfo, "update_url", None)
    if not url:
        return None
    import urllib.parse

    if urllib.parse.urlsplit(url).scheme not in ("http", "https"):
        raise ValueError(f"refusing non-http(s) update-url {url!r}")
    from torrent_tpu_torch.net.tracker import _http_get

    raw = await _http_get(url, timeout=30, proxy=proxy, max_bytes=16 << 20)
    from torrent_tpu_torch.codec.metainfo import parse_any_metainfo

    parsed = parse_any_metainfo(raw)
    if parsed is None:
        raise ValueError("update-url did not serve a valid .torrent")
    new_meta, new_hash = parsed
    if new_hash == metainfo.info_hash:
        return None
    if raw_bytes_out is not None:
        raw_bytes_out.append(raw)
    return new_meta
