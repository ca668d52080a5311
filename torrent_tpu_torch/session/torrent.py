"""Torrent session: announce loop, peer loops, scheduler (ref L6: torrent.ts).

The reference's torrent.ts stops at message handling — no piece picker,
no choke policy, no verification, bitfield never updated (SURVEY §8.3).
This is the completed design:

- **announce loop** (torrent.ts:224-244): started/empty/completed events,
  cancellable interval sleep with early wake (``request_peers``), live
  uploaded/downloaded/left counters.
- **scheduler**: rarest-first piece picking over peer availability with
  random tie-break, per-peer request pipelining, endgame mode (duplicate
  the last in-flight blocks, cancel on arrival).
- **choke policy**: periodic round unchoking the top downloaders plus one
  optimistic random peer (BEP 3 semantics).
- **verification hook** (the gap at torrent.ts:183-193): pieces assemble
  in memory, SHA-1-verify in batches on the GPU's hash plane (or with
  hashlib off-thread when ``hasher="cpu"``), and only verified pieces
  are written + ``have``-broadcast.
- **resume-recheck**: ``start()`` runs ``verify_pieces`` (hasher
  'gpu'|'cpu') to rebuild the bitfield before announcing — the subsystem
  the reference lists as roadmap (README.md:34) and the BASELINE north
  star.

The port of the JAX package's session, with these differences: the
hasher is ``"gpu"`` (the default, on ``device``; None means CUDA) or
``"cpu"``; with ``"gpu"`` and no shared verifier the torrent builds its
own ``GPUVerifier``, so a finished piece is never hashed with hashlib;
and a device error in an ingest batch reaches the pieces' waiters as
the error itself, never as a hashlib verdict.
"""

from __future__ import annotations

import asyncio
import errno
import hashlib
import random
import time
from collections import Counter
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from torrent_tpu_torch.codec.metainfo import Metainfo
from torrent_tpu_torch.net import extension as ext
from torrent_tpu_torch.net import protocol as proto
from torrent_tpu_torch.net.constants import DEFAULT_NUM_WANT
from torrent_tpu_torch.net.tracker import TrackerError
from torrent_tpu_torch.net.types import AnnounceEvent, AnnounceInfo
from torrent_tpu_torch.obs.ledger import pipeline_ledger
from torrent_tpu_torch.obs.swarm import swarm_telemetry
from torrent_tpu_torch.session.peer import PeerConnection
from torrent_tpu_torch.storage.piece import (
    BLOCK_SIZE,
    piece_length,
    validate_received_block,
    validate_requested_block,
)
from torrent_tpu_torch.storage.storage import Storage, StorageError
from torrent_tpu_torch.utils.bitfield import Bitfield
from torrent_tpu_torch.utils.ratelimit import TokenBucket
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("session.torrent")

_UNSET = object()  # lazy-field sentinel (None is a meaningful value)

# recv-stage ledger batching: socket-wait seconds and landed block bytes
# flush to the pipeline ledger once per this many events (or 250 ms of
# accumulated wait), so the per-message hot path never takes an obs lock
_RECV_FLUSH_OPS = 32
_RECV_FLUSH_S = 0.25

# failure-detection cardinality caps: both tables key on peer IP, which
# an attacker mints freely — strike/ban state must churn at capacity,
# never grow for the life of the session
MAX_CORRUPTION_IPS = 8192
MAX_BANNED_IPS = 4096


def _wire_payload_bytes(msg) -> int:
    """Payload byte count of a decoded wire message for the per-kind
    telemetry (the variable-length fields; fixed headers are noise)."""
    block = getattr(msg, "block", None)
    if block is not None:
        return len(block)
    raw = getattr(msg, "raw", None)
    if raw is not None:
        return len(raw)
    payload = getattr(msg, "payload", None)
    if payload is not None:
        return len(payload)
    return 0


class TorrentState(Enum):
    """(torrent.ts:39-43 — which the reference never advances, §8.3)."""

    STOPPED = "stopped"
    CHECKING = "checking"
    DOWNLOADING = "downloading"
    SEEDING = "seeding"


class AcceptGate:
    """Admission + idle-reclamation bookkeeping for the accept path:
    ``capacity`` slots, a slot's holder evicted once idle for
    ``idle_after`` units of the caller's clock. This is the defense
    slowloris probes — connections that never make progress must be
    reclaimed, not held forever.

    Clock-agnostic on purpose: the live session feeds it monotonic
    seconds (``idle_after`` = ``peer_timeout``) while the scenario
    plane (``scenario/actors.py``) drives the SAME class with virtual
    ticks, so the chaos suite exercises exactly the eviction policy
    production runs."""

    def __init__(self, capacity: int, idle_after: float, per_ip: int = 0):
        self.capacity = capacity
        self.idle_after = idle_after
        # per-address admission clamp (0 = off): a stampede from one
        # address — NAT abuse or a sybil fleet — can hold at most this
        # many slots, leaving the rest for the crowd
        self.per_ip = int(per_ip)
        self.slots: dict = {}  # key -> last activity instant
        self._ips: dict = {}  # key -> admitting address
        self._ip_counts: dict = {}  # address -> live slots
        self.evicted_idle = 0
        self.rejected_per_ip = 0
        self.rejected_capacity = 0
        # why the latest connect() returned False ("per_ip"/"capacity")
        self.last_reject: str | None = None

    def connect(self, key, now, ip=None) -> bool:
        """Admit (or refresh) ``key``; False when every slot is held or
        ``ip`` already holds :attr:`per_ip` slots."""
        if key in self.slots:
            self.slots[key] = now
            return True
        if (
            self.per_ip > 0
            and ip is not None
            and self._ip_counts.get(ip, 0) >= self.per_ip
        ):
            self.rejected_per_ip += 1
            self.last_reject = "per_ip"
            return False
        if len(self.slots) >= self.capacity:
            self.rejected_capacity += 1
            self.last_reject = "capacity"
            return False
        self.slots[key] = now
        if ip is not None:
            self._ips[key] = ip
            # one entry per admitting address of a LIVE slot (released in
            # _forget_ip): cardinality ≤ the slot capacity checked above
            self._ip_counts[ip] = self._ip_counts.get(ip, 0) + 1  # bounded-by: capacity
        return True

    def touch(self, key, now) -> None:
        """Record activity for an already-admitted key (no-op for
        unknown keys: the caller's peer map is authoritative)."""
        if key in self.slots:
            self.slots[key] = now

    def _forget_ip(self, key) -> None:
        ip = self._ips.pop(key, None)
        if ip is not None:
            left = self._ip_counts.get(ip, 0) - 1
            if left > 0:
                self._ip_counts[ip] = left
            else:
                self._ip_counts.pop(ip, None)

    def release(self, key) -> None:
        self.slots.pop(key, None)
        self._forget_ip(key)

    def sweep(self, now) -> list:
        """Evict every slot idle past ``idle_after``; returns the
        evicted keys (admission order — dict order is deterministic)."""
        dead = [
            k for k, last in self.slots.items()
            if now - last >= self.idle_after
        ]
        for k in dead:
            del self.slots[k]
            self._forget_ip(k)
        self.evicted_idle += len(dead)
        return dead


@dataclass
class _PartialPiece:
    """A piece being assembled in memory before verification."""

    index: int
    length: int
    buffer: bytearray
    received: set[int] = field(default_factory=set)  # block offsets
    # (peer_id, ip) of every block contributor — corruption accounting
    # must survive the contributor disconnecting, so the IP rides along
    contributors: set[tuple[bytes, str | None]] = field(default_factory=set)
    # Reserved by a webseed fetch: the block scheduler must not hand this
    # piece to peers (they'd race the HTTP fetch), except in endgame.
    webseed: bool = False

    @property
    def complete(self) -> bool:
        return len(self.received) * BLOCK_SIZE >= self.length


@dataclass
class TorrentConfig:
    max_peers: int = 50
    pipeline_depth: int = 16  # outstanding requests per peer
    max_corrupt_pieces: int = 3  # hash failures before a peer is banned
    unchoke_slots: int = 3  # + 1 optimistic
    choke_interval: float = 10.0
    snub_timeout: float = 30.0  # no block for this long → free its requests
    keepalive_interval: float = 100.0
    peer_timeout: float = 240.0
    # Slot recycling: when the peer list is full, a NEW connection may
    # evict a mutually-uninterested idle peer (nothing in flight either
    # way) that has been connected at least this long — a swarm larger
    # than max_peers must rotate through the slots, not starve. The
    # grace keeps fresh connections from being evicted before they can
    # express interest (and bounds eviction thrash).
    evict_grace: float = 15.0
    announce_retry: float = 30.0
    hasher: str = "gpu"  # 'gpu' | 'cpu' — resume-recheck + batch verify
    # the card the "gpu" hasher runs on: None means CUDA (and raises on a
    # host without it); "cpu" runs the plain PyTorch versions of the kernels
    device: str | None = None
    verify_batch_size: int = 256
    # Shared hash-plane scheduler (torrent_tpu_torch.sched.HashPlaneScheduler).
    # When set, resume/self-heal rechecks ride the shared verify queue as
    # the low-priority "selfheal" tenant (DRR weight below) instead of
    # dispatching their own device batches — swarm background traffic can
    # never starve a foreground CLI verify or bridge client.
    scheduler: object | None = None
    selfheal_weight: float = 0.25
    dht_interval: float = 300.0  # DHT announce/lookup cadence
    pex_interval: float = 60.0  # BEP 11 peer-exchange cadence
    webseed_retry: float = 15.0  # backoff after a webseed failure
    # In-order piece picking for streaming/preview playback (rarest-first
    # otherwise; file priorities still outrank the order either way)
    sequential: bool = False
    # Whole pieces cached on the serve path (LRU): a piece is requested
    # as 16+ sequential blocks, so this turns 16 preads into 1. Memory
    # cost = serve_cache_pieces * piece_length PER TORRENT; the cache
    # disables itself for pieces over serve_cache_max_piece (whole-piece
    # reads would be 1000x amplification for one-block fetches there)
    serve_cache_pieces: int = 8
    serve_cache_max_piece: int = 2 * 1024 * 1024
    webseed_concurrency: int = 2  # parallel piece fetches per webseed
    webseed_max_failures: int = 5  # consecutive bad pieces → URL disabled
    # BEP 16 super-seeding: reveal pieces one-by-one via targeted Haves
    # and advance only when ANOTHER peer echoes the piece back — the
    # initial seed uploads ≈1 copy instead of N partial copies
    super_seed: bool = False
    super_seed_outstanding: int = 2  # unconfirmed pieces per peer
    # MSE/PE protocol encryption (net/mse.py): 'disabled' = plaintext
    # only; 'enabled' = accept both inbound, dial plaintext first with an
    # encrypted retry (interops with encryption-requiring peers);
    # 'required' = RC4 only, both directions
    encryption: str = "enabled"
    # Per-torrent transfer caps in bytes/s (0 = unlimited), layered
    # UNDER the client-global buckets: a transfer waits on both, so the
    # tighter of the two limits wins
    max_upload_bps: int = 0
    max_download_bps: int = 0
    # ---- serve plane (torrent_tpu_torch/serve_plane/) -----------------------
    # AcceptGate per-address admission clamp (0 = off): a stampede from
    # one address can hold at most this many slots. Off by default —
    # loopback test rigs and NATed swarms legitimately share addresses.
    per_ip_limit: int = 0
    # reactor pool: worker count, per-peer pending-request bound (past
    # it the session answers BEP 6 rejects — bounded hostile demand),
    # and requests drained per peer per turn (round-robin fairness)
    serve_reactor_workers: int = 4
    serve_queue_depth: int = 64
    serve_batch: int = 8
    # DRR choke-economics quantum: deficit bytes a weight-1.0 candidate
    # accrues per unchoke round (one 16 KiB block by default)
    choke_quantum: int = 16384

    def __post_init__(self):
        if self.encryption not in ("disabled", "enabled", "required"):
            raise ValueError(
                f"encryption must be disabled|enabled|required, got {self.encryption!r}"
            )


# Piece sizes at or below this run their hash/pread/pwrite INLINE on the
# event loop instead of via asyncio.to_thread: a thread hop costs ~0.5-2 ms
# of scheduling latency while sha1/pread of 64 KiB is tens of µs — for
# small-piece torrents the hops dominate end-to-end throughput (measured:
# 4 KiB-piece swarms went from ~150 to >1000 pieces/s aggregate).
INLINE_IO_MAX = 64 * 1024


class Torrent:
    def __init__(
        self,
        metainfo: Metainfo,
        storage: Storage,
        peer_id: bytes,
        port: int,
        config: TorrentConfig | None = None,
        verifier=None,  # optional GPUVerifier to share across torrents
        resume_store=None,  # optional session/resume.py store
        dht=None,  # optional net.dht.DHTNode for trackerless discovery
        upload_bucket=None,  # optional utils/ratelimit.TokenBucket (client-global)
        download_bucket=None,
        external_ip=None,  # our public address, for BEP 40 dial ordering
        utp_dial=None,  # optional BEP 29 dialer: async (host, port) -> streams
        ip_filter=None,  # optional net.ipfilter.IpFilter (client-global)
        proxy=None,  # optional net.socks.ProxySpec: TCP dials + HTTP trackers
        dns_prefs=None,  # optional net.dnsprefs.TrackerPrefs (BEP 34)
    ):
        from torrent_tpu_torch.net.multitracker import TrackerList, parse_announce_list

        self.metainfo = metainfo
        self.info = metainfo.info
        self.storage = storage
        self.peer_id = peer_id
        self.port = port
        self.config = config or TorrentConfig()
        self.verifier = verifier
        self.resume_store = resume_store
        self.dht = dht
        self.upload_bucket = upload_bucket
        self.download_bucket = download_bucket
        # per-torrent caps layered under the client-global buckets
        self.own_upload_bucket = TokenBucket(self.config.max_upload_bps)
        self.own_download_bucket = TokenBucket(self.config.max_download_bps)
        self.external_ip = external_ip
        # a CONNECT proxy cannot carry uTP datagrams; racing uTP beside
        # it would leak the peer address around the tunnel
        self._utp_dial = utp_dial if proxy is None else None
        self.ip_filter = ip_filter
        self.proxy = proxy
        self.trackers = TrackerList(
            metainfo.announce,
            parse_announce_list(metainfo.raw),
            proxy=proxy,
            dns_prefs=dns_prefs,
        )

        # BEP 52 pure-v2 torrent (session/v2.py): 32-byte merkle piece
        # digests, file-aligned piece space, truncated-sha256 wire hash
        self.v2 = getattr(self.info, "v2", False)
        # BEP 16 super-seeding state (lazily sized on first assignment)
        self._ss_active = bool(self.config.super_seed)
        self._ss_spread: np.ndarray | None = None  # bool[n]: echoed back
        self._ss_assigned: np.ndarray | None = None  # int32[n]: live grants
        self.state = TorrentState.STOPPED
        self.bitfield = Bitfield(self.info.num_pieces)
        self.peers: dict[bytes, PeerConnection] = {}
        # slot admission + slowloris idle-reclamation bookkeeping; the
        # peers dict stays authoritative — the gate mirrors it so the
        # eviction policy (and its counter) is the same object the
        # scenario plane attacks
        self._accept_gate = AcceptGate(
            self.config.max_peers,
            self.config.peer_timeout,
            per_ip=self.config.per_ip_limit,
        )
        self._partials: dict[int, _PartialPiece] = {}
        # GPU ingest-verification micro-batching (see _verify_piece_data)
        self._verify_pending: list = []
        self._verify_flushing = False
        self._tasks: set[asyncio.Task] = set()
        # one live fetch loop per webseed/httpseed URL (see
        # _spawn_seed_loops re-entrancy)
        self._seed_loop_tasks: dict[str, asyncio.Task] = {}
        self._wake = asyncio.Event()
        self._stopping = False
        self._endgame = False
        self._pending_completed = False  # BEP 3 `completed` owed to tracker
        self._completed_reported = False  # latch: `completed` sent at most once
        self._dialing: set[tuple[str, int]] = set()
        # Failure detection: corruption strikes accumulate per IP (so a
        # poisoner can't evade by cycling connections) and decay when a
        # piece the address contributed to verifies (so honest peers that
        # co-contributed with a poisoner shed the suspicion). At the
        # threshold the address is banned for the session.
        self._corruption: Counter = Counter()  # ip -> strikes
        self._banned: dict[str, None] = {}  # by IP, insertion-ordered
        # Incremental scheduler state: per-piece availability counts, a
        # rarity-ordered pick queue (rebuilt lazily when dirty), and a
        # multiset of blocks in flight across all peers — keeps block
        # ingest O(1)-ish instead of rescanning every peer bitfield.
        self._avail = np.zeros(self.info.num_pieces, dtype=np.int32)
        self._rarity_order: list[int] = []
        # Per-piece download priority (no reference counterpart — the
        # reference downloads everything or nothing). 0 = skip, higher =
        # sooner; derived from per-file priorities via set_file_priorities.
        self._piece_priority = np.ones(self.info.num_pieces, dtype=np.int8)
        # effective per-file priorities (empty until a selection is set:
        # everything wanted at the default 1)
        self.file_priorities: dict[int, int] = {}
        # streaming: pre-boost priority snapshot, active reader windows
        # (token -> (first_piece, n)), and per-piece completion events
        # for parked readers (created on demand, popped on set)
        self._stream_base: np.ndarray | None = None
        self._stream_positions: dict[object, tuple[int, int]] = {}
        self._piece_events: dict[int, asyncio.Event] = {}
        # last persisted partial set (serialized form) — carried forward
        # by periodic checkpoints until the pieces complete
        self._saved_partials: dict[int, tuple[bytes, bytes]] = {}
        # selection updates serialize (they suspend for the partfile
        # sweep; interleaving would desync priorities from routing)
        self._selection_lock = asyncio.Lock()
        # cached count of wanted-but-missing pieces: _fill_pipeline gates
        # on it per block, so it must be O(1) there (the numpy recount
        # runs only on selection changes and recheck/resume)
        self._wanted_missing = self.info.num_pieces
        # paused: transfers suspended, connections and state kept alive
        self.paused = False
        from torrent_tpu_torch.session.webseed import allowed_url as _ws_allowed

        # BEP 19 webseed URLs: the metainfo's url-list plus any added at
        # runtime (magnet ws= params arrive after construction). Both
        # sources are untrusted — only http/https survive. Under a SOCKS5
        # proxy, webseeds are refused wholesale (add_web_seed mirrors
        # this): their urllib fetches would dial around the tunnel.
        self.web_seed_urls: list[str] = (
            [] if proxy is not None
            else [u for u in metainfo.web_seeds if _ws_allowed(u)]
        )
        # BEP 17 httpseeds (piece-keyed GETs) ride the same loop with a
        # different fetcher; same untrusted-URL and proxy-leak guards
        self.http_seed_urls: list[str] = (
            [] if proxy is not None
            else [u for u in metainfo.http_seeds if _ws_allowed(u)]
        )
        if proxy is not None and (metainfo.web_seeds or metainfo.http_seeds):
            log.warning(
                "%d metainfo web/http seed(s) disabled: SOCKS5 proxy configured",
                len(metainfo.web_seeds) + len(metainfo.http_seeds),
            )
        # serve-path LRU of whole pieces (dict ordering = recency) and
        # in-flight reads shared by concurrent misses on the same piece
        self._serve_cache: dict[int, bytes] = {}
        self._serve_pending: dict[int, asyncio.Future] = {}
        self._rarity_dirty = True
        self._inflight_count: Counter = Counter()
        self._piece_inflight: Counter = Counter()  # per-piece mirror

        # Serialized info dict for BEP 9 metadata serving — byte-exact
        # re-encode of the decoded dict (decode preserves key order, so
        # sha1(info_bytes) == info_hash).
        self._info_bytes: bytes | None = None
        # BEP 52 merkle layer cache (hybrid torrents), built on first use
        self._hash_cache = _UNSET
        # outstanding layer fetches: request fields -> Future[hashes|None];
        # the lock serializes whole fetch_v2_layers runs (concurrent runs
        # would clobber each other's pending futures)
        self._hash_fetches: dict[tuple, asyncio.Future] = {}
        self._fetch_layers_lock = asyncio.Lock()

        # live announce counters (fixed vs torrent.ts:66-69 which never
        # updates them)
        self.uploaded = 0
        self.downloaded = 0
        # random per-session announce key (torrent.ts:62-74)
        self.key = random.randbytes(4)

        self.on_complete: asyncio.Event = asyncio.Event()

        # Swarm wire-plane observability (obs/swarm): the process-global
        # bounded per-peer telemetry registry, plus a deterministic
        # per-torrent trace id so connection lifecycle spans of one
        # swarm share one trace (`GET /v1/trace?id=swarm-<ih12>`).
        self._swarm_obs = swarm_telemetry()
        self._swarm_trace = f"swarm-{metainfo.info_hash.hex()[:12]}"
        # recv-stage accumulator (flushed in batches — see _recv_charge)
        self._recv_s = 0.0
        self._recv_bytes = 0
        self._recv_ops = 0

        # The crowd seeder plane (torrent_tpu_torch/serve_plane/): bounded
        # reactor multiplexing peer request queues, zero-copy block
        # egress, and DRR choke economics — one set per torrent, all
        # feeding the process-global serve telemetry registry.
        from torrent_tpu_torch.serve_plane.choke import ChokeEconomics
        from torrent_tpu_torch.serve_plane.egress import EgressEngine
        from torrent_tpu_torch.serve_plane.reactor import ReactorPool
        from torrent_tpu_torch.serve_plane.telemetry import serve_telemetry

        self._serve_obs = serve_telemetry()
        self._egress = EgressEngine(storage, telemetry=self._serve_obs)
        self._serve_reactor = ReactorPool(
            self._reactor_serve,
            workers=self.config.serve_reactor_workers,
            per_peer_queue=self.config.serve_queue_depth,
            batch=self.config.serve_batch,
        )
        # deterministic per-torrent seed: the optimistic-slot rotation
        # replays identically for one info-hash (scenario discipline)
        self._serve_econ = ChokeEconomics(
            slots=self.config.unchoke_slots,
            quantum=self.config.choke_quantum,
            seed=int.from_bytes(metainfo.info_hash[:8], "big"),
        )
        # egress-stage ledger accumulator (flushed in batches, the
        # _recv_charge discipline — see _egress_charge)
        self._egress_s = 0.0
        self._egress_bytes = 0
        self._egress_ops = 0

    # ----------------------------------------------------------- lifecycle

    @property
    def private(self) -> bool:
        """BEP 27: the info dict's ``private`` flag (part of the infohash).

        Private torrents must not use DHT, PEX, or any peer source other
        than their own trackers.
        """
        info_raw = self.metainfo.raw.get(b"info")
        return isinstance(info_raw, dict) and info_raw.get(b"private") == 1

    @property
    def left(self) -> int:
        """Bytes still to download, counting only *wanted* pieces.

        One vectorized pass over the bool masks (a 100k-piece torrent is
        a 100 KB numpy op — no Python per-piece loop); with everything
        wanted (the default) this equals the whole-torrent remainder.
        """
        n = self.info.num_pieces
        if n == 0:
            return 0
        missing = (~self.bitfield.as_numpy()) & (self._piece_priority > 0)
        sizes = getattr(self.info, "piece_sizes", None)
        if sizes is not None:
            # v2 piece space: every file's last piece may be short
            return int(np.asarray(sizes)[missing].sum())
        left = int(missing.sum()) * self.info.piece_length
        if missing[n - 1]:
            left -= n * self.info.piece_length - self.info.length  # short tail
        return max(0, left)

    # ------------------------------------------------------ file selection

    def file_ranges(self) -> list[tuple[int, int]]:
        """Per-file ``(global_offset, length)`` spans, single- or multi-file."""
        if self.info.files is None:
            return [(0, self.info.length)]
        aligned = getattr(self.info, "piece_aligned", False)
        plen = self.info.piece_length
        out, pos = [], 0
        for fe in self.info.files:
            out.append((pos, fe.length))
            pos += -(-fe.length // plen) * plen if aligned else fe.length
        return out

    async def set_file_priorities(self, priorities: dict[int, int]) -> None:
        """Per-file download priorities: 0 = skip, higher = sooner.

        A piece overlapping any wanted file stays wanted (boundary pieces
        take the max priority of the files they touch — skipping them
        would corrupt the neighbouring wanted file). Files not named keep
        priority 1; BEP 47 pad entries are always priority 0 (their bytes
        are zeros — they must never keep a piece wanted on their own).
        Takes effect immediately: interest and pipelines are re-evaluated
        for every connected peer.
        """
        ranges = self.file_ranges()
        for idx, p in priorities.items():
            if not 0 <= idx < len(ranges):
                raise IndexError(f"no file #{idx} (torrent has {len(ranges)})")
            if not 0 <= int(p) <= 127:
                raise ValueError(f"priority {p} for file #{idx}: must be 0..127")
        # Serialized: the body suspends (partfile sweep in a thread), and
        # interleaved calls could otherwise leave the priority array from
        # one selection with the storage routing of another.
        async with self._selection_lock:
            await self._apply_file_priorities(priorities, ranges)

    async def _apply_file_priorities(self, priorities: dict[int, int], ranges) -> None:
        # the effective full mapping (unnamed files reset to 1 — this is
        # a whole-selection replacement API); BEP 39 apply_update reads
        # it to carry a selection across to the successor torrent
        self.file_priorities = {
            i: int(priorities.get(i, 1)) for i in range(len(ranges))
        }
        plen = self.info.piece_length
        entries = self.info.files or ()
        prio = np.zeros(self.info.num_pieces, dtype=np.int8)
        unwanted_files = set()
        for i, (start, length) in enumerate(ranges):
            if i < len(entries) and getattr(entries[i], "pad", False):
                continue  # pad spans never drive wanting (nor partfiles)
            p = int(priorities.get(i, 1))
            if p <= 0:
                unwanted_files.add(i)
            if length == 0 or p <= 0:
                continue
            first, last = start // plen, (start + length - 1) // plen
            np.maximum(prio[first : last + 1], p, out=prio[first : last + 1])
        self._piece_priority = prio
        # partfile routing: deselected files' boundary spill goes to the
        # hidden parts mirror; files (re-)entering the selection are
        # promoted back into place (no-op for memory backends). Off the
        # event loop: the promote sweep stats every file once.
        await asyncio.to_thread(self.storage.set_unwanted_files, unwanted_files)
        # a new selection invalidates the boost snapshot; active reader
        # windows re-apply over the new mask, and parked readers re-check
        # (a newly-deselected piece must raise, not hang)
        self._stream_base = None
        if self._stream_positions:
            self._apply_stream_windows()
        self._wake_all_waiters()
        self._recount_wanted()
        self._rarity_dirty = True
        if (
            self.state == TorrentState.SEEDING
            and self._wanted_remaining()
            and not self._stopping
        ):
            # widening a satisfied selection re-opens the download: the
            # completion latch resets, the webseed loops (which exit when
            # nothing is wanted) are respawned, and the announce loop is
            # woken — a peerless torrent must not sit out a full tracker
            # interval before discovering anyone to fetch from
            self.state = TorrentState.DOWNLOADING
            self.on_complete.clear()
            self._spawn_seed_loops()
            self.request_peers()
        for peer in list(self.peers.values()):
            try:
                await self._update_interest(peer)
            except (ConnectionError, OSError):
                pass
        await self._maybe_completed()

    async def select_files(self, wanted: list[int]) -> None:
        """Download only the named file indices (sugar over priorities)."""
        ranges = self.file_ranges()
        want = set(wanted)
        unknown = want - set(range(len(ranges)))
        if unknown:
            raise IndexError(
                f"no file #{min(unknown)} (torrent has {len(ranges)})"
            )
        await self.set_file_priorities(
            {i: (1 if i in want else 0) for i in range(len(ranges))}
        )

    # ------------------------------------------------------------ streaming

    def _notify_piece(self, index: int) -> None:
        ev = self._piece_events.pop(index, None)
        if ev is not None:
            ev.set()

    def _notify_present_pieces(self) -> None:
        """Wake waiters after a BULK bitfield update (recheck adopting a
        fresh array, fastresume replacing it wholesale) — per-piece
        completion goes through _finish_piece → _notify_piece."""
        for index in [i for i in self._piece_events if self.bitfield.has(i)]:
            self._notify_piece(index)

    async def wait_piece(self, index: int) -> None:
        """Block until piece ``index`` is verified on disk (streaming
        readers park here while the scheduler fetches ahead of them).

        Raises instead of parking forever when the piece became
        unreachable: RuntimeError once the torrent is stopping,
        LookupError when the piece is deselected (priority 0) — both
        re-checked every wake, and stop()/set_file_priorities wake all
        parked waiters precisely so these fire."""
        if not 0 <= index < self.info.num_pieces:
            raise IndexError(f"piece {index} out of range")
        while not self.bitfield.has(index):
            if self._stopping:
                raise RuntimeError("torrent stopped while waiting for a piece")
            if self._piece_priority[index] <= 0:
                raise LookupError(f"piece {index} is not scheduled (deselected)")
            ev = self._piece_events.get(index)
            if ev is None:
                ev = self._piece_events[index] = asyncio.Event()
            await ev.wait()

    def _wake_all_waiters(self) -> None:
        """Set (and drop) every parked piece event so waiters re-check
        their abort conditions — completion still only comes from the
        bitfield check in wait_piece's loop."""
        events = list(self._piece_events.values())
        self._piece_events.clear()
        for ev in events:
            ev.set()

    def span_servable(self, start: int, length: int) -> bool:
        """True when every piece of byte span [start, start+length) is
        on disk already or wanted (priority > 0) — the condition under
        which a stream reader is guaranteed to eventually be served."""
        if length <= 0:
            return False
        plen = self.info.piece_length
        first, last = start // plen, (start + length - 1) // plen
        base = self._stream_base if self._stream_base is not None else self._piece_priority
        missing = ~self.bitfield.as_numpy()[first : last + 1]
        return not bool(np.any(missing & (base[first : last + 1] <= 0)))

    def set_stream_window(
        self, offset: int, window_pieces: int = 8, token: object = "default"
    ) -> None:
        """Point the scheduler at a reader position: the next
        ``window_pieces`` pieces from ``offset`` (including any already
        on disk — the window is positional) jump to maximum priority
        (127), and pieces the reader moved past fall back to their
        pre-boost priority. Random seeks (HTTP Range requests) re-point
        the window instantly; deselected (priority-0) pieces are never
        boosted — streaming doesn't widen the selection.

        ``token`` names the reader: concurrent readers (players open a
        head and a tail connection at once) each hold a window and the
        boost is their union, so one reader's chunk cadence can't wipe
        the other's read-ahead. No-op when the token's window start
        hasn't moved (the array rewrite is O(pieces)).
        """
        plen = self.info.piece_length
        first = min(max(0, offset // plen), self.info.num_pieces - 1)
        prev = self._stream_positions.get(token)
        if prev == (first, window_pieces):
            return
        self._stream_positions[token] = (first, window_pieces)
        if self._stream_base is None or prev is None:
            self._apply_stream_windows()
            return
        # Steady-state window advance: O(window) delta — restore pieces
        # the window left (unless another reader still covers them),
        # boost the newly-entered ones. No rarity rebuild: the picker
        # consults stream windows directly, so priority-array lag only
        # affects the (eventual) background ordering.
        old = set(range(prev[0], min(prev[0] + prev[1], self.info.num_pieces)))
        new = set(range(first, min(first + window_pieces, self.info.num_pieces)))
        still = set()
        for f, n in self._stream_positions.values():
            still.update(range(f, min(f + n, self.info.num_pieces)))
        for i in old - new - still:
            self._piece_priority[i] = self._stream_base[i]
        for i in new - old:
            if self._stream_base[i] > 0:
                self._piece_priority[i] = np.int8(127)

    def clear_stream_window(self, token: object = None) -> None:
        """Drop one reader's window (``token``) or, with None, all."""
        if token is None:
            if not self._stream_positions:
                return
            self._stream_positions.clear()
        elif self._stream_positions.pop(token, None) is None:
            return
        self._apply_stream_windows()

    def _apply_stream_windows(self) -> None:
        """Full restore + reapply (token add/remove, selection change) —
        window ADVANCES take the O(window) delta path in
        set_stream_window instead."""
        if self._stream_base is None:
            self._stream_base = self._piece_priority.copy()
        else:
            np.copyto(self._piece_priority, self._stream_base)
        for first, window_pieces in self._stream_positions.values():
            window = self._piece_priority[first : first + window_pieces]
            np.copyto(window, np.where(window > 0, np.int8(127), window))
        if not self._stream_positions:
            self._stream_base = None
        self._rarity_dirty = True

    def _wanted_remaining(self) -> int:
        """Count of wanted pieces not yet verified on disk (cached)."""
        return self._wanted_missing

    def _recount_wanted(self) -> None:
        prev = getattr(self, "_wanted_missing", 0)
        self._wanted_missing = int(
            ((~self.bitfield.as_numpy()) & (self._piece_priority > 0)).sum()
        )
        if (
            self._endgame
            and self._wanted_missing > prev
            and self._wanted_missing > self._tail_threshold()
        ):
            # wants GREW mid-endgame (piece lost, selection widened):
            # this is no longer a tail — duplication would flood.
            # Outstanding duplicates still cancel on arrival: the cancel
            # broadcast keys on remaining in-flight copies, not on the
            # endgame flag.
            self._endgame = False

    def _tail_threshold(self) -> int:
        """Wanted-piece count at or below which endgame duplication is
        worth its cancel traffic — shared by the entry (_fill_pipeline)
        and exit (_recount_wanted) gates so they cannot drift apart and
        flap."""
        return max(8, 2 * len(self.peers))

    async def start(self) -> None:
        """Resume from checkpoint or recheck existing data, then join."""
        self.state = TorrentState.CHECKING
        if not self._try_fastresume():
            await self.recheck()
        self.state = TorrentState.SEEDING if self.bitfield.complete else TorrentState.DOWNLOADING
        if self.bitfield.complete:
            self.on_complete.set()
            # already complete at start: either a prior session sent the
            # tracker its `completed` or this was never a download at all
            # — a later piece-loss/re-fetch cycle must not send one
            self._completed_reported = True
        self._stopping = False
        if self.trackers:
            self._spawn(self._announce_loop(), name="announce")
        # BEP 27: a private torrent's peers come from its trackers ONLY —
        # no DHT announces, no PEX gossip (tools/make_torrent.py writes
        # the flag; without this gate the session would leak the swarm).
        if self.dht is not None and not self.private:
            self._spawn(self._dht_loop(), name="dht")
        self._spawn(self._choke_loop(), name="choke")
        self._spawn(self._keepalive_loop(), name="keepalive")
        self._spawn(self._idle_sweep_loop(), name="idle-sweep")
        # the serve reactor: inbound Requests queue per peer and a
        # bounded worker pool drains them (serve_plane/reactor.py);
        # workers ride _spawn so stop() tears them down with the rest
        self._serve_reactor.start(self._spawn)
        if not self.private:
            self._spawn(self._pex_loop(), name="pex")
        self._spawn_seed_loops()

    def add_web_seed(self, url: str) -> bool:
        """Attach a BEP 19 webseed at runtime (e.g. a magnet's ``ws=``).

        Deduplicated and scheme-checked (untrusted input: only http/https
        — urllib would happily open file:// or ftp://); if the torrent is
        already running and pieces are still wanted, the fetch loop
        starts immediately. True when the URL was newly attached."""
        from torrent_tpu_torch.session.webseed import allowed_url

        if self.proxy is not None:
            # webseed fetches ride urllib, which would dial AROUND the
            # configured proxy — refuse rather than leak the client's
            # address to the webseed host
            log.warning("webseed %s disabled: SOCKS5 proxy configured", url)
            return False
        if url in self.web_seed_urls or not allowed_url(url):
            return False
        self.web_seed_urls.append(url)
        if self.state in (TorrentState.DOWNLOADING, TorrentState.SEEDING):
            self._spawn(self._webseed_loop(url), name=f"webseed-{url[:24]}")
        return True

    def _spawn(self, coro, name=None) -> asyncio.Task:
        """Track a task for teardown; completed tasks self-evict."""
        task = asyncio.create_task(coro, name=name)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def _try_fastresume(self) -> bool:
        """Load a fastresume checkpoint; False → caller runs full recheck.

        Claimed pieces are sanity-checked against file existence (not
        content — that's what ``recheck`` is for; a stale checkpoint at
        worst serves bad pieces which peers' own verification rejects).
        """
        if self.resume_store is None:
            return False
        rd = self.resume_store.load(self.metainfo.info_hash)
        if rd is None or rd.num_pieces != self.info.num_pieces:
            return False
        try:
            bf = Bitfield(self.info.num_pieces, rd.bitfield)
        except ValueError:
            return False
        if bf.count() > 0:
            # each claimed piece's files must exist AND reach the extent
            # that piece needs — a crash-truncated file fails here and
            # falls back to the full recheck
            needed_extent: dict[tuple, int] = {}
            for i in range(self.info.num_pieces):
                if bf.has(i):
                    for path, foff, chunk in self.storage.segments(
                        i * self.info.piece_length, piece_length(self.info, i)
                    ):
                        if path is None:
                            continue  # BEP 47 pad span: nothing on disk
                        needed_extent[path] = max(needed_extent.get(path, 0), foff + chunk)
            if not all(
                self.storage.method.exists(p, length)
                for p, length in needed_extent.items()
            ):
                return False
        self.bitfield = bf
        self._notify_present_pieces()
        self._recount_wanted()
        self._rarity_dirty = True
        # Re-ingest checkpointed in-flight pieces: the scheduler resumes
        # mid-piece instead of re-downloading up to piece_length per
        # partial. The data is untrusted-by-construction — verification
        # still gates persistence when the piece completes, exactly as
        # for wire blocks.
        for index, (mask, data) in (rd.partials or {}).items():
            if (
                not isinstance(index, int)
                or not 0 <= index < self.info.num_pieces
                or bf.has(index)
                or index in self._partials
            ):
                continue
            plen_i = piece_length(self.info, index)
            if len(data) != plen_i:
                continue  # geometry changed or corrupt: drop the partial
            received = set()
            for b in range((plen_i + BLOCK_SIZE - 1) // BLOCK_SIZE):
                if b // 8 < len(mask) and mask[b // 8] & (1 << (b % 8)):
                    received.add(b * BLOCK_SIZE)
            if not received:
                continue
            partial = _PartialPiece(
                index=index,
                length=plen_i,
                buffer=bytearray(data),
                received=received,
            )
            if partial.complete:
                # defense against old/foreign checkpoints: a complete
                # partial has no missing block to trigger _finish_piece —
                # drop it and let the scheduler re-fetch the piece
                continue
            self._partials[index] = partial
            # periodic checkpoints keep carrying this partial until the
            # piece completes (an unclean death must not lose it)
            self._saved_partials[index] = (mask, data)
        self.storage.mark_pieces_written(
            i for i in range(self.info.num_pieces) if bf.has(i)
        )
        self.uploaded = rd.uploaded
        self.downloaded = rd.downloaded
        # a restart mid-heal (incomplete bitfield) must still remember
        # that `completed` already went to the tracker — and a crash
        # between queuing the event and the announce leaves it owed
        self._completed_reported = self._completed_reported or rd.completed_reported
        self._pending_completed = self._pending_completed or rd.completed_owed
        log.info("fastresume: %d/%d pieces", bf.count(), self.info.num_pieces)
        return True

    def _checkpoint(self, include_partials: bool = False) -> None:
        if self.resume_store is None:
            return
        from torrent_tpu_torch.session.resume import ResumeData

        # Partial buffers ride only the STOP-time checkpoint: serializing
        # up to piece_length per in-flight piece inside the periodic
        # 16-piece checkpoint would do megabytes of copy+bencode+write on
        # the event loop mid-download. Entry-count capping happens once,
        # in ResumeData.encode.
        if include_partials:
            partials = {}
            for index, p in list(self._partials.items()):
                if not p.received or p.complete:
                    # empty webseed reservations carry nothing; COMPLETE
                    # partials must never persist — a re-ingested complete
                    # partial has no missing block to trigger
                    # _finish_piece and would stall the download forever
                    continue
                n_blocks = (len(p.buffer) + BLOCK_SIZE - 1) // BLOCK_SIZE
                mask = bytearray((n_blocks + 7) // 8)
                for begin in p.received:
                    b = begin // BLOCK_SIZE
                    mask[b // 8] |= 1 << (b % 8)
                partials[index] = (bytes(mask), bytes(p.buffer))
            self._saved_partials = partials
        else:
            # the periodic checkpoint carries FORWARD previously saved
            # partials (already-serialized bytes, no buffer copying) for
            # pieces still incomplete — an unclean death between a
            # resume and the next stop must not lose them. Re-assigning
            # the filtered dict also releases completed pieces' buffers
            # instead of pinning them in RAM for the session's lifetime.
            partials = {
                i: sp
                for i, sp in self._saved_partials.items()
                if not self.bitfield.has(i)
            }
            self._saved_partials = partials
        try:
            self.resume_store.save(
                ResumeData(
                    info_hash=self.metainfo.info_hash,
                    num_pieces=self.info.num_pieces,
                    bitfield=self.bitfield.to_bytes(),
                    uploaded=self.uploaded,
                    downloaded=self.downloaded,
                    partials=partials,
                    completed_reported=self._completed_reported,
                    completed_owed=self._pending_completed,
                )
            )
        except OSError as e:
            log.warning("checkpoint save failed: %s", e)

    async def recheck(self) -> None:
        """Rebuild the bitfield by hashing what's on disk (resume path)."""
        from torrent_tpu_torch.parallel.verify import verify_pieces

        if not any(
            self.storage.method.exists(path)
            for path, _, _ in self.storage._files
            if path is not None  # pads never exist on disk
        ):
            return  # nothing on disk, skip the scan
        cfg = self.config
        if cfg.scheduler is not None and not getattr(self.info, "v2", False):
            # shared-plane path: submit to the process-wide verify queue
            # as a low-priority tenant — the scheduler coalesces these
            # pieces with foreground traffic and its DRR keeps the
            # background recheck from starving anyone (and vice versa:
            # low weight, never zero, so it always progresses)
            from torrent_tpu_torch.parallel.verify import verify_pieces_sched
            from torrent_tpu_torch.sched import SchedRejected

            cfg.scheduler.register_tenant("selfheal", weight=cfg.selfheal_weight)
            try:
                # per-piece launch failures come back as unverified
                # (False) inside verify_pieces_sched — only a whole-
                # queue rejection (scheduler shutting down) falls
                # through to the local verify path below
                ok = await verify_pieces_sched(
                    self.storage, self.info, cfg.scheduler, tenant="selfheal"
                )
                self._apply_recheck(ok)
                return
            except SchedRejected as e:
                log.warning("scheduler recheck rejected (%s); local fallback", e)
        kwargs = {}
        if cfg.hasher == "gpu":
            kwargs = {"batch_size": cfg.verify_batch_size, "device": cfg.device}
            if self.verifier is not None:
                ok = await asyncio.to_thread(
                    self.verifier.verify_storage, self.storage, self.info
                )
                self._apply_recheck(ok)
                return
        ok = await asyncio.to_thread(
            verify_pieces, self.storage, self.info, cfg.hasher, None, **kwargs
        )
        self._apply_recheck(ok)

    def _apply_recheck(self, ok) -> None:
        self.bitfield.from_numpy(ok)
        self._notify_present_pieces()
        self._recount_wanted()
        self.storage.mark_pieces_written(i for i in range(len(ok)) if ok[i])
        log.info(
            "recheck: %d/%d pieces valid", self.bitfield.count(), self.info.num_pieces
        )

    async def stop(self) -> None:
        self._stopping = True
        self._wake_all_waiters()  # parked stream readers abort, not hang
        self._serve_reactor.forget()  # workers die with _tasks below
        tasks = list(self._tasks)
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        for peer in list(self.peers.values()):
            self._swarm_obs.peer_dropped(self._obs_key(peer))
            peer.close()
        self.peers.clear()
        self._recv_flush()  # residual wire charges reach the ledger
        self._egress_flush()  # and residual serve charges with them
        self._checkpoint(include_partials=True)  # stop: keep in-flight work
        if self.trackers:
            try:
                await asyncio.wait_for(
                    self.trackers.announce(self._announce_info(AnnounceEvent.STOPPED)),
                    timeout=5,
                )
            except Exception:
                pass  # best-effort goodbye
        self.state = TorrentState.STOPPED

    # ------------------------------------------------------------ announce

    def _announce_info(self, event: AnnounceEvent) -> AnnounceInfo:
        return AnnounceInfo(
            info_hash=self.metainfo.info_hash,
            peer_id=self.peer_id,
            port=self.port,
            uploaded=self.uploaded,
            downloaded=self.downloaded,
            left=self.left,
            event=event,
            num_want=DEFAULT_NUM_WANT if len(self.peers) < self.config.max_peers else 0,
            key=self.key,
        )

    async def _announce_loop(self) -> None:
        """(torrent.ts:224-244) with early wake via request_peers()."""
        started_sent = False
        while not self._stopping:
            if not started_sent:
                event = AnnounceEvent.STARTED
            elif self._pending_completed:
                event = AnnounceEvent.COMPLETED  # report the snatch (BEP 3)
            else:
                event = AnnounceEvent.EMPTY
            interval = self.config.announce_retry
            try:
                res = await self.trackers.announce(self._announce_info(event))
                self._swarm_obs.on_announce(True, origin=self._swarm_trace)
                if event == AnnounceEvent.STARTED:
                    started_sent = True
                elif event == AnnounceEvent.COMPLETED:
                    self._pending_completed = False
                    # persist delivery NOW: dying before the next periodic
                    # checkpoint would leave `completed` owed on disk and
                    # the restarted session would announce it twice
                    self._checkpoint()
                interval = max(5, res.interval)
                if res.external_ip:
                    # BEP 24: learn our public address from the tracker —
                    # this is what makes BEP 40 dial ordering live without
                    # UPnP (the common NAT'd configuration). Only global
                    # addresses are trusted: dial ordering is a soft
                    # preference, and a hostile tracker shouldn't get to
                    # skew it with loopback/multicast/reserved junk.
                    import ipaddress

                    try:
                        if ipaddress.ip_address(res.external_ip).is_global:
                            self.external_ip = res.external_ip
                    except ValueError:
                        pass
                self._connect_new_peers(res.peers)
            except TrackerError as e:
                log.warning("announce failed: %s", e)
                # failure-streak telemetry: ANNOUNCE_STREAK consecutive
                # failures fire one flight dump (the swarm is coasting
                # on cached peers), re-armed by the next success
                self._swarm_obs.on_announce(False, origin=self._swarm_trace)
            except Exception as e:
                log.warning("announce error: %s", e)
                self._swarm_obs.on_announce(False, origin=self._swarm_trace)
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=interval)
            except asyncio.TimeoutError:
                pass

    def request_peers(self) -> None:
        """Early announce wake (torrent.ts:104-107)."""
        self._wake.set()

    # ------------------------------------------------------------- pausing

    async def pause(self) -> None:
        """Suspend transfers without tearing the session down.

        Connections stay up (cheap to resume; availability intact) but:
        outstanding requests are cancelled and released, no new requests
        or serves happen, and peers are choked. The announce loop keeps
        its interval (trackers still see us; BEP 21-style 'paused' is
        not a wire concept in BEP 3).
        """
        if self.paused:
            return
        self.paused = True
        for p in list(self.peers.values()):
            await self._cancel_and_release(p)
            if not p.am_choking:
                p.am_choking = True
                self._swarm_obs.on_state(self._obs_key(p), am_choking=True)
                try:
                    await proto.send_message(p.writer, proto.Choke())
                except (ConnectionError, OSError):
                    pass

    async def resume(self) -> None:
        """Undo ``pause``: refill pipelines; the choke loop re-unchokes."""
        if not self.paused:
            return
        self.paused = False
        for p in list(self.peers.values()):
            if p.am_interested and not p.peer_choking:
                try:
                    await self._fill_pipeline(p)
                except (ConnectionError, OSError):
                    pass
        self.request_peers()

    async def _dht_loop(self) -> None:
        """BEP 5: announce our port and pull swarm peers from the DHT.

        Runs alongside (or instead of — trackerless magnets) the tracker
        announce loop.
        """
        from torrent_tpu_torch.net.types import AnnouncePeer

        ih = self.metainfo.info_hash
        while not self._stopping:
            try:
                # BEP 33: advertise completion so DHT scrapers can count
                # seeds vs downloaders
                await self.dht.announce(ih, self.port, seed=self.bitfield.complete)
                if self.state != TorrentState.SEEDING:
                    peers = await self.dht.lookup_peers(ih)
                    self._connect_new_peers(
                        [AnnouncePeer(ip=h, port=p) for h, p in peers]
                    )
            except Exception as e:
                log.debug("dht round failed: %s", e)
            await asyncio.sleep(self.config.dht_interval)

    # ------------------------------------------------------------- dialing

    def _connect_new_peers(self, candidates) -> None:
        """Outbound dials, deduped and capped (fixes SURVEY §8.14).

        With a known external address, candidates are dialed in BEP 40
        canonical-priority order (net/priority.py) — both swarm ends
        derive the same ranking, converging the neighbor graph.
        """
        if self.state == TorrentState.SEEDING:
            return  # seeds serve inbound connections; nothing to fetch
        if self.external_ip:
            from torrent_tpu_torch.net.priority import peer_priority

            me = (self.external_ip, self.port)
            candidates = sorted(
                candidates,
                key=lambda c: peer_priority(me, (c.ip, c.port)),
                reverse=True,
            )
        connected = {p.address for p in self.peers.values() if p.address}
        for cand in candidates:
            if len(self.peers) + len(self._dialing) >= self.config.max_peers:
                break
            addr = (cand.ip, cand.port)
            if addr in connected or addr in self._dialing:
                continue
            if cand.ip in self._banned:
                continue
            if self.ip_filter is not None and self.ip_filter.blocked(cand.ip):
                continue
            if cand.peer_id == self.peer_id:
                continue
            self._dialing.add(addr)
            self._spawn(self._dial(addr, cand.peer_id))

    async def _open_transport(self, addr: tuple[str, int]):
        """Connect a transport to ``addr``; returns streams or (None, None).

        With uTP enabled (BEP 29) the dial races uTP against TCP,
        happy-eyeballs style: uTP gets a short head start (it is the
        transport most swarms prefer), TCP starts 250 ms later, first
        connected stream wins and the loser is torn down. A TCP-only
        peer therefore costs ~250 ms extra, not a full uTP timeout —
        ICMP unreachable for UDP is not surfaced per-address by asyncio,
        so a sequential uTP-then-TCP dial would stall every TCP-only
        connection for seconds.
        """
        reader = writer = None
        if self._utp_dial is not None:
            utp_task = asyncio.ensure_future(
                self._utp_dial(addr[0], addr[1], timeout=8)
            )

            async def tcp_late():
                await asyncio.sleep(0.25)
                return await asyncio.open_connection(addr[0], addr[1])

            tcp_task = asyncio.ensure_future(tcp_late())
            pending = {utp_task, tcp_task}
            try:
                end = time.monotonic() + 10
                while pending and reader is None:
                    done, pending = await asyncio.wait(
                        pending,
                        timeout=max(0, end - time.monotonic()),
                        return_when=asyncio.FIRST_COMPLETED,
                    )
                    if not done:
                        break  # overall timeout
                    for t in done:
                        if t.exception() is None and reader is None:
                            reader, writer = t.result()
            finally:
                for t in pending:
                    t.cancel()
                for t in (utp_task, tcp_task):
                    if t.done() and not t.cancelled() and t.exception() is None:
                        r, w = t.result()
                        if w is not writer:
                            w.close()  # the losing transport
        else:
            try:
                if self.proxy is not None:
                    from torrent_tpu_torch.net.socks import open_connection as socks_open

                    reader, writer = await asyncio.wait_for(
                        socks_open(self.proxy, addr[0], addr[1]), timeout=20
                    )
                else:
                    reader, writer = await asyncio.wait_for(
                        asyncio.open_connection(addr[0], addr[1]), timeout=10
                    )
            except (OSError, asyncio.TimeoutError):
                reader = writer = None
        return reader, writer

    async def _dial(self, addr: tuple[str, int], expect_peer_id: bytes | None) -> None:
        """connect/handshake/verify/register (torrent.ts:198-222).

        MSE/PE (net/mse.py): 'enabled' dials plaintext first and retries
        the whole connection encrypted when the plaintext handshake is
        refused (an encryption-requiring peer drops it on sight);
        'required' dials encrypted only.
        """
        from torrent_tpu_torch.net import mse

        class _TerminalDial(Exception):
            """Handshake completed and was rejected on its merits (wrong
            infohash, self-connect) — retrying encrypted proves nothing."""

        policy = self.config.encryption
        modes = {
            "disabled": ("plain",),
            "enabled": ("plain", "mse"),
            "required": ("mse",),
        }[policy]
        pid = reserved = None
        try:
            for mode in modes:
                reader, writer = await self._open_transport(addr)
                if reader is None:
                    return
                try:
                    if mode == "mse":
                        reader, writer, _sel = await asyncio.wait_for(
                            mse.initiate(
                                reader,
                                writer,
                                self.metainfo.info_hash,
                                allow_plaintext=policy != "required",
                            ),
                            timeout=15,
                        )
                    await proto.send_handshake(
                        writer,
                        self.metainfo.info_hash,
                        self.peer_id,
                        proto.merge_reserved(
                            ext.extension_reserved(), proto.fast_reserved()
                        ),
                    )
                    ih, reserved = await asyncio.wait_for(
                        proto.read_handshake_head(reader), timeout=10
                    )
                    pid = await asyncio.wait_for(
                        proto.read_handshake_peer_id(reader), timeout=10
                    )
                    if ih != self.metainfo.info_hash or (
                        expect_peer_id and pid != expect_peer_id
                    ):
                        raise _TerminalDial("handshake mismatch")
                    if pid == self.peer_id:
                        raise _TerminalDial("connected to self")
                    break  # handshake complete on this mode
                except _TerminalDial:
                    writer.close()
                    return
                except (
                    mse.MseError,
                    proto.ProtocolError,
                    asyncio.TimeoutError,
                    asyncio.IncompleteReadError,
                    OSError,
                ):
                    writer.close()
                    pid = None
            if pid is None:
                return
        finally:
            self._dialing.discard(addr)
        await self.add_peer(pid, reader, writer, address=addr, reserved=reserved)

    # ------------------------------------------------------------ peer mgmt

    def _evictable_peer(self):
        """Pick a peer whose slot can be recycled for a fresh
        connection: mutually uninterested, nothing in flight either
        way, past the interest grace period (``config.evict_grace``) —
        longest-idle first. None when every slot is doing (or may yet
        do) something."""
        now = time.monotonic()
        best = None
        for p in self.peers.values():
            if p.peer_interested or p.am_interested or p.inflight:
                continue
            if now - p.connected_at < self.config.evict_grace:
                continue
            if best is None or p.last_rx < best.last_rx:
                best = p
        return best

    async def add_peer(
        self,
        peer_id,
        reader,
        writer,
        address=None,
        reserved: bytes = b"\x00" * 8,
        inbound: bool = False,
    ) -> None:
        """Register + spawn the message loop (torrent.ts:79-102)."""
        existing = self.peers.get(peer_id)
        if existing is not None:
            if existing.inbound == inbound:
                # True reconnect: keep the established connection, close
                # the duplicate — the reference overwrote the map entry
                # and leaked the old socket (§8.14). Stale survivors die
                # via the peer timeout.
                writer.close()
                return
            # Simultaneous open (each end dialed the other — the BEP 55
            # holepunch MAKES this happen on purpose): both ends must
            # keep the SAME connection or the cross-closes kill both.
            # Deterministic tie-break: the connection initiated by the
            # numerically smaller peer id survives on both sides.
            new_initiated_by_us = not inbound
            smaller_is_us = self.peer_id < peer_id
            if new_initiated_by_us != smaller_is_us:
                writer.close()  # the agreed loser
                return
            self._drop_peer(existing)  # replaced by the agreed survivor
        if len(self.peers) >= self.config.max_peers:
            # Slot recycling: a full peer list must not be a permanent
            # wall. A swarm larger than max_peers otherwise starves —
            # peers that already got what they wanted (not interested,
            # nothing in flight either way) sit on their slot forever
            # and the excess peers are refused on every retry (observed:
            # an 80-leech disjoint-selection soak plateaued at exactly
            # 50 leeches' worth of pieces). Real clients evict an idle
            # uninterested peer to admit a fresh one; so do we.
            victim = self._evictable_peer()
            if victim is None:
                writer.close()
                return
            log.debug(
                "peer list full — recycling idle slot %r", victim.peer_id[:8]
            )
            self._drop_peer(victim)
        if address and address[0] in self._banned:
            writer.close()  # banned peers don't get back in by reconnecting
            return
        if address and self.ip_filter is not None and self.ip_filter.blocked(address[0]):
            writer.close()  # blocklisted ranges are refused inbound too
            return
        # the AcceptGate is the front door: slot admission + the per-IP
        # clamp (a one-address stampede is turned away HERE, before a
        # PeerConnection or a peer loop exists for it)
        if not self._accept_gate.connect(
            peer_id, time.monotonic(), ip=address[0] if address else None
        ):
            self._serve_obs.on_reject(
                self._gate_key(peer_id, address),
                self._accept_gate.last_reject or "capacity",
            )
            writer.close()
            return
        peer = PeerConnection(
            peer_id=peer_id,
            reader=reader,
            writer=writer,
            num_pieces=self.info.num_pieces,
            address=address,
            inbound=inbound,
        )
        peer.ext.enabled = ext.supports_extensions(reserved)
        peer.fast = proto.supports_fast(reserved)
        self.peers[peer_id] = peer
        # serialize frame sends: zero-copy egress holds this lock across
        # header + sendfile (asyncio forbids transport.write while a
        # sendfile is in flight), and proto.send_message honors it
        try:
            writer._tt_send_lock = asyncio.Lock()
        except AttributeError:
            pass  # slotted writer fakes: no sendfile path for them anyway
        # connection lifecycle telemetry + tracer span (obs/swarm): one
        # deterministic trace per torrent collects connect/drop spans
        self._swarm_obs.peer_connected(
            self._obs_key(peer), inbound=inbound, trace_id=self._swarm_trace
        )
        # Opening state message. BEP 6 peers get the compact have_all /
        # have_none forms; everyone else gets the raw bitfield
        # (protocol.ts:108-115 sends the bitfield unconditionally).
        # Super-seeding (BEP 16) hides everything and reveals pieces
        # one-by-one via the targeted Haves granted below.
        if self.super_seeding():
            if peer.fast:
                writer.write(proto.encode_message(proto.HaveNone()))
            else:
                proto.send_bitfield(writer, Bitfield(self.info.num_pieces))
        elif peer.fast and self.bitfield.complete:
            writer.write(proto.encode_message(proto.HaveAll()))
        elif peer.fast and self.bitfield.count() == 0:
            writer.write(proto.encode_message(proto.HaveNone()))
        else:
            proto.send_bitfield(writer, self.bitfield)
        if not self.super_seeding():
            # this peer sees our real piece map now — if BEP 16 turns on
            # later (runtime toggle, or a super_seed-configured download
            # completing), the serve gate must not refuse it
            peer.ss_exempt = True
        if peer.fast and address is not None and not self.super_seeding():
            # Canonical allowed-fast grants (both ends can derive the same
            # set, so grants survive reconnects). Served while choked only
            # for pieces we actually have; the rest get explicit rejects.
            for i in proto.allowed_fast_set(
                address[0], self.metainfo.info_hash, self.info.num_pieces
            ):
                peer.allowed_fast_out.add(i)
                writer.write(proto.encode_message(proto.AllowedFast(i)))
        if peer.ext.enabled:
            # BEP 10: extended handshake right after the bitfield,
            # advertising ut_metadata (magnet joiners fetch the info dict
            # from us) and our listen port (so PEX about us is dialable).
            writer.write(
                proto.encode_message(
                    proto.Extended(
                        0,
                        ext.encode_extended_handshake(
                            len(self.info_bytes()),
                            listen_port=self.port,
                            # BEP 27: no off-tracker peer sources — that
                            # rules out holepunch introductions too
                            exclude=(ext.UT_PEX, ext.UT_HOLEPUNCH)
                            if self.private
                            else (),
                        ),
                    )
                )
            )
        if self.super_seeding():
            # initial BEP 16 grants: reveal the first pieces to this peer
            for q in self._ss_pick(peer):
                writer.write(proto.encode_message(proto.Have(index=q)))
        peer.snapshot_rate()
        self._spawn(self._peer_loop(peer), name=f"peer-{peer_id[:8].hex()}")

    def _drop_peer(self, peer: PeerConnection) -> None:
        """Teardown on loop exit (torrent.ts:88-99) + reschedule its blocks.

        Idempotent: the ban path and the peer loop's finally can both call
        this; availability must only be decremented once.
        """
        peer.close()
        if self.peers.get(peer.peer_id) is not peer:
            return  # already dropped (or replaced by a newer connection)
        del self.peers[peer.peer_id]
        self._accept_gate.release(peer.peer_id)
        self._serve_reactor.drop(peer.peer_id)  # queued requests die too
        self._swarm_obs.peer_dropped(self._obs_key(peer))
        self._serve_obs.peer_gone(self._obs_key(peer))
        self._recv_flush()  # a departing peer must not strand recv charges
        self._avail -= peer.bitfield.as_numpy()
        self._rarity_dirty = True
        if self._ss_assigned is not None:
            # unconfirmed BEP 16 grants return to the pool so the next
            # peer can be offered them (least-granted-first picks them up)
            for q in peer.ss_unconfirmed:
                self._ss_assigned[q] -= 1
            peer.ss_unconfirmed.clear()
        self._release_inflight(peer)

    def _inflight_add(self, blk) -> None:
        if self._inflight_count[blk] == 0:
            # the mirror counts DISTINCT requested blocks per piece (not
            # request multiplicity): endgame duplication must not inflate
            # it, or the picker's saturation skip would starve a piece
            # with one duplicated and one unrequested block
            self._piece_inflight[blk[0]] += 1
        self._inflight_count[blk] += 1

    def _inflight_release(self, blk) -> None:
        if self._inflight_count[blk] > 0:
            self._inflight_count[blk] -= 1
            if self._inflight_count[blk] == 0:
                self._piece_inflight[blk[0]] -= 1

    def _release_inflight(self, peer: PeerConnection) -> None:
        for blk in peer.inflight:
            self._inflight_release(blk)
        peer.inflight.clear()
        peer.inflight_choked.clear()
        peer.req_sent_at.clear()

    async def _cancel_and_release(self, peer: PeerConnection) -> None:
        """Cancel every outstanding request to ``peer`` on the wire and
        release the blocks for other peers (pause + snub sweep share
        this; a dead writer just stops the cancels — release happens
        regardless)."""
        for blk in list(peer.inflight):
            try:
                await proto.send_message(peer.writer, proto.Cancel(*blk))
            except (ConnectionError, OSError):
                break
        self._release_inflight(peer)

    async def _replace_bitfield(self, peer: PeerConnection, new_bf: Bitfield) -> None:
        """Swap a peer's piece map (bitfield / have_all / have_none),
        keeping the availability vector and interest state consistent."""
        # in-place ufuncs cast bool→int32 themselves; no copies
        self._avail += new_bf.as_numpy()
        self._avail -= peer.bitfield.as_numpy()
        peer.bitfield = new_bf
        self._rarity_dirty = True
        if self.super_seeding() and peer.ss_unconfirmed:
            # grants the peer turns out to already have can never be
            # confirmed by its uploads — return them and re-grant
            stale = [q for q in peer.ss_unconfirmed if new_bf.has(q)]
            for q in stale:
                peer.ss_unconfirmed.discard(q)
                self._ss_assigned[q] -= 1
            if stale:
                await self._ss_grant(peer)
        await self._update_interest(peer)

    # ------------------------------------------- swarm wire observability

    @staticmethod
    def _obs_key(peer: PeerConnection) -> str:
        """Stable telemetry key for one connection: a short peer-id
        prefix plus the transport address (the same facts status() and
        the ban list already expose — never the full 20-byte id).
        Memoized on the connection — the per-message accounting path
        must not rebuild the string per 16 KiB block."""
        key = peer.obs_key
        if key is None:
            host, port = peer.address or ("?", 0)
            key = peer.obs_key = f"{peer.peer_id[:4].hex()}@{host}:{port}"
        return key

    def _recv_charge(self, seconds: float, nbytes: int) -> None:
        """Account wire time/bytes to the ledger's ``recv`` stage.

        Batched: the accumulator flushes once per :data:`_RECV_FLUSH_OPS`
        events or :data:`_RECV_FLUSH_S` seconds of accumulated wait, so
        a 16 KiB-block hot loop pays one obs-lock acquisition per batch,
        not per message. The peer loop runs on the event loop thread, so
        the accumulator needs no lock of its own."""
        self._recv_s += seconds
        self._recv_bytes += nbytes
        self._recv_ops += 1
        if self._recv_ops >= _RECV_FLUSH_OPS or self._recv_s >= _RECV_FLUSH_S:
            self._recv_flush()

    def _recv_flush(self) -> None:
        if not self._recv_ops:
            return
        pipeline_ledger().record("recv", self._recv_bytes, self._recv_s)
        self._recv_s = 0.0
        self._recv_bytes = 0
        self._recv_ops = 0

    @staticmethod
    def _gate_key(peer_id, address) -> str:
        """Telemetry key for a connection refused BEFORE a
        PeerConnection existed (the accept-gate reject path)."""
        host, port = address or ("?", 0)
        return f"{peer_id[:4].hex()}@{host}:{port}"

    def _egress_charge(self, seconds: float, nbytes: int) -> None:
        """Account serve time/bytes to the ledger's ``egress`` stage
        (batched, the ``_recv_charge`` discipline — a seeder pushing
        thousands of blocks a second pays one obs-lock per batch)."""
        self._egress_s += seconds
        self._egress_bytes += nbytes
        self._egress_ops += 1
        if self._egress_ops >= _RECV_FLUSH_OPS or self._egress_s >= _RECV_FLUSH_S:
            self._egress_flush()

    def _egress_flush(self) -> None:
        if not self._egress_ops:
            return
        pipeline_ledger().record("egress", self._egress_bytes, self._egress_s)
        self._egress_s = 0.0
        self._egress_bytes = 0
        self._egress_ops = 0

    # ------------------------------------------------------- message loop

    async def _peer_loop(self, peer: PeerConnection) -> None:
        """All nine message handlers (torrent.ts:114-196, completed).

        The read is deliberately NOT wrapped in ``asyncio.wait_for``: at
        16 KiB blocks that is one timer handle allocated and cancelled
        per message (~6k/s/peer at full rate — measured as a top-5
        event-loop cost in the 8-leech profile). Dead-peer protection
        lives in ``_idle_sweep_loop`` instead: one timer per torrent,
        closing any transport whose ``last_rx`` went stale, which wakes
        this read with EOF exactly like the old per-message timeout.
        """
        try:
            while not self._stopping:
                # recv-stage accounting: time blocked on the socket WHILE
                # this peer owes us blocks is network-limited time (an
                # idle keepalive wait with nothing requested is not) —
                # the charge that lets attribution say "the network is
                # the bottleneck" instead of blaming disk
                waited_from = time.monotonic() if peer.inflight else None
                msg = await proto.read_message(peer.reader)
                if msg is None:
                    break
                peer.last_rx = time.monotonic()
                if waited_from is not None:
                    self._recv_charge(peer.last_rx - waited_from, 0)
                await self._handle_message(peer, msg)
        except (proto.ProtocolError, asyncio.TimeoutError, ConnectionError, OSError):
            pass
        finally:
            self._drop_peer(peer)

    async def _handle_message(self, peer: PeerConnection, msg) -> None:
        # per-message-type byte/count accounting (bounded kind set); the
        # registry folds unknown kinds and >MAX_TRACKED_PEERS peers, so
        # this is O(1) dict work under one uncontended leaf lock
        okey = self._obs_key(peer)
        self._swarm_obs.on_message(
            okey, type(msg).__name__, _wire_payload_bytes(msg)
        )
        match msg:
            case proto.KeepAlive():
                pass
            case proto.Choke():
                peer.peer_choking = True
                self._swarm_obs.on_state(okey, peer_choking=True)
                if not peer.fast:
                    # BEP 3: choke silently voids outstanding requests.
                    # BEP 6: it doesn't — the peer explicitly rejects each
                    # one (the snub timer is the net under a peer that
                    # chokes and never sends the rejects).
                    self._release_inflight(peer)
            case proto.Unchoke():
                peer.peer_choking = False
                self._swarm_obs.on_state(okey, peer_choking=False)
                await self._fill_pipeline(peer)
            case proto.Interested():
                peer.peer_interested = True
                self._swarm_obs.on_state(okey, peer_interested=True)
                # Fast-path unchoke: when reciprocity slots are free, a
                # newly interested peer starts transferring NOW instead of
                # idling choked until the next 10 s rechoke tick (the tick
                # still re-ranks everyone by rate later). Without this,
                # every fresh connection wastes up to choke_interval
                # seconds — the dominant latency in small swarms.
                if not self.paused and peer.am_choking:
                    unchoked = sum(
                        1 for p in self.peers.values() if not p.am_choking
                    )
                    if unchoked < self.config.unchoke_slots + 1:
                        peer.am_choking = False
                        self._swarm_obs.on_state(okey, am_choking=False)
                        await proto.send_message(peer.writer, proto.Unchoke())
            case proto.NotInterested():
                peer.peer_interested = False
                self._swarm_obs.on_state(okey, peer_interested=False)
            case proto.Have(index):
                if 0 <= index < self.info.num_pieces:
                    if not peer.bitfield.has(index):
                        peer.bitfield.set(index)
                        self._avail[index] += 1
                        self._rarity_dirty = True
                    if self.super_seeding():
                        await self._ss_on_peer_have(peer, index)
                    # A Have can only turn interest ON, so this is O(1);
                    # the full vector interest recheck is reserved for
                    # bitfield replacement and our own piece completions
                    # (where interest can flip off).
                    if not self.bitfield.has(index) and self._piece_priority[index] > 0:
                        if not peer.am_interested:
                            peer.am_interested = True
                            await proto.send_message(peer.writer, proto.Interested())
                        # _fill_pipeline self-gates on choke state and
                        # allowed-fast grants — a choked fast peer that
                        # granted this very piece must still be asked.
                        # Refill only when this peer's pipeline is idle
                        # (or endgame): a busy pipeline refills itself on
                        # the next block via the hysteresis path, and in
                        # a cross-connected swarm per-Have refills are an
                        # O(pieces) scan times every completion broadcast
                        # (measured: ~40% of the seed-fanout CPU). A
                        # choked fast peer announcing a piece it GRANTED
                        # still refills immediately — its retained
                        # pre-choke inflight may never drain (rejects can
                        # be withheld), and this piece is its explicit
                        # offer.
                        if (
                            not peer.inflight
                            or self._endgame
                            or (peer.peer_choking and index in peer.allowed_fast_in)
                        ):
                            await self._fill_pipeline(peer)
            case proto.BitfieldMsg(raw):
                try:
                    new_bf = Bitfield(self.info.num_pieces, raw)
                except ValueError:
                    # construct-before-decrement: a bad bitfield must leave
                    # availability untouched (drop-peer will decrement the
                    # old one exactly once)
                    raise proto.ProtocolError("bad bitfield")
                await self._replace_bitfield(peer, new_bf)
            case proto.Request(index, begin, length):
                # malformed requests kill the connection HERE, in the
                # peer loop (queueing them would soften the protocol
                # error into a swallowed worker exception)
                if not validate_requested_block(self.info, index, begin, length):
                    raise proto.ProtocolError("invalid request")
                if self._serve_reactor.running:
                    # the reactor decouples the wire from the disk: the
                    # request queues per peer; a full queue is answered
                    # with an explicit reject (bounded hostile demand)
                    if not self._serve_reactor.submit(
                        peer.peer_id, (index, begin, length)
                    ):
                        self._serve_obs.on_reject(okey, "backpressure")
                        if peer.fast:
                            await proto.send_message(
                                peer.writer,
                                proto.RejectRequest(index, begin, length),
                            )
                else:
                    # no pool (stopped torrent, direct-drive tests):
                    # serve inline, the legacy path
                    await self._serve_request(peer, index, begin, length)
            case proto.Piece(index, begin, block):
                await self._ingest_block(peer, index, begin, block)
            case proto.Cancel(index, begin, length):
                # requests still queued in the reactor are cancellable
                # (in-flight ones are not — we serve them; BEP 3 allows
                # either). Fast peers get the explicit BEP 6 reject.
                gone = self._serve_reactor.cancel(
                    peer.peer_id, lambda it: it == (index, begin, length)
                )
                if gone:
                    self._serve_obs.on_queue_cancel(len(gone))
                    if peer.fast:
                        for (ci, cb, cl) in gone:
                            await proto.send_message(
                                peer.writer, proto.RejectRequest(ci, cb, cl)
                            )
            case proto.HaveAll() | proto.HaveNone():
                if not peer.fast:
                    raise proto.ProtocolError("have_all/have_none without fast ext")
                new_bf = Bitfield(self.info.num_pieces)
                if isinstance(msg, proto.HaveAll):
                    new_bf.from_numpy(np.ones(self.info.num_pieces, dtype=bool))
                await self._replace_bitfield(peer, new_bf)
            case proto.SuggestPiece(index):
                if peer.fast and 0 <= index < self.info.num_pieces:
                    # bounded hint list, most recent first
                    if index in peer.suggested:
                        peer.suggested.remove(index)
                    peer.suggested.insert(0, index)
                    del peer.suggested[16:]
            case proto.AllowedFast(index):
                if peer.fast and 0 <= index < self.info.num_pieces:
                    peer.allowed_fast_in.add(index)
                    if (
                        peer.peer_choking
                        and peer.bitfield.has(index)
                        and not self.bitfield.has(index)
                    ):
                        await self._fill_pipeline(peer)
            case proto.RejectRequest(index, begin, length):
                if not peer.fast:
                    raise proto.ProtocolError("reject_request without fast ext")
                blk = (index, begin, length)
                self._swarm_obs.on_reject(okey)
                if blk in peer.inflight:
                    peer.inflight.discard(blk)
                    peer.req_sent_at.pop(blk, None)
                    self._inflight_release(blk)
                    # Rejecting a request that was *issued under the grant*
                    # (i.e. while choked) withdraws it — otherwise the
                    # choked pipeline re-requests it forever. Rejects of
                    # ordinary unchoked-time requests (the normal BEP 6
                    # choke flow) must NOT burn the grant: it becomes
                    # useful exactly now that we are choked.
                    if blk in peer.inflight_choked:
                        peer.inflight_choked.discard(blk)
                        peer.allowed_fast_in.discard(index)
                    # A peer that rejects everything we ask for must not
                    # spin the request/reject loop at line rate: each
                    # refill resets the wall-clock snub timer, so count
                    # rejects instead and snub on a burst of them.
                    peer.rejects_since_block += 1
                    if peer.rejects_since_block >= 2 * self.config.pipeline_depth:
                        peer.snubbed_until = (
                            time.monotonic() + self.config.snub_timeout
                        )
                        self._swarm_obs.on_snub(okey)
                    else:
                        await self._fill_pipeline(peer)
            case proto.HashRequest():
                await self._serve_hash_request(peer, msg)
            case proto.Hashes() | proto.HashReject():
                # responses are routed by (sender, fields): another peer
                # echoing the same fields must not resolve — or poison —
                # a wait addressed to someone else
                key = (
                    peer.peer_id,
                    msg.pieces_root,
                    msg.base_layer,
                    msg.index,
                    msg.length,
                    msg.proof_layers,
                )
                fut = self._hash_fetches.get(key)
                if fut is not None and not fut.done():
                    fut.set_result(
                        msg.hash_list() if isinstance(msg, proto.Hashes) else None
                    )
            case proto.Extended(ext_id, payload):
                await self._handle_extended(peer, ext_id, payload)

    # ------------------------------------------------- BEP 52 hash serving

    def _hash_tree_cache(self):
        """Lazy per-torrent merkle layer cache for hybrid torrents.

        Hybrid `.torrent`s (BEP 52 upgrade path) carry a top-level
        ``piece layers`` dict alongside the v1 info; v2-capable peers on
        the v1 swarm may ask us for subtree hashes (messages 21-23).
        Returns None for plain v1 torrents — those requests get rejects.
        """
        if self._hash_cache is _UNSET:
            self._hash_cache = None
            layers_raw = self.metainfo.raw.get(b"piece layers")
            if isinstance(layers_raw, dict) and layers_raw:
                from torrent_tpu_torch.models.hashes import HashTreeCache

                layers = {}
                for root, blob in layers_raw.items():
                    if isinstance(root, bytes) and len(root) == 32 and isinstance(blob, bytes):
                        layers[root] = tuple(
                            blob[i : i + 32] for i in range(0, len(blob), 32)
                        )
                if layers:
                    cache = HashTreeCache(layers, self.info.piece_length)
                    # single-piece files: their pieces root appears only
                    # in the info file tree, not in piece layers
                    cache.add_single_piece_roots(
                        r for r, _ in self._v2_file_roots() if r not in layers
                    )
                    self._hash_cache = cache
        return self._hash_cache

    def _v2_file_roots(self) -> list[tuple[bytes, int]]:
        """``(pieces_root, length)`` per file from the info file tree
        (hybrid torrents); empty for plain v1."""
        info_raw = self.metainfo.raw.get(b"info")
        if not isinstance(info_raw, dict):
            return []
        out = []

        def walk(node):
            if not isinstance(node, dict):
                return
            for k, v in node.items():
                if k == b"" and isinstance(v, dict):
                    pr = v.get(b"pieces root")
                    ln = v.get(b"length")
                    if isinstance(pr, bytes) and len(pr) == 32 and isinstance(ln, int):
                        out.append((pr, ln))
                else:
                    walk(v)

        walk(info_raw.get(b"file tree", {}))
        return out

    async def _fetch_hash_run(
        self, fields: tuple, req, deadline: float, per_peer: float
    ):
        """Ask connected peers (sequentially, short per-peer timeout) for
        one verified hash run; None when nobody delivers in time."""
        from torrent_tpu_torch.models.hashes import verify_hash_response

        for peer in list(self.peers.values()):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            key = (peer.peer_id, *fields)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._hash_fetches[key] = fut
            try:
                await proto.send_message(peer.writer, proto.HashRequest(*fields))
                got = await asyncio.wait_for(fut, min(per_peer, remaining))
            except (asyncio.TimeoutError, ConnectionError, OSError):
                got = None
            finally:
                self._hash_fetches.pop(key, None)
            if got and verify_hash_response(req, got):
                return got
        return None

    async def fetch_v2_layers(self, timeout: float = 30.0, per_peer: float = 5.0) -> bool:
        """BEP 52 fetch side: pull missing piece layers from the swarm.

        A magnet-joined hybrid learns its info dict via ut_metadata, but
        piece layers live OUTSIDE the info dict — without them we can't
        serve hash requests onward. Every run is verified against the
        trusted ``pieces root`` before acceptance: small layers are
        fetched whole (the full layer reduces directly to the root),
        large ones in MAX_RUN chunks whose uncle proofs chain each chunk
        to the root independently. Peers are tried with a short per-peer
        timeout under one overall deadline (v1-only peers simply never
        answer message 21). Returns True when every multi-piece file's
        layer verified and installed (the torrent then serves onward).
        """
        async with self._fetch_layers_lock:
            return await self._fetch_v2_layers_locked(timeout, per_peer)

    async def _fetch_v2_layers_locked(self, timeout: float, per_peer: float) -> bool:
        from torrent_tpu_torch.models.hashes import (
            HashRequestFields,
            HashTreeCache,
            MAX_RUN,
            _layer_height,
        )

        if self._hash_tree_cache() is not None:
            return True  # already have layers (authored/parsed from disk)
        roots = self._v2_file_roots()
        if not roots:
            return False  # not a hybrid torrent
        plen = self.info.piece_length
        base = _layer_height(plen)
        deadline = time.monotonic() + timeout
        layers: dict[bytes, tuple[bytes, ...]] = {}
        singles = []
        for root, length in roots:
            n_pieces = max(1, -(-length // plen))
            if n_pieces == 1:
                singles.append(root)
                continue
            padded = 1 << (n_pieces - 1).bit_length()
            run = min(padded, MAX_RUN)
            # chunks above MAX_RUN verify via uncle proofs up to the root
            proofs = (padded.bit_length() - 1) - (run.bit_length() - 1)
            got_all: list[bytes] = []
            for start in range(0, min(padded, n_pieces), run):
                fields = (root, base, start, run, proofs)
                req = HashRequestFields(*fields)
                got = await self._fetch_hash_run(fields, req, deadline, per_peer)
                if got is None:
                    return False
                got_all.extend(got[:run])
            layers[root] = tuple(got_all[:n_pieces])
        cache = HashTreeCache(layers, plen)
        cache.add_single_piece_roots(singles)
        self._hash_cache = cache
        return True

    async def _serve_hash_request(self, peer: PeerConnection, msg) -> None:
        from torrent_tpu_torch.models.hashes import HashRequestFields

        fields = (msg.pieces_root, msg.base_layer, msg.index, msg.length, msg.proof_layers)
        cache = self._hash_tree_cache()
        served = None
        if cache is not None:
            # the first request per root rebuilds that file's merkle
            # levels (~200k sha256 for a 100k-piece layer) — off the
            # event loop, so piece traffic and timers keep flowing
            served = await asyncio.to_thread(
                cache.serve, HashRequestFields(*fields)
            )
        if served is None:
            await proto.send_message(peer.writer, proto.HashReject(*fields))
            return
        await proto.send_message(
            peer.writer, proto.Hashes(*fields, hashes=b"".join(served))
        )

    # ----------------------------------------------------- BEP 10 extensions

    def info_bytes(self) -> bytes:
        """Canonical serialized info dict (BEP 9 metadata payload)."""
        if self._info_bytes is None:
            from torrent_tpu_torch.codec.bencode import bencode

            raw_info = self.metainfo.raw.get(b"info")
            if raw_info is not None:
                # sort_keys=False: the decoded dict preserves the file's
                # key order, so this re-encode is byte-exact and hashes
                # back to info_hash.
                self._info_bytes = bencode(raw_info, sort_keys=False)
            else:  # synthetic metainfo (tests): canonical order
                self._info_bytes = b""
        return self._info_bytes

    async def _handle_extended(self, peer: PeerConnection, ext_id: int, payload: bytes) -> None:
        """BEP 10 demux: ext handshake (0) or our ut_metadata id."""
        if not peer.ext.enabled:
            return  # never advertised the reserved bit; ignore
        if ext_id == 0:
            ext.decode_extended_handshake(payload, peer.ext)
            return
        if ext_id == ext.LOCAL_EXT_IDS[ext.UT_PEX]:
            if self.private:
                return  # BEP 27: ignore gossip a peer sends anyway
            pex = ext.decode_pex(payload)
            if pex is not None and pex.added:
                from torrent_tpu_torch.net.types import AnnouncePeer

                self._connect_new_peers(
                    [AnnouncePeer(ip=h, port=p) for h, p in pex.added]
                )
            return
        if ext_id == ext.LOCAL_EXT_IDS[ext.UT_HOLEPUNCH]:
            await self._handle_holepunch(peer, payload)
            return
        if ext_id == ext.LOCAL_EXT_IDS[ext.LT_DONTHAVE]:
            # BEP 54: the peer retracts an announced piece — the inverse
            # of Have. Interest can flip OFF here, so the full vector
            # recheck runs (unlike the O(1) Have fast path).
            idx = ext.decode_donthave(payload)
            if idx is None or not (0 <= idx < self.info.num_pieces):
                return
            if peer.bitfield.has(idx):
                peer.bitfield.set(idx, False)
                self._avail[idx] -= 1
                self._rarity_dirty = True
                # The peer can no longer deliver blocks of this piece:
                # release them for other peers (the Choke/RejectRequest
                # treatment) — a BEP 54 peer without the fast extension
                # sends no rejects, so held blocks would stall until the
                # snub sweep otherwise.
                for blk in [b for b in peer.inflight if b[0] == idx]:
                    self._inflight_release(blk)
                    peer.inflight.discard(blk)
                    peer.inflight_choked.discard(blk)
                await self._update_interest(peer)
            return
        if ext_id == ext.LOCAL_EXT_IDS[ext.UT_METADATA]:
            msg = ext.decode_metadata_message(payload)
            if msg is None or peer.ext.ut_metadata_id == 0:
                return
            if msg.msg_type == ext.MsgType.REQUEST:
                info = self.info_bytes()
                piece = ext.metadata_piece(info, msg.piece) if info else None
                if piece is None:
                    reply = ext.encode_metadata_reject(msg.piece)
                else:
                    reply = ext.encode_metadata_data(msg.piece, len(info), piece)
                await proto.send_message(
                    peer.writer, proto.Extended(peer.ext.ut_metadata_id, reply)
                )
            # DATA/REJECT towards a complete torrent: nothing to do (the
            # magnet fetch path, session/metadata.py, has its own loop).

    # -------------------------------------------------- BEP 16 super-seed

    def super_seeding(self) -> bool:
        """True while BEP 16 mode is active (needs a complete torrent)."""
        return self._ss_active and self.bitfield.complete

    async def set_super_seeding(self, on: bool) -> None:
        """Toggle BEP 16 at runtime. Turning it ON only affects peers
        that connect afterwards — existing peers already saw the real
        bitfield, so they are exempted from the serve gate (hiding
        pieces they know about would only stall them); turning it OFF
        reveals everything to current peers."""
        was = self.super_seeding()
        if on and not was:
            for p in self.peers.values():
                p.ss_exempt = True
        self._ss_active = bool(on)
        if was and not self.super_seeding():
            await self._ss_reveal_all()

    def _ss_arrays(self) -> None:
        if self._ss_spread is None:
            n = self.info.num_pieces
            self._ss_spread = np.zeros(n, dtype=bool)
            self._ss_assigned = np.zeros(n, dtype=np.int32)

    def _ss_pick(self, peer: PeerConnection) -> list[int]:
        """Grant up to the outstanding quota of pieces to ``peer``:
        least-granted unspread pieces the peer doesn't already have."""
        self._ss_arrays()
        grants = []
        while len(peer.ss_unconfirmed) < self.config.super_seed_outstanding:
            mask = ~self._ss_spread & ~peer.bitfield.as_numpy()
            for q in peer.ss_advertised:
                mask[q] = False
            idxs = np.nonzero(mask)[0]
            if len(idxs) == 0:
                break
            q = int(idxs[np.argmin(self._ss_assigned[idxs])])
            self._ss_assigned[q] += 1
            peer.ss_advertised.add(q)
            peer.ss_unconfirmed.add(q)
            grants.append(q)
        return grants

    async def _ss_grant(self, peer: PeerConnection) -> None:
        for q in self._ss_pick(peer):
            await proto.send_message(peer.writer, proto.Have(index=q))

    async def _ss_on_peer_have(self, peer: PeerConnection, index: int) -> None:
        """BEP 16 confirmation: a piece we granted is 'spread' once a
        peer we did NOT grant it to announces it — the only way it can
        have the piece is that a grantee uploaded it onward. A grantee's
        own Have proves nothing (it downloaded from us), EXCEPT when
        every connected peer now has the piece — then there is nobody
        left to upload to and holding the grant open would wedge the
        grantee's quota (this also covers the one-peer swarm, where
        strict BEP 16 would deadlock with nobody to confirm)."""
        self._ss_arrays()
        if self._ss_spread[index]:
            return
        if index in peer.ss_advertised:
            everyone_has = all(
                p.bitfield.has(index) for p in self.peers.values()
            )
            if not everyone_has:
                return  # grantee finished ITS download: not evidence
        self._ss_spread[index] = True
        # confirmation releases EVERY grantee's outstanding entry for
        # this piece (a double-granted piece must not leak quota slots)
        for p in list(self.peers.values()):
            if index in p.ss_unconfirmed:
                p.ss_unconfirmed.discard(index)
                try:
                    await self._ss_grant(p)
                except (ConnectionError, OSError):
                    continue  # peer went away; grants return via _drop_peer
        if bool(self._ss_spread.all()):
            # one full copy is out in the swarm: mission accomplished —
            # revert to plain seeding (rarest-first swarm dynamics take
            # over from here, per BEP 16's own guidance)
            self._ss_active = False
            await self._ss_reveal_all()

    async def _ss_reveal_all(self) -> None:
        """Exit super-seed mode: advertise every still-hidden piece to
        every connected peer (bitfields can't be resent mid-connection;
        Haves are always legal)."""
        for p in list(self.peers.values()):
            hidden = [
                i
                for i in range(self.info.num_pieces)
                if self.bitfield.has(i) and i not in p.ss_advertised
            ]
            p.ss_advertised.update(hidden)
            try:
                # one batched write + one drain per peer: a per-message
                # drain here would stall this peer loop for
                # num_pieces x num_peers round-trips on big torrents
                p.writer.write(
                    b"".join(
                        proto.encode_message(proto.Have(index=i)) for i in hidden
                    )
                )
                await p.writer.drain()
            except (ConnectionError, OSError):
                continue

    # ---------------------------------------------------- BEP 55 holepunch

    async def _handle_holepunch(self, peer: PeerConnection, payload: bytes) -> None:
        """Relay/act on a ut_holepunch frame (BEP 55 NAT traversal).

        As relay: a RENDEZVOUS naming a peer we're connected to gets
        simultaneous CONNECTs to both endpoints; unknown targets get an
        ERROR. As endpoint: a CONNECT is an invitation to dial NOW (the
        other side is dialing us at this instant — the parallel SYNs are
        what punch the NAT mappings open; on loopback tests it is simply
        an introduction service).
        """
        msg = ext.decode_holepunch(payload)
        if msg is None:
            return
        if self.private:
            # BEP 27: a private torrent's peers come from its trackers
            # ONLY — a relayed introduction is an off-tracker peer source
            # exactly like PEX, which is likewise disabled
            return
        if msg.msg_type == ext.HolepunchType.RENDEZVOUS:
            target = None
            for p in self.peers.values():
                addr = p.dial_address()
                if addr is not None and addr == msg.addr and p is not peer:
                    target = p
                    break
            initiator_addr = peer.dial_address()
            if target is None or initiator_addr is None:
                reply = ext.HolepunchMessage(
                    ext.HolepunchType.ERROR, msg.addr,
                    err_code=ext.HolepunchError.NOT_CONNECTED,
                )
                await self._send_holepunch(peer, reply)
                return
            if not target.ext.ut_holepunch_id:
                reply = ext.HolepunchMessage(
                    ext.HolepunchType.ERROR, msg.addr,
                    err_code=ext.HolepunchError.NO_SUPPORT,
                )
                await self._send_holepunch(peer, reply)
                return
            await self._send_holepunch(
                target, ext.HolepunchMessage(ext.HolepunchType.CONNECT, initiator_addr)
            )
            await self._send_holepunch(
                peer, ext.HolepunchMessage(ext.HolepunchType.CONNECT, msg.addr)
            )
            return
        if msg.msg_type == ext.HolepunchType.CONNECT:
            # an explicit introduction: dial NOW, bypassing the
            # seeds-don't-dial policy in _connect_new_peers — the other
            # endpoint is dialing us at this instant and the simultaneous
            # SYNs are the whole point of BEP 55
            addr = msg.addr
            known = {p.address for p in self.peers.values() if p.address} | {
                p.dial_address() for p in self.peers.values()
            }
            if addr in known or addr in self._dialing:
                return
            if len(self.peers) + len(self._dialing) >= self.config.max_peers:
                return  # same budget every dial path honors — a relay
                # streaming CONNECT frames must not mint unbounded dials
            if addr[0] in self._banned or (
                self.ip_filter is not None and self.ip_filter.blocked(addr[0])
            ):
                return
            self._dialing.add(addr)
            self._spawn(self._dial(addr, None))
            return
        if msg.msg_type == ext.HolepunchType.ERROR:
            log.debug(
                "holepunch rendezvous for %s failed: code %d", msg.addr, msg.err_code
            )

    async def _send_holepunch(self, peer: PeerConnection, msg) -> bool:
        if not peer.ext.ut_holepunch_id:
            return False
        try:
            payload = ext.encode_holepunch(msg)
        except (OSError, OverflowError, ValueError):
            # hostname instead of a numeric address, or a port outside
            # u16 — unencodable targets are a caller error, not a reason
            # to kill the peer loop
            return False
        await proto.send_message(
            peer.writer, proto.Extended(peer.ext.ut_holepunch_id, payload)
        )
        return True

    async def holepunch_rendezvous(
        self, relay_peer_id: bytes, target: tuple[str, int]
    ) -> bool:
        """Ask a connected relay peer to introduce us to ``target``
        (BEP 55 initiator side). True if the request was sent."""
        relay = self.peers.get(relay_peer_id)
        if relay is None or not relay.ext.ut_holepunch_id:
            return False
        return await self._send_holepunch(
            relay, ext.HolepunchMessage(ext.HolepunchType.RENDEZVOUS, target)
        )

    # ------------------------------------------------------------- leeching

    async def _update_interest(self, peer: PeerConnection) -> None:
        # vectorized: "peer has any wanted piece we're missing" without a
        # Python scan per have/bitfield message
        want = bool(
            np.any(
                peer.bitfield.as_numpy()
                & ~self.bitfield.as_numpy()
                & (self._piece_priority > 0)
            )
        )
        if want and not peer.am_interested:
            peer.am_interested = True
            self._swarm_obs.on_state(self._obs_key(peer), am_interested=True)
            await proto.send_message(peer.writer, proto.Interested())
        elif not want and peer.am_interested:
            peer.am_interested = False
            self._swarm_obs.on_state(self._obs_key(peer), am_interested=False)
            await proto.send_message(peer.writer, proto.NotInterested())
        if want:
            # self-gated: no-ops while choked unless allowed-fast applies
            await self._fill_pipeline(peer)

    def _rebuild_rarity(self) -> None:
        """Wanted missing pieces, highest file priority first, then
        rarest-first with a stable random tiebreak — or in index order
        when ``config.sequential`` (streaming playback wants the front
        of the file, not the globally rarest piece)."""
        missing = np.flatnonzero(
            (~self.bitfield.as_numpy()) & (self._piece_priority > 0)
        )
        if self.config.sequential:
            order = np.lexsort((missing, -self._piece_priority[missing]))
        else:
            jitter = np.random.random(len(missing))
            order = np.lexsort(
                (jitter, self._avail[missing], -self._piece_priority[missing])
            )
        self._rarity_order = missing[order].tolist()
        self._rarity_dirty = False

    def _blocks_of(self, index: int):
        plen = piece_length(self.info, index)
        for begin in range(0, plen, BLOCK_SIZE):
            yield (index, begin, min(BLOCK_SIZE, plen - begin))

    def _missing_blocks(self, index: int):
        partial = self._partials.get(index)
        for blk in self._blocks_of(index):
            if partial is not None and blk[1] in partial.received:
                continue
            yield blk

    async def _fill_pipeline(self, peer: PeerConnection) -> None:
        """Rarest-first picking + pipelining; endgame duplication.

        While choked, a BEP 6 peer can still be asked for its allowed-fast
        grants — candidate pieces are then restricted to that set.
        """
        if self.paused or self.bitfield.complete or not self._wanted_remaining():
            return
        choked_fast = peer.peer_choking and peer.fast and bool(peer.allowed_fast_in)
        if peer.peer_choking and not choked_fast:
            return
        if peer.snubbed and not self._endgame:
            return  # earns requests back by delivering a block
        budget = self.config.pipeline_depth - len(peer.inflight)
        if budget <= 0:
            return
        if (
            not self._endgame
            and peer.fill_starved
            and peer.inflight
            and time.monotonic() - peer.last_fill_at < 0.05
        ):
            # The last full scan could NOT fill this peer's budget (the
            # swarm is contended around it) and it ran <50 ms ago with
            # the pipeline still non-empty: skip the O(pieces) rescan.
            # In an 8-leech mesh the per-block hysteresis otherwise
            # re-runs a ~150 us scan at line rate for ~1-block yields —
            # measured as the top CPU cost of a fanout. Uncontended
            # peers (full-budget picks) and empty pipelines never wait.
            return
        peer.last_fill_at = time.monotonic()
        # direct bool-array views for the scan loops: Bitfield.has() is a
        # bounds-checked method call, and a deep rarity scan makes tens of
        # millions of them per fanout transfer (measured ~20% of seed-side
        # CPU). The picking phase below is await-free, so the snapshots
        # cannot go stale mid-scan.
        have_arr = self.bitfield.as_numpy()
        peer_arr = peer.bitfield.as_numpy()
        wanted: list[tuple[int, int, int]] = []

        def pickable(index: int) -> bool:
            return not peer.peer_choking or index in peer.allowed_fast_in

        def take_from(index: int) -> bool:
            # Saturated-piece fast path, exact for partial-less pieces:
            # the mirror counts distinct requested blocks, and a fresh
            # piece has no received-but-still-counted blocks, so mirror
            # == n_blocks means literally every block is requested. Under
            # fanout MOST deep-scanned pieces are in this state. Pieces
            # with a partial keep the full block iteration — their
            # received set can overlap stale outstanding requests, and a
            # count-based skip there can starve the one unrequested block
            # until a snub timeout.
            if index not in self._partials:
                n_blocks = (
                    piece_length(self.info, index) + BLOCK_SIZE - 1
                ) // BLOCK_SIZE
                if self._piece_inflight[index] >= n_blocks:
                    return False
            for blk in self._missing_blocks(index):
                if self._inflight_count[blk] > 0 or blk in peer.inflight:
                    continue
                wanted.append(blk)
                if len(wanted) >= budget:
                    return True
            return False

        # Prefer finishing partial pieces, then rarest-first fresh pieces.
        # Webseed-reserved partials are skipped: the HTTP fetch owns them
        # (racing it would double-download; endgame below still covers
        # them so a dead webseed can't stall completion).
        for index, partial in list(self._partials.items()):
            if partial.webseed:
                continue
            if (
                peer_arr[index]
                and not have_arr[index]
                and self._piece_priority[index] > 0  # deselected partials
                # (e.g. resumed then deselected) must not outrank wanted
                and pickable(index)
            ):
                if take_from(index):
                    break
        # Active stream windows outrank everything below: a parked HTTP
        # reader is latency-bound on exactly these pieces. Consulted
        # directly (not via the priority array) so window advances are
        # O(window) with no rarity rebuild.
        if len(wanted) < budget and self._stream_positions:
            for first, n in sorted(self._stream_positions.values()):
                for index in range(first, min(first + n, self.info.num_pieces)):
                    if (
                        have_arr[index]
                        or index in self._partials
                        or self._piece_priority[index] <= 0
                        or not peer_arr[index]
                        or not pickable(index)
                    ):
                        continue
                    if take_from(index):
                        break
                if len(wanted) >= budget:
                    break
        # BEP 6 suggest-piece hints outrank plain rarest-first: the sender
        # says these are cheap for it to serve (e.g. still in cache)
        if len(wanted) < budget:
            for index in peer.suggested:
                if (
                    have_arr[index]
                    or index in self._partials
                    or not peer_arr[index]
                    or not pickable(index)
                ):
                    continue
                if take_from(index):
                    break
        if len(wanted) < budget:
            if self._rarity_dirty:
                self._rebuild_rarity()
            done_prefix = 0
            for index in self._rarity_order:
                if have_arr[index]:
                    done_prefix += 1
                    continue
                if (
                    index in self._partials
                    or not peer_arr[index]
                    or not pickable(index)
                ):
                    continue
                if take_from(index):
                    break
            # The order never drops completed pieces on its own, so late
            # in a download every fill wades through a mostly-done list.
            # When the scanned prefix is dominated by finished pieces,
            # schedule a rebuild (vectorized, drops them all at once).
            if done_prefix > 64 and done_prefix * 2 > len(self._rarity_order):
                self._rarity_dirty = True

        if not wanted:
            if peer.peer_choking:
                # The choked-fast path must never trip global endgame:
                # "every granted piece is busy elsewhere" says nothing
                # about the swarm as a whole.
                peer.fill_starved = True
                return
            if self._wanted_remaining() > self._tail_threshold():
                # Everything THIS peer can see is requested somewhere,
                # but the download is nowhere near its tail — that is
                # CONTENTION, not endgame. Entering endgame here floods
                # the swarm: every received block then broadcasts
                # cancels and re-runs eager refills (measured in an
                # 8-leech mesh: mid-download endgame entry put a cancel
                # broadcast plus an O(pieces) scan behind every block).
                # Mark starved; the 50 ms gate paces the rescans.
                # (Checked BEFORE building `remaining` — the contended
                # path must not pay the O(missing x blocks) comprehension
                # it is about to discard.)
                peer.fill_starved = True
                return
            # Endgame: everything missing is in flight somewhere — duplicate
            # requests so one slow peer can't stall completion.
            remaining = [
                blk
                for i in self.bitfield.missing()
                if peer_arr[i]
                and pickable(i)
                and self._piece_priority[i] > 0
                for blk in self._missing_blocks(i)
                if blk not in peer.inflight
            ]
            if not remaining:
                peer.fill_starved = True
                return
            self._endgame = True
            random.shuffle(remaining)
            wanted = remaining[:budget]

        peer.fill_starved = len(wanted) < budget
        if not peer.inflight:
            # fresh pipeline: restart the snub clock so an idle-but-honest
            # peer isn't condemned for the time it spent choked
            peer.last_block_rx = time.monotonic()
        # one coalesced write + drain for the whole batch: a drain per
        # Request yields to the event loop per 16 KiB asked for
        proto.raise_if_closing(peer.writer)
        sent_at = time.monotonic()
        for blk in wanted:
            peer.inflight.add(blk)
            peer.req_sent_at[blk] = sent_at  # block-RTT anchor (obs/swarm)
            if peer.peer_choking:
                peer.inflight_choked.add(blk)  # issued under an allowed-fast grant
            self._inflight_add(blk)
            peer.writer.write(proto.encode_message(proto.Request(*blk)))
        await peer.writer.drain()
        self._swarm_obs.on_depth(self._obs_key(peer), len(peer.inflight))

    async def _ingest_block(self, peer: PeerConnection, index, begin, block) -> None:
        """(torrent.ts:183-193) + assembly, verification, have broadcast."""
        if not validate_received_block(self.info, index, begin, len(block)):
            raise proto.ProtocolError("invalid piece block geometry")
        if self.paused:
            # blocks served before the peer processed our pause-time
            # cancels are dropped (progress must freeze; they'll be
            # re-requested after resume)
            return
        blk = (index, begin, len(block))
        req_at = peer.req_sent_at.pop(blk, None)
        if blk in peer.inflight:
            peer.inflight.discard(blk)
            peer.inflight_choked.discard(blk)
            self._inflight_release(blk)
        peer.bytes_down += len(block)
        peer.last_block_rx = time.monotonic()
        peer.snubbed_until = 0.0  # delivering redeems
        peer.rejects_since_block = 0
        okey = self._obs_key(peer)
        # block round-trip + byte accounting (obs/swarm); the RTT also
        # feeds the shared log2 family SLO p99_ms=…:block_rtt reads
        self._swarm_obs.on_block(
            okey, len(block),
            (peer.last_block_rx - req_at) if req_at is not None else None,
        )
        self._swarm_obs.on_depth(okey, len(peer.inflight))
        pacing_s = 0.0
        if self.download_bucket is not None or not self.own_download_bucket.unlimited:
            # pacing inside the peer loop applies TCP backpressure: the
            # reader stops draining this peer until tokens free up. The
            # ``pacing`` flag exempts the peer from the snub sweep for
            # the whole wait — under a low cap with many peers the FIFO
            # queue latency alone can exceed snub_timeout, and cancelling
            # a delivering peer's requests there would churn duplicates.
            peer.pacing = True
            t_pace = time.monotonic()
            try:
                if self.download_bucket is not None:
                    await self.download_bucket.take(len(block))
                await self.own_download_bucket.take(len(block))
            finally:
                peer.pacing = False
                peer.last_block_rx = time.monotonic()
                pacing_s = peer.last_block_rx - t_pace
        # the recv stage owns this block's bytes — plus the download-cap
        # pacing wait, which models a slow link exactly like the socket
        # wait does (the ledger's wire tier ahead of `read`)
        self._recv_charge(pacing_s, len(block))
        if self.bitfield.has(index):
            return  # duplicate from endgame
        partial = self._partials.get(index)
        if partial is None:
            partial = self._partials[index] = _PartialPiece(
                index=index,
                length=piece_length(self.info, index),
                buffer=bytearray(piece_length(self.info, index)),
            )
        if begin in partial.received:
            return
        partial.buffer[begin : begin + len(block)] = block
        partial.received.add(begin)
        partial.contributors.add(
            (peer.peer_id, peer.address[0] if peer.address else None)
        )
        self.downloaded += len(block)

        blk_key = (index, begin, len(block))
        if self._endgame or self._inflight_count[blk_key] > 0:
            # other copies of this block are still in flight (endgame
            # duplication — possibly from an endgame that has since been
            # exited): cancel them on arrival. Keyed on the live
            # duplicate count, not the flag, so no copy is ever
            # downloaded redundantly to completion; outside endgame the
            # count is 0 and this costs one dict lookup.
            await self._cancel_everywhere(blk_key, except_peer=peer)

        if partial.complete:
            await self._finish_piece(partial)
            if self.peers.get(peer.peer_id) is not peer:
                return  # this very peer got banned/dropped by the verify
        # Refill with hysteresis: topping up the one freed slot per block
        # re-runs the picker per block (an O(pieces) scan each — measured
        # at ~40% of a fast transfer's CPU, O(n²) over a download). Let
        # the pipeline drain to half depth, then refill to full. Endgame
        # refills eagerly: duplication wants every slot it can get.
        if (
            self._endgame
            or len(peer.inflight) <= self.config.pipeline_depth // 2
        ):
            await self._fill_pipeline(peer)

    async def _cancel_everywhere(self, blk, except_peer) -> None:
        # snapshot: the sends await, and a peer registering/leaving
        # mid-iteration would mutate the dict under us
        for p in list(self.peers.values()):
            if p is except_peer or blk not in p.inflight:
                continue
            p.inflight.discard(blk)
            p.inflight_choked.discard(blk)
            p.req_sent_at.pop(blk, None)
            self._inflight_release(blk)
            self._swarm_obs.on_endgame_cancel(self._obs_key(p))
            try:
                await proto.send_message(p.writer, proto.Cancel(*blk))
            except (ConnectionError, OSError):
                pass

    async def _finish_piece(self, partial: _PartialPiece) -> str:
        """Verify → persist → have-broadcast (the §8.3 missing hook).

        Returns an outcome: ``"ok"``, ``"corrupt"`` (hash mismatch),
        ``"io_error"`` (persist failed), or ``"stale"`` (another path
        already finished this piece). Callers that attribute blame — the
        webseed loop's per-URL strike counter — must distinguish corrupt
        data from a local disk problem.

        With the GPU hasher, completed pieces from concurrent peers are
        verified as one device batch (the swarm-ingest face of the hash
        plane); otherwise per-piece hashlib off-thread.
        """
        if self._partials.get(partial.index) is not partial:
            # Another path (endgame peer vs webseed) already finished or
            # reset this piece — finishing it twice would double-count
            # stats and KeyError on the second removal.
            return "stale"
        del self._partials[partial.index]
        data = bytes(partial.buffer)
        expected = self.info.pieces[partial.index]
        if not await self._verify_piece_data(partial.index, data, expected):
            log.warning("piece %d failed verification; re-requesting", partial.index)
            self.downloaded -= partial.length  # don't count poisoned data
            self._credit_corruption(partial.contributors)
            return "corrupt"
        self._absolve(partial.contributors)
        base = partial.index * self.info.piece_length
        try:
            if len(data) <= INLINE_IO_MAX:
                self._write_piece(base, data)  # µs-scale pwrite: no hop
            else:
                await asyncio.to_thread(self._write_piece, base, data)
        except StorageError as e:
            log.error("failed to persist piece %d: %s", partial.index, e)
            return "io_error"
        self.bitfield.set(partial.index)
        self._notify_piece(partial.index)
        if self._piece_priority[partial.index] > 0:
            self._wanted_missing = max(0, self._wanted_missing - 1)
        if self.bitfield.count() % 16 == 0:
            self._checkpoint()  # periodic progress checkpoint
        # snapshot: each send awaits, and an inbound peer registering
        # during the broadcast mutates self.peers (observed as
        # "dictionary keys changed during iteration" killing the
        # ingesting peer's loop in an 8-leech fanout swarm)
        for p in list(self.peers.values()):
            if self.peers.get(p.peer_id) is not p:
                continue  # dropped during an earlier send's await
            try:
                await proto.send_message(p.writer, proto.Have(index=partial.index))
                if p.am_interested:
                    await self._update_interest(p)
            except (ConnectionError, OSError):
                # a dead writer here must not tear down the INGESTING
                # peer's loop, and interest updates on a dropped peer
                # would assign inflight blocks nothing will ever release
                pass
        await self._maybe_completed()
        return "ok"

    async def _maybe_completed(self) -> None:
        """Transition to seeding once every *wanted* piece is on disk.

        With the default everything-wanted mask this is the classic
        bitfield-complete transition; under file selection the torrent
        seeds what it has once the selection is satisfied (``left`` is 0,
        so the tracker gets its BEP 3 ``completed``).
        """
        if self.state != TorrentState.DOWNLOADING:
            return
        self._recount_wanted()  # authoritative at the decision point
        if self._wanted_missing:
            return
        self.state = TorrentState.SEEDING
        self._endgame = False
        # the download's tail recv charges must be attributable NOW — a
        # doctor/bench reading /v1/pipeline right after completion must
        # not miss the last partial batch
        self._recv_flush()
        if not self._completed_reported:
            # BEP 3: `completed` at most once per download — a piece
            # lost (BEP 54) and re-fetched, or a selection widened and
            # re-satisfied, must not inflate tracker snatch counts
            self._pending_completed = True
            self._completed_reported = True
        self._checkpoint()
        self.on_complete.set()
        self.request_peers()  # announce `completed` promptly

    def _write_piece(self, base: int, data: bytes) -> None:
        for off in range(0, len(data), BLOCK_SIZE):
            self.storage.set(base + off, data[off : off + BLOCK_SIZE])

    def _credit_corruption(self, contributors) -> None:
        """Failure detection: strike every contributor address of a corrupt
        piece (the faulty block can't be attributed more precisely without
        per-block hashes); ban at the threshold. Strikes persist across
        reconnects and decay via ``_absolve`` on verified pieces.
        """
        for peer_id, _ in contributors:
            peer = self.peers.get(peer_id)
            if peer is not None:
                peer.corrupt_pieces += 1
                self._swarm_obs.on_corrupt(self._obs_key(peer))
        # one corrupt piece = one strike per ADDRESS — two NATed peers
        # sharing an IP must not double-strike it for the same failure
        for ip in {ip for _, ip in contributors}:
            if ip is None or ip in self._banned:
                continue
            if (
                ip not in self._corruption
                and len(self._corruption) >= MAX_CORRUPTION_IPS
            ):
                # strike table at capacity: forget the least-incriminated
                # address rather than grow per attacker-minted IP
                drop = min(self._corruption, key=self._corruption.__getitem__)
                del self._corruption[drop]
            self._corruption[ip] += 1
            if self._corruption[ip] >= self.config.max_corrupt_pieces:
                if len(self._banned) >= MAX_BANNED_IPS:
                    # ban list full: the oldest ban ages out (FIFO) — an
                    # attacker cycling addresses churns the list instead
                    # of growing it for the life of the session
                    del self._banned[next(iter(self._banned))]
                self._banned[ip] = None
                log.warning(
                    "banning %s: %d corrupt pieces", ip, self._corruption[ip]
                )
                for p in list(self.peers.values()):
                    if p.address and p.address[0] == ip:
                        self._drop_peer(p)

    def _absolve(self, contributors) -> None:
        """A verified piece sheds one strike per contributor address."""
        for ip in {ip for _, ip in contributors}:
            if ip is not None and self._corruption[ip] > 0:
                self._corruption[ip] -= 1

    # ------------------------------------------------- ingest verification

    async def _verify_piece_data(self, index: int, data: bytes, expected: bytes) -> bool:
        """One piece's hash check, batched onto the GPU with ``hasher="gpu"``.

        Concurrent finishers pile into ``_verify_pending`` and a single
        micro-batch flush hashes them all in one device launch; callers
        await their own piece's future. CPU mode: hashlib off-thread.
        v2 torrents (session/v2.py): the expected digest is the piece's
        merkle subtree root — SHA-256 leaves folded per BEP 52, off the
        event loop (≤64 leaves per piece; the batched device planes pay
        off on the full-recheck path, not per-piece ingest).
        """
        if self.v2:
            from torrent_tpu_torch.models.merkle import piece_root_cpu

            pad = self.info.piece_pad_leaves[index]
            if (
                self.config.hasher == "gpu"
                and len(data) == self.info.piece_length
                and pad == self.info.piece_length // 16384
            ):
                # Full-subtree piece: batch onto the device leaf plane
                # with every other concurrent finisher — the same
                # micro-batch machinery as v1 (_flush_verify_batch routes
                # on self.v2); tail pieces (short data / oversized pad)
                # fold on the CPU below.
                #
                # The verify leaves the event loop either way, which is
                # what ingest latency cares about; a device failure
                # reaches the waiters as the error (_flush_verify_batch).
                fut: asyncio.Future = asyncio.get_running_loop().create_future()
                self._verify_pending.append((index, data, expected, fut))
                if not self._verify_flushing:
                    self._verify_flushing = True
                    self._spawn(self._flush_verify_batch(), name="verify-batch")
                return await fut
            if len(data) <= INLINE_IO_MAX:
                return piece_root_cpu(data, pad) == expected
            root = await asyncio.to_thread(piece_root_cpu, data, pad)
            return root == expected
        if self.config.hasher != "gpu":
            if len(data) <= INLINE_IO_MAX:
                return hashlib.sha1(data).digest() == expected
            digest = await asyncio.to_thread(lambda: hashlib.sha1(data).digest())
            return digest == expected
        # no shared verifier: build the torrent's own at first use, so a
        # "gpu" torrent never hashes a finished piece with hashlib
        # (constructed off the loop: a first CUDA use loads the kernel)
        if self.verifier is None:
            from torrent_tpu_torch.models.verifier import GPUVerifier

            verifier = await asyncio.to_thread(
                GPUVerifier,
                self.info.piece_length,
                batch_size=self.config.verify_batch_size,
                device=self.config.device,
            )
            if self.verifier is None:  # a concurrent finisher may have set one
                self.verifier = verifier
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._verify_pending.append((index, data, expected, fut))
        if not self._verify_flushing:
            self._verify_flushing = True
            self._spawn(self._flush_verify_batch(), name="verify-batch")
        return await fut

    async def _flush_verify_batch(self) -> None:
        """Drain the pending-verification queue in device batches.

        A device error fails the batch: every waiter gets the exception
        (its ``_finish_piece`` raises, the piece is no longer a partial
        and is re-requested), and no piece gets a hashlib verdict."""
        try:
            # one event-loop tick lets concurrent _finish_piece calls join
            await asyncio.sleep(0)
            while self._verify_pending:
                batch = self._verify_pending[: self.config.verify_batch_size]
                del self._verify_pending[: len(batch)]
                pieces = [b[1] for b in batch]
                expected = [b[2] for b in batch]
                device_fn = (
                    self._verify_batch_device_v2 if self.v2 else self._verify_batch_device
                )
                try:
                    ok = await asyncio.to_thread(device_fn, pieces, expected)
                except Exception as e:
                    log.error("gpu ingest verify failed on %d pieces: %s", len(batch), e)
                    for _, _, _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                    continue
                for (_, _, _, fut), good in zip(batch, ok):
                    if not fut.done():
                        fut.set_result(bool(good))
        finally:
            self._verify_flushing = False
            for idx, _, _, fut in self._verify_pending:
                if not fut.done():
                    fut.set_result(False)  # torn down mid-flight: re-request
            self._verify_pending.clear()

    def _verify_batch_device(self, pieces: list[bytes], expected: list[bytes]):
        from torrent_tpu_torch.ops.padding import digests_to_words

        digests = self.verifier.hash_pieces(pieces)
        want = digests_to_words(expected)
        got = digests_to_words(digests)
        return (got == want).all(axis=1)

    def _verify_batch_device_v2(self, pieces: list[bytes], expected: list[bytes]):
        """Batched BEP 52 ingest verify: ONE leaf-plane dispatch plus the
        fused merkle pair reduction for every concurrently-finishing
        full-subtree piece (only those are queued — _verify_piece_data
        folds tails on the CPU, where the pad geometry is per-piece)."""
        from torrent_tpu_torch.models.merkle import (
            piece_roots_from_leaves,
            words32_to_digests,
        )
        from torrent_tpu_torch.models.v2 import _leaf_words_from_chunks

        lpp = self.info.piece_length // 16384
        # each full piece IS a block-aligned chunk: feed them straight to
        # the leaf plane instead of joining into a second copy of the
        # whole batch (256 x 1 MiB pieces would duplicate ~256 MiB)
        leaves = _leaf_words_from_chunks(
            iter(pieces), sum(len(p) for p in pieces), self.config.device
        )
        roots = words32_to_digests(
            piece_roots_from_leaves(leaves, lpp, self.config.device)
        )
        return [r == e for r, e in zip(roots, expected)]

    # ------------------------------------------------------------- seeding

    async def _piece_lost(self, index: int) -> None:
        """BEP 54 self-healing: an announced piece turned unreadable.

        BEP 3 cannot retract a Have, so without this a seed with a bad
        sector serves refusals forever while peers keep asking. Instead:
        drop the piece from our bitfield (the picker re-wants it and the
        swarm re-supplies it), fall back from SEEDING if needed, tell
        lt_donthave-capable peers the truth, and re-evaluate interest —
        we may need to fetch again from peers we'd gone not-interested on.
        """
        if not self.bitfield.has(index):
            return
        log.warning("piece %d lost (read failure under an announced piece)", index)
        self.bitfield.set(index, False)
        self._serve_cache.pop(index, None)
        # without this the re-downloaded piece verifies in memory but
        # every block write is suppressed as a duplicate and the disk
        # keeps the bad bytes
        self.storage.unmark_piece_written(index)
        self._rarity_dirty = True
        self._recount_wanted()
        if self.state == TorrentState.SEEDING and self._wanted_missing:
            self.state = TorrentState.DOWNLOADING
            self.on_complete.clear()
            self._spawn_seed_loops()
            self.request_peers()
        self._checkpoint()
        payload = ext.encode_donthave(index)
        for p in list(self.peers.values()):
            if self.peers.get(p.peer_id) is not p:
                continue  # dropped during an earlier send's await: an
                # interest update on it would assign inflight blocks
                # nothing will ever release (same hazard as the Have
                # broadcast in _finish_piece)
            try:
                if p.ext.enabled and p.ext.lt_donthave_id:
                    await proto.send_message(
                        p.writer, proto.Extended(p.ext.lt_donthave_id, payload)
                    )
                await self._update_interest(p)
            except (ConnectionError, OSError):
                continue

    async def _serve_read_retry(self, make_read):
        """Serve-path read with ONE retry for transient failures.

        A momentary failure (fd exhaustion under connection fanout, EIO
        from a busy disk, an interrupted syscall) is not piece loss:
        treating it as permanent retracts the piece, demotes a seed to
        DOWNLOADING, and re-downloads from the swarm. Only an error that
        persists across the retry — or one that is structurally permanent
        (missing file, short read) — reaches the ``_piece_lost``
        self-heal path.
        """
        try:
            return await make_read()
        except StorageError as e:
            cause = e.__cause__
            # no OSError cause = the storage layer's own no-such-file /
            # short-read diagnosis: retrying cannot change the file's
            # length. ENOENT is likewise structural.
            if not isinstance(cause, OSError) or cause.errno == errno.ENOENT:
                raise
            log.warning("serve read transient error, retrying once: %s", e)
            await asyncio.sleep(0.05)
            return await make_read()

    async def _reactor_serve(self, key, item) -> None:
        """ReactorPool drain callback: resolve the peer (it may have
        left while the request queued) and serve. Connection-level
        failures tear the peer down here — the worker pool must survive
        any one peer's death."""
        peer = self.peers.get(key)
        if peer is None:
            return
        index, begin, length = item
        try:
            await self._serve_request(peer, index, begin, length)
        except (proto.ProtocolError, ConnectionError, OSError):
            # a torn frame (zero-copy mid-send failure) or a dead socket:
            # the stream is unusable — abort, don't let it desync
            transport = getattr(peer.writer, "transport", None)
            if transport is not None:
                try:
                    transport.abort()
                except Exception:
                    pass
            self._drop_peer(peer)

    async def _serve_zero_copy(self, peer: PeerConnection, index, begin, length) -> str | None:
        """Try the serve_plane egress engine: ``"sendfile"``/``"preadv"``
        when the span went out zero-copy(-ish), ``None`` when the caller
        must serve through the buffered piece-cache path. Only plaintext
        writers are eligible — MSE wraps every byte in RC4, so splicing
        raw file bytes past the cipher would corrupt the stream."""
        from torrent_tpu_torch.net.mse import WrappedWriter

        if isinstance(peer.writer, WrappedWriter):
            return None
        offset = index * self.info.piece_length + begin
        if self._egress.classify(offset, length) is None:
            return None
        # the span is fd-backed and EOF-checked: debit the upload caps
        # now (the copy path debits after its read for the same reason —
        # a read that can still fail must not burn cap budget; here the
        # only failure mode left is the connection itself)
        if self.upload_bucket is not None and not self.upload_bucket.unlimited:
            await self.upload_bucket.take(length)
        if not self.own_upload_bucket.unlimited:
            await self.own_upload_bucket.take(length)
        t0 = time.monotonic()
        path = await self._egress.send_block(peer.writer, index, begin, length)
        if path is not None:
            self._egress_charge(time.monotonic() - t0, length)
        return path

    def _serve_done(self, peer: PeerConnection, length: int, path: str) -> None:
        """Common post-egress accounting: transfer counters, swarm +
        serve telemetry (the fallback matrix), and the DRR deficit
        spend that makes the choke economics bite."""
        peer.bytes_up += length
        self.uploaded += length
        peer.last_tx = time.monotonic()
        okey = self._obs_key(peer)
        self._swarm_obs.on_upload(okey, length)
        self._serve_obs.on_egress(okey, path, length)
        self._serve_econ.charge(peer.peer_id, length)

    async def _serve_request(self, peer: PeerConnection, index, begin, length) -> None:
        """request handler (torrent.ts:158-176), gated on our choke state.

        BEP 6 changes both gates: a choked fast peer may still fetch its
        allowed-fast pieces, and anything we won't serve is rejected
        explicitly instead of silently dropped.
        """
        if not validate_requested_block(self.info, index, begin, length):
            raise proto.ProtocolError("invalid request")

        async def refuse():
            # fast peers get an explicit reject; BEP 3 peers silent-drop
            if peer.fast:
                await proto.send_message(
                    peer.writer, proto.RejectRequest(index, begin, length)
                )

        if self.paused:
            # BEP 6 contract: anything we won't serve is rejected
            # explicitly (a request can race our pause-time Choke)
            await refuse()
            return
        if peer.am_choking and not (peer.fast and index in peer.allowed_fast_out):
            # the economics said no: count it, so a crowd hammering
            # through its choke shows up in the serve telemetry even
            # though BEP 3 peers get no wire-level answer
            self._serve_obs.on_reject(self._obs_key(peer), "choked")
            await refuse()
            return
        if not self.bitfield.has(index):
            await refuse()
            return
        if (
            self.super_seeding()
            and not peer.ss_exempt
            and index not in peer.ss_advertised
        ):
            # BEP 16: only revealed pieces are served — a peer asking for
            # something we never advertised is buggy or probing (peers
            # that saw the real bitfield before the mode flipped on are
            # exempt; refusing them would stall legitimate requests)
            await refuse()
            return
        # Zero-copy egress first (serve_plane/egress.py): an fs-backed
        # span that maps contiguously into one file skips the piece
        # cache entirely — header + kernel splice (or one pooled preadv)
        # instead of pread/slice/append. Anything ineligible (memory
        # backends, pad spans, file boundaries, MSE) falls through to
        # the buffered tiers below, which remain the universal path.
        zpath = await self._serve_zero_copy(peer, index, begin, length)
        if zpath is not None:
            self._serve_done(peer, length, zpath)
            return
        # Serve through a small LRU of whole pieces: peers request a
        # piece as ~16-64 sequential 16 KiB blocks, so reading the piece
        # once turns 16+ random preads into one. Concurrent misses on the
        # same piece share ONE read via _serve_pending; huge pieces skip
        # the cache (whole-piece reads would amplify one-block fetches).
        if self.info.piece_length > self.config.serve_cache_max_piece:
            try:
                block = await self._serve_read_retry(
                    lambda: asyncio.to_thread(
                        self.storage.get,
                        index * self.info.piece_length + begin,
                        length,
                    )
                )
            except StorageError as e:
                log.error("serving piece %d failed: %s", index, e)
                await self._piece_lost(index)
                await refuse()
                return
        elif self.info.piece_length <= INLINE_IO_MAX:
            # small pieces: a synchronous pread is cheaper than the
            # thread hop the whole-piece cache path would pay
            piece = self._serve_cache.pop(index, None)
            if piece is None:

                async def _read_small():
                    # stays on the event loop: a sync pread here is
                    # cheaper than the thread hop (see branch comment)
                    return self.storage.read_piece(index)

                try:
                    piece = await self._serve_read_retry(_read_small)
                except StorageError as e:
                    log.error("serving piece %d failed: %s", index, e)
                    await self._piece_lost(index)
                    await refuse()
                    return
            self._serve_cache[index] = piece  # insert/LRU-refresh at tail
            while len(self._serve_cache) > self.config.serve_cache_pieces:
                self._serve_cache.pop(next(iter(self._serve_cache)))
            block = piece[begin : begin + length]
        else:
            piece = self._serve_cache.get(index)
            if piece is None:

                def _shared_read():
                    # a retry lands AFTER the failed task's done-callback
                    # popped it, so it installs (or joins) a fresh one
                    task = self._serve_pending.get(index)
                    if task is None:
                        task = asyncio.ensure_future(
                            asyncio.to_thread(self.storage.read_piece, index)
                        )
                        self._serve_pending[index] = task
                        task.add_done_callback(
                            lambda _t, i=index: self._serve_pending.pop(i, None)
                        )
                    return asyncio.shield(task)

                try:
                    piece = await self._serve_read_retry(_shared_read)
                except StorageError as e:
                    log.error("serving piece %d failed: %s", index, e)
                    await self._piece_lost(index)
                    await refuse()
                    return
                self._serve_cache[index] = piece
                while len(self._serve_cache) > self.config.serve_cache_pieces:
                    self._serve_cache.pop(next(iter(self._serve_cache)))
            else:
                self._serve_cache.pop(index)  # LRU refresh: reinsert at tail
                self._serve_cache[index] = piece
            block = piece[begin : begin + length]
        if len(block) != length:
            log.error("serving piece %d: short read", index)
            return
        if self.upload_bucket is not None and not self.upload_bucket.unlimited:
            # client-global upload cap; debited only once the block read
            # succeeded so storage errors don't burn cap budget
            await self.upload_bucket.take(length)
        if not self.own_upload_bucket.unlimited:
            await self.own_upload_bucket.take(length)  # per-torrent layer
        t0 = time.monotonic()
        await proto.send_message(peer.writer, proto.Piece(index, begin, block))
        self._egress_charge(time.monotonic() - t0, length)
        self._serve_done(peer, length, "copy")

    # ---------------------------------------------------------- choke loop

    async def _release_snubbed(self) -> None:
        """Anti-snubbing: a peer that stopped delivering blocks while we
        have requests outstanding to it gets those requests cancelled and
        released, is flagged snubbed (no fresh requests outside endgame
        until it delivers again), and the freed blocks are immediately
        re-offered to every other ready peer. The connection survives —
        it still counts for availability and may serve later."""
        now = time.monotonic()
        released_any = False
        for p in list(self.peers.values()):  # awaits below; dict may mutate
            if p.pacing:
                continue  # queued in the download cap, not stalled
            if p.inflight and now - p.last_block_rx > self.config.snub_timeout:
                log.debug(
                    "peer %s snubbed: releasing %d in-flight blocks",
                    p.peer_id[:8].hex(),
                    len(p.inflight),
                )
                await self._cancel_and_release(p)
                # time-limited, not permanent: after the cooldown the peer
                # is retried even without having delivered (a transient
                # stall of EVERY peer must not deadlock the session)
                p.snubbed_until = now + 2 * self.config.snub_timeout
                self._swarm_obs.on_snub(self._obs_key(p))
                released_any = True
        if released_any:
            for p in list(self.peers.values()):
                if not p.snubbed and not p.peer_choking and p.am_interested:
                    try:
                        await self._fill_pipeline(p)
                    except (ConnectionError, OSError):
                        # a reset socket whose peer-loop hasn't noticed
                        # yet must not kill the CHOKE loop for the
                        # torrent's remaining lifetime
                        continue

    async def _choke_loop(self) -> None:
        """Unchoke by DRR deficit + one seeded optimistic slot (BEP 3
        semantics, serve_plane/choke.py economics).

        Leeching weighs candidates by download rate (tit-for-tat);
        seeding by upload rate (serve whoever drains us fastest). The
        rates feed :class:`ChokeEconomics` as DRR weights: deficits
        accrue per round, actual egress spends them (``_serve_done``),
        and a candidate that keeps losing keeps accruing — so the
        ranking preserves the old rate order while making starvation
        structurally impossible. Round duration, slot occupancy, and
        optimistic rotation land in the serve telemetry."""
        econ = self._serve_econ
        while not self._stopping:
            await asyncio.sleep(self.config.choke_interval)
            if self.paused:
                continue  # pause() choked everyone; stay that way
            t0 = time.monotonic()
            await self._release_snubbed()
            peers = list(self.peers.values())
            interested = [p for p in peers if p.peer_interested]
            seeding = self.state == TorrentState.SEEDING
            rates = {
                p.peer_id: (p.upload_rate() if seeding else p.download_rate())
                for p in interested
            }
            # normalize to DRR weights: the fastest reciprocator accrues
            # a full quantum per round, the rest proportionally (with
            # the economics' floor so newcomers accrue too)
            top = max(rates.values(), default=0.0)
            econ.slots = max(0, self.config.unchoke_slots)
            verdict = econ.round(
                {pid: (r / top if top > 0 else 0.0) for pid, r in rates.items()}
            )
            unchoke_ids = set(verdict.all_unchoked())
            for p in peers:
                should_unchoke = p.peer_id in unchoke_ids
                try:
                    if should_unchoke and p.am_choking:
                        p.am_choking = False
                        self._swarm_obs.on_state(self._obs_key(p), am_choking=False)
                        await proto.send_message(p.writer, proto.Unchoke())
                    elif not should_unchoke and not p.am_choking:
                        p.am_choking = True
                        self._swarm_obs.on_state(self._obs_key(p), am_choking=True)
                        await proto.send_message(p.writer, proto.Choke())
                except (ConnectionError, OSError):
                    pass
                p.snapshot_rate()
            opt_peer = (
                self.peers.get(verdict.optimistic)
                if verdict.optimistic is not None
                else None
            )
            self._serve_obs.on_choke_round(
                time.monotonic() - t0,
                unchoked=len(verdict.unchoked),
                interested=len(interested),
                optimistic=self._obs_key(opt_peer) if opt_peer else None,
                rotated=verdict.rotated,
            )

    def _dialable_addr(self, p: PeerConnection) -> tuple[str, int] | None:
        """The address other peers could actually connect to.

        Outbound connections dialed the peer's listen port; inbound ones
        carry an ephemeral source port, so they're only gossipable when
        the peer advertised its real port via BEP 10's ``p`` key. Both
        families gossip — encode_pex routes v4 to added/dropped and v6
        to added6/dropped6 (BEP 11).
        """
        if p.address is None:
            return None
        # dual-stack listeners report v4 peers as ::ffff:a.b.c.d —
        # collapse so the compact packers route them to the v4 field
        from torrent_tpu_torch.net.types import normalize_peer_host

        host = normalize_peer_host(p.address[0])
        if not p.inbound:
            return (host, p.address[1])
        if p.ext.listen_port:
            return (host, p.ext.listen_port)
        return None

    async def _pex_round(self) -> None:
        """Send each PEX-capable peer the delta of connected addresses."""
        current = {
            addr
            for p in self.peers.values()
            if (addr := self._dialable_addr(p)) is not None
        }
        for p in list(self.peers.values()):
            if not (p.ext.enabled and p.ext.ut_pex_id):
                continue
            mine = self._dialable_addr(p)
            added = current - p.pex_sent - ({mine} if mine else set())
            dropped = p.pex_sent - current
            if not added and not dropped:
                continue
            try:
                await proto.send_message(
                    p.writer,
                    proto.Extended(p.ext.ut_pex_id, ext.encode_pex(added, dropped)),
                )
            except (ConnectionError, OSError):
                continue
            p.pex_sent = (p.pex_sent | added) - dropped

    async def _pex_loop(self) -> None:
        while not self._stopping:
            await asyncio.sleep(self.config.pex_interval)
            await self._pex_round()

    # ------------------------------------------------------------ webseeds

    def _pick_webseed_pieces(self, n: int) -> list[int]:
        """Missing pieces nobody is working on, stream windows first,
        then rarest (in the swarm) — the webseed complements peers
        instead of racing them.

        A STALE partial (blocks received but none in flight — typically
        a resumed checkpoint with no peer holding the piece) is fair
        game: without this, a webseed-only session could never finish a
        resumed partial and would sit short of completion forever. The
        HTTP fetch re-downloads the whole piece; the reserve/handback
        logic in the loop already covers racing late wire blocks.
        """
        if self._rarity_dirty:
            self._rebuild_rarity()
        # per-piece mirror answers this in O(pieces-with-requests); the
        # old per-block Counter walk grew to every block key ever
        # requested over a download (entries never prune at zero)
        busy = {i for i, c in self._piece_inflight.items() if c > 0}
        picked = []

        def eligible(index: int) -> bool:
            if self.bitfield.has(index) or index in busy:
                return False
            if self._piece_priority[index] <= 0:
                return False
            p = self._partials.get(index)
            if p is not None and (p.webseed or not p.received):
                return False  # reserved by another webseed loop
            return True

        # stream readers are latency-bound on exactly these pieces — the
        # same priority the wire picker gives them (the delta-path window
        # advance never rebuilds the rarity order, so consult directly)
        for first, count in sorted(self._stream_positions.values()):
            for index in range(first, min(first + count, self.info.num_pieces)):
                if eligible(index) and index not in picked:
                    picked.append(index)
                    if len(picked) >= n:
                        return picked
        for index in self._rarity_order:
            if eligible(index) and index not in picked:
                picked.append(index)
                if len(picked) >= n:
                    break
        return picked

    def _spawn_seed_loops(self) -> None:
        """Start one fetch loop per BEP 19 webseed and BEP 17 httpseed.

        Re-entrant: callers re-open a finished download (selection
        widening, BEP 54 piece loss) without knowing whether the old
        loops already exited — a URL whose loop is still alive (mid-fetch
        or in a backoff sleep when the re-open happened) is skipped, or
        every lost/heal cycle would stack another loop per URL.
        """
        for url in self.web_seed_urls:
            self._spawn_seed_loop_once(url, bep17=False)
        for url in self.http_seed_urls:
            self._spawn_seed_loop_once(url, bep17=True)

    def _spawn_seed_loop_once(self, url: str, bep17: bool) -> None:
        key = ("h" if bep17 else "w") + url
        task = self._seed_loop_tasks.get(key)
        if task is not None and not task.done():
            return
        self._seed_loop_tasks[key] = self._spawn(
            self._webseed_loop(url, bep17=bep17),
            name=f"{'httpseed' if bep17 else 'webseed'}-{url[:24]}",
        )

    async def _webseed_loop(self, url: str, bep17: bool = False) -> None:
        """BEP 19 (byte-range) / BEP 17 (piece-keyed) HTTP seeding: fill
        missing pieces from an HTTP seed; every fetched piece passes the
        same verify→persist→have path as wire pieces.

        A webseed serving corrupt data has no wire contributors for the
        strike system to ban, so the loop tracks consecutive hash
        failures itself: backoff per failure, URL disabled at the
        configured threshold (a hot refetch loop otherwise).
        """
        from torrent_tpu_torch.session.webseed import (
            WebSeedError,
            fetch_piece,
            fetch_piece_bep17,
        )

        if bep17:
            def fetch(index: int) -> bytes:
                return fetch_piece_bep17(url, self.metainfo.info_hash, self.info, index)
        else:
            def fetch(index: int) -> bytes:
                return fetch_piece(url, self.storage, self.info, index)

        consecutive_failures = 0
        while not self._stopping and self._wanted_remaining():
            if self.paused:
                await asyncio.sleep(1.0)
                continue
            picked = self._pick_webseed_pieces(self.config.webseed_concurrency)
            if not picked:
                await asyncio.sleep(1.0)
                continue
            # reserve so peers/other webseeds skip these pieces meanwhile
            reserved = []
            for index in picked:
                existing = self._partials.get(index)
                if existing is not None:
                    # ADOPT a stale wire partial in place (resumed, or a
                    # dropped peer's leftovers): its received blocks and
                    # their downloaded-bytes accounting survive — on
                    # failure the handback returns them to the block
                    # scheduler, on success `already` subtracts them
                    existing.webseed = True
                    reserved.append(existing)
                    continue
                partial = _PartialPiece(
                    index=index,
                    length=piece_length(self.info, index),
                    buffer=bytearray(piece_length(self.info, index)),
                    webseed=True,
                )
                self._partials[index] = partial
                reserved.append(partial)
            try:
                datas = await asyncio.gather(
                    *(asyncio.to_thread(fetch, p.index) for p in reserved)
                )
            except WebSeedError as e:
                for p in reserved:
                    if self._partials.get(p.index) is p:
                        if p.received:
                            # endgame peers delivered blocks meanwhile —
                            # hand the partial (and their progress) back
                            # to the block scheduler instead of discarding
                            p.webseed = False
                        else:
                            del self._partials[p.index]
                log.warning("webseed %s failed: %s; backing off", url, e)
                await asyncio.sleep(self.config.webseed_retry)
                continue
            hash_failures = 0
            for partial, data in zip(reserved, datas):
                if self._partials.get(partial.index) is not partial:
                    # An endgame peer completed this piece while the HTTP
                    # fetch was in flight — its _finish_piece already ran;
                    # finishing ours too would double-count stats.
                    continue
                # Count only bytes the webseed actually contributed (endgame
                # peers may have delivered blocks that ingest already
                # counted), and clear those peers from the blame set — the
                # buffer is now entirely the webseed's bytes, so a corrupt
                # fetch must not strike innocent wire contributors.
                already = sum(
                    min(BLOCK_SIZE, partial.length - off) for off in partial.received
                )
                partial.buffer[:] = data
                partial.contributors.clear()
                partial.received = set(range(0, partial.length, BLOCK_SIZE))
                self.downloaded += partial.length - already
                outcome = await self._finish_piece(partial)
                if outcome == "corrupt":
                    hash_failures += 1
            if hash_failures:
                consecutive_failures += hash_failures
                if consecutive_failures >= self.config.webseed_max_failures:
                    log.error(
                        "webseed %s served %d corrupt pieces; disabling",
                        url,
                        consecutive_failures,
                    )
                    return
                log.warning(
                    "webseed %s served %d corrupt piece(s); backing off",
                    url,
                    hash_failures,
                )
                await asyncio.sleep(self.config.webseed_retry)
            else:
                consecutive_failures = 0

    async def _keepalive_loop(self) -> None:
        while not self._stopping:
            await asyncio.sleep(self.config.keepalive_interval)
            for p in list(self.peers.values()):
                try:
                    await proto.send_message(p.writer, proto.KeepAlive())
                except (ConnectionError, OSError):
                    self._drop_peer(p)

    async def _idle_sweep_loop(self) -> None:
        """Drop peers silent past ``peer_timeout`` (the per-message
        ``wait_for`` this replaces — see _peer_loop), with the
        which-slot-is-dead decision delegated to :class:`AcceptGate`.

        Teardown must be unconditional: a graceful ``close()`` waits for
        the transport's send buffer to drain, and a dead peer that
        stopped ACKing mid-upload never drains it — ``connection_lost``
        (and so the peer loop's EOF) would wait on the kernel's TCP
        retransmission timeout. So the sweep aborts the transport when
        one is exposed (TCP/MSE; discards the buffer, fires
        connection_lost now) and does the ``_drop_peer`` bookkeeping
        itself — idempotent against the loop's ``finally`` re-drop. uTP
        writers expose no transport; their ``close()`` FIN path is
        bounded by MAX_RETRANSMITS on its own. Worst-case drop time is
        ``timeout + interval`` (1.25x at the default 240 s timeout; the
        interval floors at 1 s for very short timeouts)."""
        interval = max(1.0, self.config.peer_timeout / 4)
        while not self._stopping:
            await asyncio.sleep(interval)
            # the AcceptGate owns the idle-eviction decision (and its
            # evicted_idle counter — the same object the scenario
            # plane's slowloris suite attacks); rx activity is synced
            # here rather than on every message, which is equivalent at
            # sweep granularity
            now = time.monotonic()
            for p in self.peers.values():
                self._accept_gate.touch(p.peer_id, p.last_rx)
            evicted = self._accept_gate.sweep(now)
            self._serve_obs.on_gate_evictions(len(evicted))
            for peer_id in evicted:
                p = self.peers.get(peer_id)
                if p is None:
                    continue
                log.debug("peer %r idle past timeout — dropping", p.peer_id[:8])
                transport = getattr(p.writer, "transport", None)
                if transport is not None:
                    try:
                        transport.abort()
                    except Exception:
                        pass
                self._drop_peer(p)

    # ------------------------------------------------------------- status

    def _count_encrypted_peers(self) -> int:
        from torrent_tpu_torch.net.mse import WrappedWriter

        return sum(
            1 for p in self.peers.values() if isinstance(p.writer, WrappedWriter)
        )

    def status(self) -> dict:
        return {
            "state": self.state.value,
            "pieces": f"{self.bitfield.count()}/{self.info.num_pieces}",
            "peers": len(self.peers),
            "idle_evicted": self._accept_gate.evicted_idle,
            "downloaded": self.downloaded,
            "uploaded": self.uploaded,
            "left": self.left,
            "endgame": self._endgame,
            "paused": self.paused,
            "super_seeding": self.super_seeding(),
            "wanted_left": self._wanted_missing,
            "sequential": self.config.sequential,
            "download_rate": round(
                sum(p.download_rate() for p in self.peers.values()), 1
            ),
            "encryption": self.config.encryption,
            "encrypted_peers": self._count_encrypted_peers(),
            "stream_readers": len(self._stream_positions),
            "partials": len(self._partials),
            "max_upload_bps": self.config.max_upload_bps,
            "max_download_bps": self.config.max_download_bps,
            "serve": {
                "reactor_running": self._serve_reactor.running,
                "queued": sum(
                    self._serve_reactor.depth(pid) for pid in self.peers
                ),
                "rejected_backpressure": self._serve_reactor.rejected,
                "rejected_per_ip": self._accept_gate.rejected_per_ip,
                "choke_rounds": self._serve_econ.rounds,
                "optimistic_rotations": self._serve_econ.rotations,
                "egress_paths": dict(self._egress.served),
            },
        }
