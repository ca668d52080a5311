"""Per-peer connection state (ref: peer.ts, 27 LoC — extended).

The reference tracks the four BitTorrent state flags in spec-default
position and a bitfield (peer.ts:17-25). A working leech/seed scheduler
additionally needs per-peer in-flight request tracking, transfer
accounting for the choke policy, and liveness timestamps.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from torrent_tpu_torch.net.extension import ExtensionState
from torrent_tpu_torch.utils.bitfield import Bitfield


@dataclass
class PeerConnection:
    peer_id: bytes
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    num_pieces: int
    address: tuple[str, int] | None = None
    # BEP 10 negotiation state (net/extension.py); ``enabled`` is set from
    # the peer's handshake reserved bit 20.
    ext: ExtensionState = field(default_factory=ExtensionState)
    # BEP 6 fast extension, negotiated via reserved bit 0x04 of byte 7
    fast: bool = False
    # pieces we granted this peer (it may request them while we choke it)
    allowed_fast_out: set[int] = field(default_factory=set)
    # _fill_pipeline contention memo: True when the last full pick scan
    # could not fill this peer's budget; with a non-empty pipeline the
    # next scan is then deferred up to 50 ms (see the gate in
    # _fill_pipeline) instead of re-running per received block
    fill_starved: bool = False
    last_fill_at: float = 0.0
    # pieces the peer granted us (requestable while it chokes us)
    allowed_fast_in: set[int] = field(default_factory=set)
    # subset of ``inflight`` that was requested while choked (under an
    # allowed-fast grant); a reject of one of these withdraws the grant
    inflight_choked: set[tuple[int, int, int]] = field(default_factory=set)
    # consecutive RejectRequests with no block delivered in between; a
    # persistently-rejecting (yet unchoked) peer trips the snub gate via
    # this counter — the reject/re-request cycle itself keeps resetting
    # the wall-clock snub timer, so time alone can't catch it
    rejects_since_block: int = 0
    # currently waiting in the client-global download token bucket: the
    # peer IS delivering, it's just queued behind the cap — the snub
    # sweep must not read the queue latency as a stall
    pacing: bool = False
    # BEP 6 suggest-piece hints, most recent FIRST (newest hint wins)
    suggested: list[int] = field(default_factory=list)

    # BEP 3 spec-default flag positions (peer.ts:17-20)
    am_choking: bool = True
    am_interested: bool = False
    peer_choking: bool = True
    peer_interested: bool = False

    bitfield: Bitfield = None  # set in __post_init__
    # blocks we've requested from this peer and not yet received
    inflight: set[tuple[int, int, int]] = field(default_factory=set)
    # BEP 16 super-seeding (seed side): pieces we've revealed to this
    # peer via targeted Haves, and the subset not yet confirmed spread
    # (no OTHER peer has announced them back to us yet)
    ss_advertised: set[int] = field(default_factory=set)
    ss_unconfirmed: set[int] = field(default_factory=set)
    # peers that ever saw our REAL bitfield are exempt from the BEP 16
    # serve gate — hiding pieces we already told them about would just
    # stall their transfers (covers super-seed enabled mid-session and
    # the auto-flip when a super_seed-configured download completes)
    ss_exempt: bool = False

    bytes_down: int = 0  # payload received from peer
    bytes_up: int = 0  # payload sent to peer
    corrupt_pieces: int = 0  # pieces this peer helped fail verification
    # (time, bytes) marks anchoring the rate window. Initialized to the
    # REGISTRATION instant in __post_init__ — a (0.0, 0) default would
    # make the first window span the whole monotonic uptime, reporting a
    # near-zero rate for a peer that just delivered megabytes (the choke
    # policy would then mis-rank every fresh connection, and the swarm
    # telemetry would export the same lie)
    _rate_mark: tuple[float, int] = None  # (time, bytes_down) snapshot
    _up_mark: tuple[float, int] = None  # (time, bytes_up) snapshot
    # when each in-flight request was written (mirror of ``inflight``,
    # maintained at the same mutation sites): block round-trip times for
    # the swarm telemetry's RTT histograms
    req_sent_at: dict[tuple[int, int, int], float] = field(default_factory=dict)
    # memoized swarm-telemetry key (Torrent._obs_key): the per-message
    # accounting path must not rebuild the string per 16 KiB block
    obs_key: str | None = None

    last_rx: float = field(default_factory=time.monotonic)
    last_tx: float = field(default_factory=time.monotonic)
    # registration time: slot recycling must not evict a connection so
    # fresh it hasn't had a chance to express interest yet
    connected_at: float = field(default_factory=time.monotonic)
    # last time a *piece block* arrived (anti-snubbing; last_rx counts any
    # message, keepalives included, so it can't detect a data stall)
    last_block_rx: float = field(default_factory=time.monotonic)
    # stalled-while-owing-blocks: no fresh requests outside endgame until
    # this deadline passes or a block arrives (a permanent flag could
    # deadlock the whole session after a transient network stall)
    snubbed_until: float = 0.0
    # whether the peer connected to us (its address port is then an
    # ephemeral source port, NOT its listen port — PEX must not gossip it)
    inbound: bool = False
    # addresses already PEXed to this peer (BEP 11 sends deltas)
    pex_sent: set[tuple[str, int]] = field(default_factory=set)

    @property
    def snubbed(self) -> bool:
        return time.monotonic() < self.snubbed_until

    def __post_init__(self):
        if self.bitfield is None:
            self.bitfield = Bitfield(self.num_pieces)
        if self._rate_mark is None or self._up_mark is None:
            now = time.monotonic()
            self._rate_mark = (now, self.bytes_down)
            self._up_mark = (now, self.bytes_up)

    def dial_address(self) -> tuple[str, int] | None:
        """The address this peer can be dialed back on: its source IP plus
        the BEP 10 ``p`` listen port when advertised (an inbound peer's
        TCP source port is ephemeral, not its listener)."""
        if self.address is None:
            return None
        port = self.ext.listen_port or self.address[1]
        return (self.address[0], port)

    def download_rate(self) -> float:
        """Bytes/sec received since the last choke-policy snapshot."""
        t0, b0 = self._rate_mark
        dt = time.monotonic() - t0
        if dt <= 0:
            return 0.0
        return (self.bytes_down - b0) / dt

    def upload_rate(self) -> float:
        """Bytes/sec served since the last choke-policy snapshot."""
        t0, b0 = self._up_mark
        dt = time.monotonic() - t0
        if dt <= 0:
            return 0.0
        return (self.bytes_up - b0) / dt

    def snapshot_rate(self) -> None:
        now = time.monotonic()
        self._rate_mark = (now, self.bytes_down)
        self._up_mark = (now, self.bytes_up)

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass

    def __repr__(self) -> str:
        return f"PeerConnection({self.peer_id[:8]!r}, have={self.bitfield.count()}/{self.num_pieces})"
