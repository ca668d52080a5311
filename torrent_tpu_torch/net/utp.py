"""uTP — the micro transport protocol (BEP 29) over asyncio UDP.

No reference counterpart (the reference is TCP-only, torrent.ts:198).
uTP is the transport most real swarms run on: BitTorrent traffic yields
to interactive traffic because LEDBAT backs off on one-way *delay*
(long before loss), and UDP survives NATs that drop inbound TCP.

Scope: a complete, tested transport usable by the session layer —
``open_utp_connection`` / ``UtpListener`` return asyncio
``(StreamReader, writer)`` pairs that drop into the same code paths as
TCP streams (``writer.write/drain/close/get_extra_info``).

Wire format (20-byte header, all big-endian)::

    0       4       8               16
    +-------+-------+---------------+
    | type/ver (1)  | extension (1) | connection_id (2)
    | timestamp_microseconds (4)    |
    | timestamp_difference_us (4)   |
    | wnd_size (4)                  |
    | seq_nr (2)    | ack_nr (2)    |

Types: ST_DATA=0, ST_FIN=1, ST_STATE=2, ST_RESET=3, ST_SYN=4; ver=1.
Extension 1 is a selective-ack bitmask, sent and honored: STATEs carry
the out-of-order set (LSB-first bits from ack_nr+2), and received masks
release SACKed packets from the retransmit queue and fast-resend the
hole once ≥3 packets are acked past it.

Reliability: per-packet retransmit with an RTT-driven RTO (Karn's rule:
samples only from un-retransmitted packets), fast resend on 3 duplicate
acks. Congestion: simplified LEDBAT — cwnd grows toward a 100 ms
one-way-delay target and backs off proportionally past it, clamped to
[2, 256] outstanding packets and the peer's advertised window.

Path MTU: discovered at dial time by padding the SYN to the candidate
payload budget and stepping down a ladder (1400→1280→1152→576) on each
SYN timeout; the size that gets SYN-ACKed bounds ST_DATA chunking. Data
packets are never re-split in flight — a lost ack is indistinguishable
from a lost packet, so re-chunking an outstanding seq can double-feed
bytes at the receiver (stream corruption); probing at handshake avoids
the black hole without that hazard.

Connection ids (BEP 29): the initiator picks ``recv_id`` at random and
sends SYN carrying it; the initiator *sends* with ``recv_id + 1``, the
acceptor sends with ``recv_id``. One UDP socket multiplexes many
connections by (addr, recv_id).
"""

from __future__ import annotations

import asyncio
import ipaddress
import random
import socket
import struct
import time

from torrent_tpu_torch.utils.log import get_logger

log = get_logger("utp")

ST_DATA, ST_FIN, ST_STATE, ST_RESET, ST_SYN = range(5)
VERSION = 1
HEADER = struct.Struct(">BBHIIIHH")
MTU = 1400  # default payload budget per ST_DATA (vs 1500-byte eth MTU)
MTU_LADDER = (1400, 1280, 1152, 576)  # SYN-probe step-down candidates
# Loopback/localhost paths carry ~64 KiB datagrams: starting the probe
# ladder there cuts per-packet Python/syscall overhead ~45x for local
# transfers (seedbox-to-player moves, tests). Non-loopback dials never
# see this rung, so nothing changes on real networks.
JUMBO_MTU = 62 * 1024
MTU_LADDER_LOOPBACK = (JUMBO_MTU,) + MTU_LADDER
# Upward path-MTU probing (DPLPMTUD-flavored): a dial whose SYN ladder
# settled low — a transient clamp, a lossy burst during the handshake —
# must not pin a long-lived connection at 576 forever. Full-budget DATA
# packets are periodically inflated to the next ladder rung with a
# padding EXTENSION (id PAD_EXT below; length-prefixed, so compliant
# decoders skip it and the STREAM bytes are unchanged — which is what
# makes the probe safe to retransmit bare if it vanishes).
PAD_EXT = 0x7A
# Kill-switch (like SACK_ENABLED): PAD_EXT is a non-standard extension
# id, and while BEP 29's framing obliges decoders to skip unknown
# extensions, a third-party peer that resets on one would lose the
# connection on every probe. Raise probing therefore (a) can be turned
# off globally here, and (b) only arms per-connection once the peer has
# DEMONSTRATED extension tolerance: loopback peers (our own stack), or
# a peer that itself sent a BEP 29 extension (its encoder implies the
# framing loop). See UtpConnection._ext_tolerant.
# live connections per endpoint (dialed + accepted): each SYN from a
# distinct (addr, conn_id) mints a UtpConnection plus an accept task, so
# without a cap a spoofed-source SYN flood grows state unbounded — at
# capacity new accepts are refused with ST_RESET (dials still raise)
MAX_LIVE_CONNS = 1024

MTU_RAISE_ENABLED = True
MTU_RAISE_INTERVAL = 5.0  # first upward probe / post-success cadence
MTU_RAISE_BACKOFF_MAX = 120.0  # failed probes back off exponentially to this
SACK_ENABLED = True  # module toggle so tests can measure SACK's effect
SACK_MAX_BYTES = 8  # bitmask covers ack_nr+2 .. ack_nr+1+64
TARGET_DELAY_US = 100_000  # LEDBAT one-way-delay target
MIN_CWND_PKTS = 2
MAX_CWND_PKTS = 256
DEFAULT_RTO = 1.0
MAX_RETRANSMITS = 8
RECV_WINDOW = 1 << 20  # advertised receive buffer


def _now_us() -> int:
    return int(time.monotonic() * 1_000_000) & 0xFFFFFFFF


def encode_packet(
    ptype: int,
    conn_id: int,
    seq_nr: int,
    ack_nr: int,
    *,
    ts: int | None = None,
    ts_diff: int = 0,
    wnd: int = RECV_WINDOW,
    payload: bytes = b"",
    sack: bytes | None = None,
    pad: int = 0,
) -> bytes:
    exts = []
    if sack:
        exts.append((1, sack))  # extension 1 = selective ack (BEP 29)
    n = pad
    while n > 0:  # PAD_EXT entries are ≤255 bytes each; chain as needed
        k = min(255, n)
        exts.append((PAD_EXT, b"\x00" * k))
        n -= k
    ext_blob = b""
    first_ext = exts[0][0] if exts else 0
    for i, (_eid, data) in enumerate(exts):
        nxt = exts[i + 1][0] if i + 1 < len(exts) else 0
        ext_blob += bytes((nxt, len(data))) + data
    return (
        HEADER.pack(
            (ptype << 4) | VERSION,
            first_ext,
            conn_id & 0xFFFF,
            _now_us() if ts is None else ts,
            ts_diff & 0xFFFFFFFF,
            wnd,
            seq_nr & 0xFFFF,
            ack_nr & 0xFFFF,
        )
        + ext_blob
        + payload
    )


def decode_packet(data: bytes):
    """→ (type, conn_id, ts, ts_diff, wnd, seq, ack, payload, sack) or None."""
    if len(data) < HEADER.size:
        return None
    tv, ext, conn_id, ts, ts_diff, wnd, seq, ack = HEADER.unpack_from(data)
    ptype, ver = tv >> 4, tv & 0xF
    if ver != VERSION or ptype > ST_SYN:
        return None
    off = HEADER.size
    sack = None
    while ext:
        if off + 2 > len(data):
            return None
        cur, (ext, elen) = ext, (data[off], data[off + 1])
        off += 2
        if off + elen > len(data):
            return None
        if cur == 1:  # selective-ack bitmask
            sack = data[off : off + elen]
        off += elen
    return ptype, conn_id, ts, ts_diff, wnd, seq, ack, data[off:], sack


def _seq_lt(a: int, b: int) -> bool:
    """a < b in mod-2^16 sequence space."""
    return ((b - a) & 0xFFFF) < 0x8000 and a != b


def _is_loopback_addr(host: str) -> bool:
    """True for 127/8, ::1, and the v4-mapped form a dual-stack socket
    reports (``::ffff:127.0.0.1`` is NOT ``is_loopback`` in ipaddress)."""
    try:
        ip = ipaddress.ip_address(host.split("%")[0])
    except ValueError:
        return False
    mapped = getattr(ip, "ipv4_mapped", None)
    return (mapped or ip).is_loopback


class _UtpReader(asyncio.StreamReader):
    """StreamReader that reports consumption back to the connection so
    window-update STATEs go out when the application drains the buffer
    (without this, a paused sender never learns the window reopened)."""

    _conn: "UtpConnection | None" = None

    async def read(self, n: int = -1) -> bytes:
        data = await super().read(n)
        if self._conn is not None:
            self._conn._after_consume()
        return data

    async def readexactly(self, n: int) -> bytes:
        data = await super().readexactly(n)
        if self._conn is not None:
            self._conn._after_consume()
        return data


class UtpConnection:
    """One reliable bidirectional stream over a shared UDP endpoint."""

    def __init__(self, endpoint: "UtpEndpoint", addr, recv_id: int, send_id: int):
        self.endpoint = endpoint
        self.addr = addr
        self.recv_id = recv_id
        self.send_id = send_id
        self.reader = _UtpReader()
        self.reader._conn = self
        self._advertised_low = False
        self.seq_nr = random.randrange(1, 0xFFFF)  # next seq we will send
        self.ack_nr = 0  # last in-order seq we received
        self.connected = asyncio.Event()
        self.closed = False
        self._reset = False
        # outstanding: seq -> [packet_bytes, sent_monotonic, retransmits]
        self._outstanding: dict[int, list] = {}
        self._send_room = asyncio.Event()
        self._send_room.set()
        self._ooo: dict[int, bytes] = {}  # out-of-order payloads
        self._ooo_bytes = 0  # capped at RECV_WINDOW (hostile-peer guard)
        self._dup_acks = 0
        self._last_ack_seen = -1
        self._last_fast_resend = -1  # seq: one cwnd cut per SACK-detected hole
        self._sacked: dict[int, int] = {}  # seq -> payload len, SACKed not acked
        # incremental byte counters: summing _outstanding/_sacked per
        # sent chunk and per ack made the send path O(window²) —
        # measured as the top CPU cost of a loopback uTP transfer
        self._inflight_data = 0
        self._sacked_bytes = 0
        self._timer_deadline = 0.0  # lazy retransmit-timer re-arm target
        self.mtu = MTU  # payload budget; dial-time SYN probing may lower it
        self._mtu_ladder = MTU_LADDER  # dial() swaps in the loopback ladder
        # Raise probes send the non-standard PAD_EXT; only arm once the
        # peer demonstrated extension tolerance (loopback = our stack;
        # else flipped when the peer sends a SACK — the one extension
        # decode_packet surfaces — proving its framing loop, on_packet)
        self._ext_tolerant = _is_loopback_addr(addr[0])
        self._mtu_probe_idx: int | None = None  # ladder position while dialing
        # upward (raise) probing state — see PAD_EXT block at module top
        self._mtu_raise_at = 0.0  # monotonic: next probe eligibility (0 = off)
        self._mtu_raise_interval = MTU_RAISE_INTERVAL
        self._mtu_probe_seq: int | None = None  # in-flight padded-DATA probe
        self._mtu_probe_target = 0  # rung the in-flight probe validates
        self._mtu_probe_bare: bytes | None = None  # pad-stripped retransmit form
        self.retx_count = 0  # retransmitted packets (observability + tests)
        self.retx_bytes = 0
        self._srtt: float | None = None
        self._rttvar = 0.0
        # our most recent one-way-delay measurement, echoed in every
        # outgoing packet so the peer's LEDBAT gets its samples
        self.last_ts_diff = 0
        self.rto = DEFAULT_RTO
        self.cwnd = MIN_CWND_PKTS * MTU
        self.peer_wnd = RECV_WINDOW
        self._fin_seq: int | None = None
        self._fin_sent = False
        self._rx_closed = False  # reader EOF'd: drop (but ack) late data
        self._timer: asyncio.TimerHandle | None = None
        # delayed acks: in-order data acks every 2nd packet (or 50 ms),
        # halving ack traffic; holes/FINs/window-updates ack immediately
        # so dup-ack fast-resend and SACK feedback keep their timing
        self._delack_timer: asyncio.TimerHandle | None = None
        self._unacked = 0

    # ------------------------------------------------------------- sending

    def _out_add(self, seq: int, pkt: bytes) -> None:
        self._outstanding[seq] = [pkt, time.monotonic(), 0]
        self._inflight_data += len(pkt) - HEADER.size

    def _out_pop(self, seq: int) -> list:
        entry = self._outstanding.pop(seq)
        self._inflight_data -= len(entry[0]) - HEADER.size
        return entry

    def _occupancy(self) -> int:
        """Bytes we hold for this connection: in-order buffer plus the
        out-of-order set (both count — SACKed data still occupies us)."""
        return len(self.reader._buffer) + self._ooo_bytes

    def recv_window(self) -> int:
        """Receive window we advertise: buffer capacity minus occupancy
        (a slow consumer — e.g. a rate-capped peer loop — thereby pauses
        the remote sender instead of buffering without bound)."""
        wnd = max(0, RECV_WINDOW - self._occupancy())
        self._advertised_low = wnd < RECV_WINDOW // 2
        return wnd

    def _after_consume(self) -> None:
        if (
            self._advertised_low
            and not self.closed
            and RECV_WINDOW - self._occupancy() >= RECV_WINDOW // 2
        ):
            self._send_state()  # window update: tell the sender to resume

    def _window(self) -> int:
        # cwnd has an MTU floor; the PEER's advertised window does not —
        # zero from the peer means pause (flow control, not congestion)
        cwnd = max(self.mtu, min(int(self.cwnd), MAX_CWND_PKTS * self.mtu))
        return min(cwnd, self.peer_wnd)

    def _flow_used(self) -> int:
        # SACKed packets leave the retransmit queue but still occupy the
        # peer's buffer until cumulatively acked — they must keep
        # consuming advertised-window budget or a compliant sender
        # overruns the receiver after a long SACK run
        return self._inflight_data + self._sacked_bytes

    def _arm_mtu_raise(self) -> None:
        """Start upward path-MTU probing when the budget settled below
        the ladder top (transient clamp during the SYN exchange, an
        acceptor adopting a stepped-down dialer's pad, ...). No-op
        unless enabled globally AND the peer is extension-tolerant
        (see MTU_RAISE_ENABLED)."""
        if not MTU_RAISE_ENABLED or not self._ext_tolerant:
            return
        if self.mtu < self._mtu_ladder[0]:
            self._mtu_raise_at = time.monotonic() + self._mtu_raise_interval

    def _mtu_probe_pad(self, chunk_len: int) -> int:
        """Padding bytes that turn this DATA packet into an upward path
        probe, or 0. Only full-budget chunks probe (a short tail says
        nothing about the path), one probe in flight at a time. The probe
        wire size slightly EXCEEDS a normal target-rung packet (2 bytes
        per 255-byte pad entry) — conservative in the right direction."""
        if (
            self._mtu_probe_seq is not None
            or not self._mtu_raise_at
            or chunk_len < self.mtu
            or time.monotonic() < self._mtu_raise_at
        ):
            return 0
        bigger = [r for r in self._mtu_ladder if r > self.mtu]
        if not bigger:
            self._mtu_raise_at = 0.0  # at the top: probing done
            return 0
        self._mtu_probe_target = min(bigger)
        return self._mtu_probe_target - chunk_len

    def _mtu_probe_acked(self, seq: int) -> None:
        """The padded probe survived the path: adopt the rung it proved,
        and keep climbing (next eligible chunk) until the ladder top —
        recovery from a transient clamp completes within a few RTTs."""
        if seq != self._mtu_probe_seq:
            return
        self.mtu = self._mtu_probe_target
        self._mtu_probe_seq = None
        self._mtu_probe_bare = None
        self._mtu_raise_interval = MTU_RAISE_INTERVAL
        self._mtu_raise_at = (
            time.monotonic() if self.mtu < self._mtu_ladder[0] else 0.0
        )

    async def send(self, data: bytes) -> None:
        """Chunk ``data`` into ST_DATA packets, honoring the window."""
        if self.closed or self._reset:
            raise ConnectionResetError("utp connection closed")
        off = 0
        while off < len(data):
            # re-read the budget per chunk: a raise probe acked mid-send
            # grows it, and the REST of this send must cut full-budget
            # chunks or the next rung's probe never finds one to ride
            chunk = data[off : off + self.mtu]
            off += len(chunk)
            # Admit chunk+pad TOGETHER: a raise probe must never exceed
            # LEDBAT's admitted inflight, even momentarily. If the
            # window can't fit the padded size, the probe is dropped
            # (never stalls stream progress waiting for probe room —
            # probing a rung larger than the sustainable window is
            # pointless anyway; a later full-budget chunk retries). The
            # pad never occupies the RECEIVER's buffer — extensions are
            # stripped at decode — so the peer's advertised window only
            # governs the stream bytes.
            pad = self._mtu_probe_pad(len(chunk))
            while self._flow_used() + len(chunk) + pad > self._window():
                if pad:
                    pad = 0
                    continue
                self._send_room.clear()
                try:
                    # bounded wait: a zero/shrunken peer window reopens
                    # via the peer's next window-update STATE, but if
                    # that is lost only polling recovers
                    await asyncio.wait_for(self._send_room.wait(), 0.5)
                except asyncio.TimeoutError:
                    pass
                if self.closed or self._reset:
                    raise ConnectionResetError("utp connection closed")
            self.seq_nr = (self.seq_nr + 1) & 0xFFFF
            pkt = encode_packet(
                ST_DATA,
                self.send_id,
                self.seq_nr,
                self.ack_nr,
                ts_diff=self.last_ts_diff,
                wnd=self.recv_window(),
                payload=chunk,
                pad=pad,
            )
            if pad:
                # keep the pad-stripped form ready: if the probe vanishes
                # the pad may be exactly why, and the retransmit must not
                # repeat the oversize (the STREAM bytes are identical)
                self._mtu_probe_seq = self.seq_nr
                self._mtu_probe_bare = encode_packet(
                    ST_DATA,
                    self.send_id,
                    self.seq_nr,
                    self.ack_nr,
                    ts_diff=self.last_ts_diff,
                    wnd=self.recv_window(),
                    payload=chunk,
                )
            self._out_add(self.seq_nr, pkt)
            self.endpoint.sendto(pkt, self.addr)
            self._arm_timer()

    def send_fin(self) -> None:
        if self._fin_sent or self._reset:
            return
        self._fin_sent = True
        self.seq_nr = (self.seq_nr + 1) & 0xFFFF
        pkt = encode_packet(
            ST_FIN,
            self.send_id,
            self.seq_nr,
            self.ack_nr,
            ts_diff=self.last_ts_diff,
            wnd=self.recv_window(),
        )
        self._out_add(self.seq_nr, pkt)
        self.endpoint.sendto(pkt, self.addr)
        self._arm_timer()

    # ------------------------------------------------------------ receiving

    def _drain_ooo(self) -> None:
        """Deliver buffered out-of-order successors now in line (in
        discard mode after a local close: sequence numbers still advance
        so the peer's FIN handshake completes, bytes go nowhere)."""
        nxt = (self.ack_nr + 1) & 0xFFFF
        while nxt in self._ooo:
            data = self._ooo.pop(nxt)
            self._ooo_bytes -= len(data)
            if data and not self._rx_closed:
                self.reader.feed_data(data)
            self.ack_nr = nxt
            nxt = (nxt + 1) & 0xFFFF

    def on_packet(self, ptype, ts, ts_diff, wnd, seq, ack, payload, sack=None) -> None:
        # honor the peer's advertised window as-is — zero means PAUSE
        # (the send loop polls; a floor here would turn the peer's flow
        # control into packet loss and an eventual reset)
        self.peer_wnd = wnd
        self.last_ts_diff = (_now_us() - ts) & 0xFFFFFFFF
        if ptype == ST_RESET:
            self._die(reset=True)
            return
        if sack is not None and not self._ext_tolerant:
            # the peer's own encoder emits BEP 29 extensions, so its
            # decoder implements the framing loop — PAD_EXT is safe now;
            # arm the raise probe it was denied at connection setup
            self._ext_tolerant = True
            self._arm_mtu_raise()
        self._handle_ack(ptype, ack, ts_diff, sack)
        if ptype == ST_STATE:
            if not self.connected.is_set():
                # SYN-ACK: the peer acks our SYN. Its ST_STATE seq is the
                # peer's CURRENT (virtual) position; its first data
                # packet will carry seq+1, so expected = seq+1 ⇒ ack_nr
                # must start at seq.
                self.ack_nr = seq
                self.connected.set()
                self._arm_mtu_raise()  # dial settled low? probe upward
                # data that raced ahead of the SYN-ACK sits in the
                # out-of-order buffer; deliver whatever now lines up —
                # including a buffered FIN, which must close us here just
                # like the ST_DATA drain path does (else close stalls an
                # RTO until the peer retransmits the FIN)
                self._drain_ooo()
                if self._fin_seq is not None and self.ack_nr == self._fin_seq:
                    self._send_state()
                    self._die(reset=False)
            return
        if ptype in (ST_DATA, ST_FIN):
            if ptype == ST_FIN:
                self._fin_seq = seq
            expected = (self.ack_nr + 1) & 0xFFFF
            in_order = False
            if seq == expected:
                if (
                    payload
                    and not self._rx_closed
                    and self._occupancy() + len(payload) > RECV_WINDOW
                ):
                    # sender ignored our advertised window (hostile or
                    # broken): drop without acking — it must retransmit
                    # once the application drains and the window reopens
                    self._send_state()
                    return
                self.ack_nr = seq
                # after a local close the reader has EOF'd: sequencing
                # still advances (the peer's FIN handshake must finish)
                # but bytes are discarded — feed_data after feed_eof is
                # an asyncio invariant violation
                if payload and not self._rx_closed:
                    self.reader.feed_data(payload)
                self._drain_ooo()
                in_order = True
            elif _seq_lt(expected, seq):
                # hole: buffer until filled. FINs buffer too (else close
                # stalls an RTO when the FIN outruns the last data), and
                # total held bytes are capped so a flooder can't balloon
                # the process.
                if seq not in self._ooo and (
                    payload or ptype == ST_FIN
                ):
                    if self._occupancy() + len(payload) <= RECV_WINDOW:
                        self._ooo[seq] = payload
                        self._ooo_bytes += len(payload)
            fin_reached = (
                self._fin_seq is not None and self.ack_nr == self._fin_seq
            )
            if (
                in_order
                and not self._ooo
                and ptype == ST_DATA
                and not fin_reached
                and not self._rx_closed  # close handshake acks promptly
            ):
                self._unacked += 1
                if self._unacked >= 2:
                    self._ack_now()
                elif self._delack_timer is None:
                    self._delack_timer = asyncio.get_running_loop().call_later(
                        0.05, self._ack_now
                    )
            else:
                # hole / duplicate / FIN: immediate ack — dup-ack counting
                # and SACK masks at the sender depend on prompt feedback
                self._ack_now()
            if fin_reached:
                self._die(reset=False)

    def _handle_ack(self, ptype: int, ack: int, ts_diff: int, sack: bytes | None = None) -> None:
        # _outstanding iterates in send order (== seq order mod 2^16:
        # _retransmit mutates in place, SACK pops preserve relative
        # order), so the cumulatively-acked set is a PREFIX — walk it and
        # break at the first newer seq instead of scanning the whole
        # window per ack (the scan was ~25% of a loopback transfer's
        # sender-side CPU at 16-packet windows).
        acked = []
        for s in self._outstanding:  # s <= ack in seq space
            if ((s - ack) & 0xFFFF) < 0x8000 and s != ack:
                break  # ack < s: everything after is newer still
            acked.append(s)
        if self._sacked:
            for s in [s for s in self._sacked if not _seq_lt(ack, s)]:
                self._sacked_bytes -= self._sacked.pop(s)  # budget freed
        n_sacked = self._apply_sack(ack, sack) if sack else 0
        if acked or n_sacked:
            if acked:
                self._dup_acks = 0
                self._last_ack_seen = ack
            for s in acked:
                pkt, sent_at, retx = self._out_pop(s)
                self._mtu_probe_acked(s)
                if retx == 0:  # Karn: only clean samples drive the RTO
                    self._rtt_sample(time.monotonic() - sent_at)
            self._ledbat(ts_diff, len(acked) + n_sacked)
            if not self._send_room.is_set():
                self._send_room.set()
            self._arm_timer()
        elif self._outstanding:
            # Fast resend triggers on DUPLICATE pure acks only: acks
            # piggybacked on ST_DATA are naturally stale while the peer's
            # own data races our request (counting those retransmits
            # every request and pins cwnd to the floor under
            # bidirectional traffic).
            if ptype != ST_STATE or ack != self._last_ack_seen:
                self._last_ack_seen = ack
                return
            self._dup_acks += 1
            # classic threshold is 3 dup acks, but a small window can't
            # produce 3 (a 3-packet window yields at most 2) — without
            # the adaptation every small-window loss costs a full RTO
            need = min(3, max(2, len(self._outstanding) - 1))
            if self._dup_acks >= need:
                self._dup_acks = 0
                self.cwnd = max(MIN_CWND_PKTS * self.mtu, self.cwnd * 0.5)
                oldest = min(self._outstanding, key=lambda s: (s - ack) & 0xFFFF)
                self._retransmit(oldest)

    def _apply_sack(self, ack: int, sack: bytes) -> int:
        """Honor a received selective-ack bitmask (bit 0 = ack+2,
        LSB-first within each byte). Releases SACKed packets and
        fast-resends the hole at ack+1 once ≥3 packets are acked past
        it (one cwnd cut per distinct hole)."""
        n_sacked = 0
        popcount = 0
        for byte_i, b in enumerate(sack):
            if not b:
                continue
            for bit in range(8):
                if b & (1 << bit):
                    popcount += 1
                    s = (ack + 2 + byte_i * 8 + bit) & 0xFFFF
                    if s in self._outstanding:
                        pkt = self._out_pop(s)[0]
                        self._mtu_probe_acked(s)
                        # stays in flow-control accounting until the
                        # cumulative ack passes it (see _flow_used)
                        size = max(0, len(pkt) - HEADER.size)
                        self._sacked[s] = size
                        self._sacked_bytes += size
                        n_sacked += 1
        hole = (ack + 1) & 0xFFFF
        if popcount >= 3 and hole in self._outstanding and self._last_fast_resend != hole:
            # every masked bit is a packet the receiver holds beyond the
            # hole — the hole is lost, not late; resend it now instead
            # of waiting out an RTO (mask repeats each STATE, so cut
            # cwnd only once per distinct hole)
            self._last_fast_resend = hole
            self.cwnd = max(MIN_CWND_PKTS * self.mtu, self.cwnd * 0.5)
            self._retransmit(hole)
        return n_sacked

    def _rtt_sample(self, rtt: float) -> None:
        if self._srtt is None:
            self._srtt, self._rttvar = rtt, rtt / 2
        else:
            self._rttvar = 0.75 * self._rttvar + 0.25 * abs(self._srtt - rtt)
            self._srtt = 0.875 * self._srtt + 0.125 * rtt
        # a clean sample also clears any timeout backoff compounding
        self.rto = min(8.0, max(0.2, self._srtt + 4 * self._rttvar))

    def _ledbat(self, ts_diff_us: int, acked_pkts: int) -> None:
        """Delay-based cwnd update (simplified LEDBAT gain rule)."""
        if ts_diff_us == 0 or ts_diff_us > 60_000_000:
            return  # no usable delay sample
        off_target = (TARGET_DELAY_US - ts_diff_us) / TARGET_DELAY_US
        # full-target gain: one MTU per RTT when delay is zero
        self.cwnd += (
            off_target * self.mtu * acked_pkts * self.mtu / max(self.cwnd, self.mtu)
        )
        self.cwnd = max(
            MIN_CWND_PKTS * self.mtu, min(self.cwnd, MAX_CWND_PKTS * self.mtu)
        )

    # ----------------------------------------------------------- timers

    def _arm_timer(self) -> None:
        """Lazy re-arm: push the RTO deadline forward without touching
        the scheduled TimerHandle (cancel+call_later per packet event
        was ~15% of a loopback transfer's CPU); the handle fires at its
        old time and re-schedules itself for the remainder. A deadline
        moving meaningfully EARLIER (RTO recovered from backoff) does
        cancel and reschedule — otherwise a fresh loss would wait out
        the old backed-off timer."""
        loop = asyncio.get_running_loop()
        self._timer_deadline = loop.time() + self.rto
        if self.closed or not self._outstanding:
            return
        if self._timer is None:
            self._timer = loop.call_later(self.rto, self._on_timeout)
        elif self._timer.when() > self._timer_deadline + 0.05:
            self._timer.cancel()
            self._timer = loop.call_later(self.rto, self._on_timeout)

    def _on_timeout(self) -> None:
        self._timer = None
        if not self._outstanding or self.closed:
            return
        loop = asyncio.get_running_loop()
        remaining = self._timer_deadline - loop.time()
        if remaining > 0.001:
            # deadline moved forward since this handle was scheduled
            self._timer = loop.call_later(remaining, self._on_timeout)
            return
        self.rto = min(8.0, self.rto * 2)  # backoff (SYN probes un-back-off below)
        # multiplicative decrease, not full collapse: a floor-sized
        # window can't generate the dup acks that drive fast resend,
        # turning every subsequent loss into another full RTO
        self.cwnd = max(MIN_CWND_PKTS * self.mtu, self.cwnd * 0.5)
        oldest = min(
            self._outstanding, key=lambda s: self._outstanding[s][1]
        )
        entry = self._outstanding[oldest]
        if entry[2] >= MAX_RETRANSMITS:
            self._die(reset=True)
            return
        if (entry[0][0] >> 4) == ST_SYN and self._mtu_probe_idx is not None:
            # MTU-probe ladder: a vanished padded SYN may mean the pad
            # exceeded the path MTU — shrink and re-encode before the
            # resend; past the ladder, fall back to a bare SYN (max
            # compat with peers that reject payload-carrying SYNs) while
            # keeping the floor as the data budget. No RTO backoff while
            # probing: the whole ladder incl. the bare fallback must walk
            # within the default 10 s dial timeout (1 s per rung, not
            # 1+2+4+8).
            self.rto = DEFAULT_RTO
            self._mtu_probe_idx += 1
            pad = (
                self._mtu_ladder[self._mtu_probe_idx]
                if self._mtu_probe_idx < len(self._mtu_ladder)
                else 0
            )
            self.mtu = self._mtu_ladder[
                min(self._mtu_probe_idx, len(self._mtu_ladder) - 1)
            ]
            new_pkt = encode_packet(
                ST_SYN, self.recv_id, oldest, 0, payload=b"\x00" * pad
            )
            # the only in-place packet mutation: keep the incremental
            # inflight counter honest or the shrunken pad's bytes leak
            # as phantom inflight for the connection's lifetime
            self._inflight_data += len(new_pkt) - len(entry[0])
            entry[0] = new_pkt
        self._retransmit(oldest)
        self._arm_timer()

    def _retransmit(self, seq: int) -> None:
        entry = self._outstanding.get(seq)
        if entry is None:
            return
        if seq == self._mtu_probe_seq and self._mtu_probe_bare is not None:
            # probe failed: the pad may be exactly why it vanished —
            # resend the pad-stripped form (identical stream bytes) and
            # back the probe cadence off exponentially
            self._inflight_data += len(self._mtu_probe_bare) - len(entry[0])
            entry[0] = self._mtu_probe_bare
            self._mtu_probe_seq = None
            self._mtu_probe_bare = None
            self._mtu_raise_interval = min(
                MTU_RAISE_BACKOFF_MAX, self._mtu_raise_interval * 2
            )
            self._mtu_raise_at = time.monotonic() + self._mtu_raise_interval
        entry[1] = time.monotonic()
        entry[2] += 1
        self.retx_count += 1
        self.retx_bytes += max(0, len(entry[0]) - HEADER.size)
        self.endpoint.sendto(entry[0], self.addr)

    def _build_sack(self) -> bytes | None:
        """Bitmask of the out-of-order set: bit 0 = ack_nr+2, LSB-first
        (BEP 29 extension 1; length a multiple of 4, ≥4)."""
        base = (self.ack_nr + 2) & 0xFFFF
        mask = bytearray(SACK_MAX_BYTES)
        top = -1
        for seq in self._ooo:
            off = (seq - base) & 0xFFFF
            if off < SACK_MAX_BYTES * 8:
                mask[off >> 3] |= 1 << (off & 7)
                top = max(top, off)
        if top < 0:
            return None
        nbytes = max(4, ((top >> 3) + 4) & ~3)
        return bytes(mask[:nbytes])

    def _ack_now(self) -> None:
        """Flush the (possibly delayed) ack immediately."""
        if self._delack_timer is not None:
            self._delack_timer.cancel()
            self._delack_timer = None
        self._unacked = 0
        if not self.closed:
            self._send_state()

    def _send_state(self) -> None:
        sack = self._build_sack() if (SACK_ENABLED and self._ooo) else None
        self.endpoint.sendto(
            encode_packet(
                ST_STATE,
                self.send_id,
                self.seq_nr,
                self.ack_nr,
                ts_diff=self.last_ts_diff,
                wnd=self.recv_window(),
                sack=sack,
            ),
            self.addr,
        )

    # ---------------------------------------------------------- lifecycle

    def _die(self, reset: bool) -> None:
        if self.closed:
            return
        self.closed = True
        self._reset = reset
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._delack_timer is not None:
            self._delack_timer.cancel()
            self._delack_timer = None
        self._outstanding.clear()
        self._sacked.clear()
        self._inflight_data = 0
        self._sacked_bytes = 0
        self._send_room.set()
        self._rx_closed = True
        self.reader.feed_eof()
        if reset and not self.connected.is_set():
            self.connected.set()  # unblock dialers; they check _reset
        self.endpoint._forget(self)

    def close(self) -> None:
        if not self.closed:
            self.send_fin()
            # the FIN retransmit timer keeps the connection alive until
            # acked or max-retransmits; reads see EOF immediately and
            # late in-flight data is acked-but-dropped (_rx_closed)
            self._rx_closed = True
            self.reader.feed_eof()


class _UtpWriter:
    """StreamWriter-compatible facade over a UtpConnection.

    ``write()`` must behave like a kernel socket: bytes start moving
    without an explicit ``drain()`` (the session queues its opening
    bitfield/extended-handshake with plain writes). A single background
    flusher task drains the buffer in order; ``drain()`` awaits it
    (providing the backpressure contract), ``close()`` chains the FIN
    behind the last flushed byte.
    """

    def __init__(self, conn: UtpConnection):
        self._conn = conn
        self._buf = bytearray()
        self._flusher: asyncio.Task | None = None
        self._closing = False

    def _kick(self) -> None:
        if self._flusher is None or self._flusher.done():
            try:
                self._flusher = asyncio.get_running_loop().create_task(self._flush())
            except RuntimeError:
                pass

    async def _flush(self) -> None:
        while self._buf and not self._conn.closed:
            buf, self._buf = bytes(self._buf), bytearray()
            try:
                await self._conn.send(buf)
            except ConnectionError:
                self._buf.clear()
                return
        if self._closing:
            self._conn.close()

    def write(self, data: bytes) -> None:
        if self._closing:
            return
        self._buf += data
        self._kick()

    async def drain(self) -> None:
        t = self._flusher
        if t is not None and not t.done():
            await asyncio.shield(t)
        if self._conn._reset:
            raise ConnectionResetError("utp connection reset")

    def close(self) -> None:
        if self._closing:
            return
        self._closing = True
        t = self._flusher
        if (t is None or t.done()) and not self._buf:
            self._conn.close()
        else:
            self._kick()  # flusher sees _closing and FINs after the tail

    def is_closing(self) -> bool:
        return self._conn.closed

    def get_extra_info(self, name, default=None):
        if name == "peername":
            return self._conn.addr
        return default


class UtpEndpoint(asyncio.DatagramProtocol):
    """One UDP socket multiplexing inbound/outbound uTP connections."""

    def __init__(self, on_accept=None):
        self.on_accept = on_accept  # async callback(reader, writer)
        self.transport = None
        self._conns: dict[tuple, UtpConnection] = {}  # (addr, recv_id)
        # secondary index: a peer's RESET echoes OUR send id, not our
        # recv id, so teardown routing needs the other key too
        self._by_send: dict[tuple, UtpConnection] = {}  # (addr, send_id)
        # asyncio keeps only weak refs to tasks — accept handlers must be
        # retained or GC can collect a handshake mid-flight
        self._tasks: set[asyncio.Task] = set()
        self.port: int | None = None

    # asyncio protocol hooks
    def connection_made(self, transport):
        self.transport = transport
        self.port = transport.get_extra_info("sockname")[1]

    def connection_lost(self, exc):
        # the UDP socket died under us (or a caller closed the transport
        # directly instead of endpoint.close()): kill every connection so
        # retransmit/delack timers stop firing into a dead socket
        for conn in list(self._conns.values()):
            conn._die(reset=True)
        self.transport = None

    def sendto(self, data: bytes, addr) -> None:
        # is_closing() too: a retransmit timer can outlive the socket,
        # and asyncio's DatagramTransport.sendto on a closed transport
        # raises from deep inside the event loop's fatal-error path
        if self.transport is not None and not self.transport.is_closing():
            self.transport.sendto(data, addr)

    def datagram_received(self, data, addr):
        parsed = decode_packet(data)
        if parsed is None:
            return
        ptype, conn_id, ts, ts_diff, wnd, seq, ack, payload, sack = parsed
        # kernel source addrs are 4-tuples for IPv6 — key on (host, port)
        # so dialed (2-tuple) and inbound lookups agree
        addr = (addr[0], addr[1])
        now = _now_us()
        diff = (now - ts) & 0xFFFFFFFF
        conn = self._conns.get((addr, conn_id))
        if conn is not None:
            conn.on_packet(ptype, ts, diff, wnd, seq, ack, payload, sack)
            return
        if ptype == ST_RESET:
            # RESETs carry the id WE send with (the peer echoes what it
            # saw) — route via the send-id index or drop
            conn = self._by_send.get((addr, conn_id))
            if conn is not None:
                conn.on_packet(ptype, ts, diff, wnd, seq, ack, payload, sack)
            return
        if ptype == ST_SYN:
            existing = self._conns.get((addr, (conn_id + 1) & 0xFFFF))
            if existing is not None:
                if payload:
                    # re-probe: only ever TIGHTEN (a stale larger first
                    # SYN can arrive after a smaller successful one) —
                    # but a tightened budget must arm raise probing, or a
                    # stale duplicate SYN pins the connection low forever
                    existing.mtu = min(
                        existing.mtu, max(MTU_LADDER[-1], len(payload))
                    )
                    existing._arm_mtu_raise()
                existing._send_state()  # retransmitted SYN: re-ack, no new conn
                return
            if self.on_accept is None:
                self.sendto(encode_packet(ST_RESET, conn_id, 0, seq), addr)
                return
            if len(self._conns) >= MAX_LIVE_CONNS:
                # accept-path cardinality clamp: refuse, don't grow
                self.sendto(encode_packet(ST_RESET, conn_id, 0, seq), addr)
                return
            # acceptor: recv with conn_id+1, send with conn_id
            conn = UtpConnection(
                self, addr, recv_id=(conn_id + 1) & 0xFFFF, send_id=conn_id
            )
            if payload:
                # SYN padding is the dialer's MTU probe; a symmetric path
                # passed len(payload)+20 bytes our way, so adopt it as our
                # own send budget too (bare SYN ⇒ keep the default). The
                # jumbo bound is LOOPBACK-ONLY on this side as well: a WAN
                # SYN arrives reassembled from fragments, and adopting
                # 62 KiB sends onto a 1500-byte path would fragment every
                # ST_DATA ~44 ways (one lost fragment = whole packet).
                cap = JUMBO_MTU if _is_loopback_addr(addr[0]) else MTU
                conn.mtu = max(MTU_LADDER[-1], min(cap, len(payload)))
            conn.ack_nr = seq
            conn.connected.set()
            if _is_loopback_addr(addr[0]):
                # raise probes may climb to the jumbo rung here, exactly
                # like the dial side — WAN accepts keep the 1400-top ladder
                conn._mtu_ladder = MTU_LADDER_LOOPBACK
            conn._arm_mtu_raise()  # adopted a stepped-down budget? probe up
            self._conns[(addr, conn.recv_id)] = conn
            self._by_send[(addr, conn.send_id)] = conn  # bounded-by: _conns
            conn._send_state()  # SYN-ACK
            task = asyncio.get_running_loop().create_task(
                self.on_accept(conn.reader, _UtpWriter(conn))
            )
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        else:
            # unknown connection: RESET so the peer gives up quickly
            self.sendto(encode_packet(ST_RESET, conn_id, 0, seq), addr)

    def _forget(self, conn: UtpConnection) -> None:
        self._conns.pop((conn.addr, conn.recv_id), None)
        self._by_send.pop((conn.addr, conn.send_id), None)

    async def _resolve(self, host: str, port: int) -> tuple[str, int]:
        """Normalize ``host`` to the numeric text form the kernel will
        report as the datagram source — dialing by hostname or
        non-canonical IPv6 text must still match inbound lookups."""
        try:
            return str(ipaddress.ip_address(host)), port
        except ValueError:
            pass
        fam = socket.AF_UNSPEC
        sock = self.transport.get_extra_info("socket") if self.transport else None
        if sock is not None:
            fam = sock.family
        try:
            infos = await asyncio.get_running_loop().getaddrinfo(
                host, port, family=fam, type=socket.SOCK_DGRAM
            )
        except OSError as e:
            raise ConnectionError(f"utp dial: cannot resolve {host!r}: {e}") from e
        if not infos:
            raise ConnectionError(f"utp dial: no addresses for {host!r}")
        sockaddr = infos[0][4]
        return sockaddr[0], sockaddr[1]

    async def dial(
        self, host: str, port: int, timeout: float = 10.0, probe_mtu: bool = True
    ):
        """Initiate a connection → ``(StreamReader, writer)``.

        ``probe_mtu`` pads the SYN to the top of MTU_LADDER and steps
        down on each SYN timeout; the size that gets acked becomes the
        connection's payload budget (bare-SYN fallback keeps compat
        with peers that reject padded SYNs).
        """
        addr = await self._resolve(host, port)
        recv_id = random.randrange(1, 0xFFFE)
        conn = UtpConnection(
            self, addr, recv_id=recv_id, send_id=(recv_id + 1) & 0xFFFF
        )
        self._conns[(addr, recv_id)] = conn
        self._by_send[(addr, conn.send_id)] = conn
        # SYN carries recv_id and consumes seq 1
        pad = b""
        if probe_mtu:
            if _is_loopback_addr(addr[0]):
                # local paths move ~64 KiB datagrams: probe jumbo first
                # (a non-loopback dial never sees this rung)
                conn._mtu_ladder = MTU_LADDER_LOOPBACK
            conn._mtu_probe_idx = 0
            conn.mtu = conn._mtu_ladder[0]
            pad = b"\x00" * conn._mtu_ladder[0]
        pkt = encode_packet(ST_SYN, recv_id, conn.seq_nr, 0, payload=pad)
        conn._out_add(conn.seq_nr, pkt)
        self.sendto(pkt, addr)
        conn._arm_timer()
        try:
            await asyncio.wait_for(conn.connected.wait(), timeout)
        except asyncio.TimeoutError:
            conn._die(reset=True)
            raise ConnectionError(f"utp dial to {addr} timed out")
        if conn._reset:
            raise ConnectionRefusedError(f"utp dial to {addr} refused")
        return conn.reader, _UtpWriter(conn)

    def close(self) -> None:
        for conn in list(self._conns.values()):
            conn._die(reset=True)
        if self.transport is not None:
            self.transport.close()


async def create_utp_endpoint(
    host: str = "0.0.0.0", port: int = 0, on_accept=None
) -> UtpEndpoint:
    loop = asyncio.get_running_loop()
    _, proto = await loop.create_datagram_endpoint(
        lambda: UtpEndpoint(on_accept), local_addr=(host, port)
    )
    return proto


async def open_utp_connection(
    host: str, port: int, timeout: float = 10.0, probe_mtu: bool = True
):
    """One-shot dial on a fresh ephemeral endpoint (TCP-open analogue)."""
    ep = await create_utp_endpoint()
    try:
        return await ep.dial(host, port, timeout, probe_mtu=probe_mtu)
    except Exception:
        ep.close()
        raise
