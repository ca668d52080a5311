"""BEP 5 Mainline DHT — Kademlia peer discovery over UDP.

Beyond the reference's surface (its roadmap stops at magnet links,
README.md:39): a magnet join without trackers needs a peer source, and
the mainline DHT is that source. Implemented from the BEP 5 spec:

- **KRPC**: single-packet bencoded dicts over UDP — ``{t, y: q|r|e, ...}``
  with the four queries ``ping``, ``find_node``, ``get_peers``,
  ``announce_peer``.
- **Routing table**: 160 XOR-metric k-buckets (k=8) keyed by distance
  to our node id; stale entries are pinged before eviction, fresh nodes
  replace dead ones (Kademlia's LRU discipline).
- **Iterative lookups**: alpha=3 parallel queries converging on the k
  closest nodes to a target; ``get_peers`` lookups collect both values
  (peer lists) and write tokens for a follow-up ``announce_peer``.
- **Tokens**: ``sha1(secret || ip)`` with a rotated secret (current +
  previous accepted) so only nodes that recently answered us can store
  peers — the BEP 5 anti-spoofing rule.

Everything is a single asyncio ``DatagramProtocol`` endpoint; the whole
subsystem is exercised against itself on localhost in tests/test_dht.py.
"""

from __future__ import annotations

import asyncio
import hashlib
import ipaddress
import os
import random
import socket
import time
from dataclasses import dataclass, field

from torrent_tpu_torch.net.priority import crc32c

from torrent_tpu_torch.codec.bencode import BencodeError, bdecode, bencode
from torrent_tpu_torch.utils.bytesio import write_int
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("net.dht")

K = 8  # bucket size / closest-set size
ALPHA = 3  # lookup parallelism
RPC_TIMEOUT = 3.0
TOKEN_ROTATE_SECS = 300
PEER_TTL_SECS = 30 * 60
MAX_PEERS_PER_HASH = 2000
# distinct info-hashes with live peer stores: a token-valid announce
# flood of FRESH hashes would otherwise grow resident state unbounded
# inside one TTL window (the sweep only drops stores that expired empty)
MAX_STORED_HASHES = 4096
BOOTSTRAP_TARGET_RETRIES = 2

# BEP 44 storage: bencoded values are capped at 1000 bytes, salts at 64;
# items expire after 2 h (the BEP's republish horizon) and the store is
# capped to bound a hostile flood
ITEM_TTL_SECS = 2 * 3600
MAX_ITEM_V = 1000
MAX_ITEM_SALT = 64
MAX_ITEMS = 2000
# concurrent not-yet-verified mutable puts: beyond this the node sheds
# load with an error instead of queueing unbounded ~4 ms verifies
MAX_PUT_BACKLOG = 32

# BEP 51 sampling: the cap keeps the reply inside one unfragmented UDP
# datagram even on a dual-stack node (20*20B samples + nodes + nodes6 +
# KRPC overhead ≈ 1 KB < a 1472-byte Ethernet MTU payload — fragmented
# UDP is routinely dropped by NATs); the interval tells crawlers how
# often a fresh sample is worth fetching
SAMPLE_MAX = 20
SAMPLE_INTERVAL_SECS = 3600


def item_signature_blob(salt: bytes, seq: int, v_bencoded: bytes) -> bytes:
    """The byte string a BEP 44 mutable item signs: the bencoded
    ``salt``(optional)/``seq``/``v`` dict entries without the enclosing
    dict, e.g. ``3:seqi1e1:v12:Hello World!``."""
    head = b"4:salt" + bencode(salt) if salt else b""
    return head + b"3:seq" + bencode(seq) + b"1:v" + v_bencoded


@dataclass
class DhtItem:
    """A BEP 44 item as fetched: ``k``/``sig``/``seq`` are None for
    immutable items."""

    value: object
    k: bytes | None = None
    sig: bytes | None = None
    seq: int | None = None


class ScrapeBloom:
    """BEP 33 2048-bit bloom filter over peer IPs.

    Two 11-bit indices from sha1 of the binary address (v4: 4 bytes,
    v6: 8 bytes); population is estimated from the zero-bit count, so
    unioned filters from many nodes de-duplicate peers statistically.
    """

    SIZE_BITS = 2048

    def __init__(self, data: bytes | None = None):
        if data is not None and len(data) != self.SIZE_BITS // 8:
            raise ValueError("BEP 33 bloom must be 256 bytes")
        self.bits = bytearray(data or self.SIZE_BITS // 8)

    def insert_ip(self, ip: str) -> None:
        try:
            packed = ipaddress.ip_address(ip).packed
        except ValueError:
            return
        h = hashlib.sha1(packed[: 8 if len(packed) == 16 else 4]).digest()
        for i1 in ((h[0] | h[1] << 8) % 2048, (h[2] | h[3] << 8) % 2048):
            self.bits[i1 // 8] |= 1 << (i1 % 8)

    def union(self, other: "ScrapeBloom") -> None:
        for i, b in enumerate(other.bits):
            self.bits[i] |= b

    def estimate(self) -> float:
        import math

        m = self.SIZE_BITS
        zero = sum(bin(b ^ 0xFF).count("1") for b in self.bits)
        set_bits = m - zero
        if set_bits >= m - 1:
            set_bits = m - 1  # saturated filter: report the formula's cap
        return math.log(1 - set_bits / m) / (2 * math.log(1 - 1 / m))

    def __bytes__(self) -> bytes:
        return bytes(self.bits)


def bep42_prefix(ip: str, r: int) -> bytes | None:
    """BEP 42 node-id constraint: the first 21 bits of a node's id must
    derive from CRC32-C of its masked IP. Returns the 3 expected prefix
    bytes (last 5 bits of byte 2 are free), or None when the address is
    exempt (loopback/private ranges — BEP 42 only binds global IPs)."""
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return None
    if addr.is_private or addr.is_loopback or addr.is_link_local:
        return None
    if addr.version == 4:
        data = ((int(addr) & 0x030F3FFF) | (r << 29)).to_bytes(4, "big")
    else:
        hi64 = int(addr) >> 64  # BEP 42 v6: top 64 bits, masked, r on top
        data = ((hi64 & 0x0103070F1F3F7FFF) | (r << 61)).to_bytes(8, "big")
    crc = crc32c(data)
    return bytes(((crc >> 24) & 0xFF, (crc >> 16) & 0xFF, (crc >> 8) & 0xF8))


def bep42_valid(node_id: bytes, ip: str) -> bool:
    """True when ``node_id`` satisfies BEP 42 for ``ip`` (exempt IPs are
    always valid)."""
    want = bep42_prefix(ip, node_id[-1] & 0x7)
    if want is None:
        return True
    return (
        node_id[0] == want[0]
        and node_id[1] == want[1]
        and (node_id[2] & 0xF8) == want[2]
    )


def bep42_node_id(ip: str) -> bytes:
    """Generate a BEP 42-compliant id for our own external IP (random id
    when the address is exempt)."""
    raw = bytearray(random_node_id())
    r = raw[-1] & 0x7
    want = bep42_prefix(ip, r)
    if want is None:
        return bytes(raw)
    raw[0] = want[0]
    raw[1] = want[1]
    raw[2] = want[2] | (raw[2] & 0x7)
    return bytes(raw)


def random_node_id() -> bytes:
    return os.urandom(20)


def xor_distance(a: bytes, b: bytes) -> int:
    return int.from_bytes(a, "big") ^ int.from_bytes(b, "big")


def pack_compact_peer(ip: str, port: int) -> bytes:
    """6-byte IPv4 peer (BEP 5 'values' entry; same layout the tracker's
    compact response uses)."""
    return bytes(int(x) for x in ip.split(".")) + write_int(port, 2)


def unpack_compact_peers(blob: bytes) -> list[tuple[str, int]]:
    """BEP 5 'values' entries — the shared compact-v4 decoder (port-0
    entries dropped, same as the PEX decoder)."""
    from torrent_tpu_torch.net.types import unpack_compact_v4

    return unpack_compact_v4(blob)


def pack_compact_node(node_id: bytes, ip: str, port: int) -> bytes:
    """26-byte node entry: id + compact address."""
    return node_id + pack_compact_peer(ip, port)


def unpack_compact_nodes(blob: bytes) -> list[tuple[bytes, str, int]]:
    out = []
    for i in range(0, len(blob) - len(blob) % 26, 26):
        nid = blob[i : i + 20]
        addr = unpack_compact_peers(blob[i + 20 : i + 26])
        if addr:
            out.append((nid, addr[0][0], addr[0][1]))
    return out


def pack_compact_node6(node_id: bytes, ip: str, port: int) -> bytes:
    """38-byte BEP 32 node entry, or b"" when the address doesn't pack
    (scoped link-local, v4-mapped) — a truncated frame would misalign
    every later entry in the concatenated nodes6 blob."""
    from torrent_tpu_torch.net.types import pack_compact_v6

    packed = pack_compact_v6([(ip, port)])
    return node_id + packed if len(packed) == 18 else b""


def unpack_compact_nodes6(blob: bytes) -> list[tuple[bytes, str, int]]:
    from torrent_tpu_torch.net.types import unpack_compact_v6

    out = []
    for i in range(0, len(blob) - len(blob) % 38, 38):
        nid = blob[i : i + 20]
        addr = unpack_compact_v6(blob[i + 20 : i + 38])
        if addr:
            out.append((nid, addr[0][0], addr[0][1]))
    return out


def _is_v6(ip: str) -> bool:
    """Family AFTER v4-mapped normalization: a dual-stack socket reports
    v4 peers as ::ffff:a.b.c.d, which belong to the v4 family."""
    from torrent_tpu_torch.net.types import normalize_peer_host

    return ":" in normalize_peer_host(ip)


# ------------------------------------------------------------ routing table


@dataclass
class NodeInfo:
    node_id: bytes
    ip: str
    port: int
    last_seen: float = field(default_factory=time.monotonic)
    failed: int = 0

    @property
    def addr(self) -> tuple[str, int]:
        return (self.ip, self.port)

    @property
    def good(self) -> bool:
        return self.failed < 2 and time.monotonic() - self.last_seen < 15 * 60


class RoutingTable:
    """160 XOR k-buckets keyed by shared-prefix length with our id."""

    def __init__(self, own_id: bytes):
        self.own_id = own_id
        self.buckets: list[list[NodeInfo]] = [[] for _ in range(160)]

    def _bucket_of(self, node_id: bytes) -> list[NodeInfo]:
        d = xor_distance(self.own_id, node_id)
        if d == 0:
            return self.buckets[159]
        return self.buckets[min(159, 159 - (d.bit_length() - 1))]

    def update(self, node_id: bytes, ip: str, port: int) -> None:
        """Mark a node seen (insert / refresh / LRU-replace-dead)."""
        if len(node_id) != 20 or node_id == self.own_id:
            return
        bucket = self._bucket_of(node_id)
        for n in bucket:
            if n.node_id == node_id:
                n.ip, n.port = ip, port
                n.last_seen = time.monotonic()
                n.failed = 0
                return
        node = NodeInfo(node_id, ip, port)
        if len(bucket) < K:
            bucket.append(node)
            return
        # full: replace the worst dead entry, else drop (BEP 5 favors
        # long-lived nodes; pinging before replace happens in maintenance)
        worst = min(bucket, key=lambda n: (n.good, -n.failed, n.last_seen))
        if not worst.good:
            bucket[bucket.index(worst)] = node

    def note_failure(self, node_id: bytes) -> None:
        for n in self._bucket_of(node_id):
            if n.node_id == node_id:
                n.failed += 1
                return

    def closest(self, target: bytes, count: int = K) -> list[NodeInfo]:
        nodes = [n for bucket in self.buckets for n in bucket if n.good]
        nodes.sort(key=lambda n: xor_distance(n.node_id, target))
        return nodes[:count]

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)


# ------------------------------------------------------------------- tokens


class TokenJar:
    """Rotated write tokens: sha1(secret || ip), current + previous valid."""

    def __init__(self):
        self._secret = os.urandom(16)
        self._prev = os.urandom(16)
        self._rotated = time.monotonic()

    def _maybe_rotate(self) -> None:
        if time.monotonic() - self._rotated > TOKEN_ROTATE_SECS:
            self._prev, self._secret = self._secret, os.urandom(16)
            self._rotated = time.monotonic()

    def issue(self, ip: str) -> bytes:
        self._maybe_rotate()
        return hashlib.sha1(self._secret + ip.encode()).digest()[:8]

    def valid(self, ip: str, token: bytes) -> bool:
        self._maybe_rotate()
        return token in (
            hashlib.sha1(self._secret + ip.encode()).digest()[:8],
            hashlib.sha1(self._prev + ip.encode()).digest()[:8],
        )


# ----------------------------------------------------------------- endpoint


class DHTError(Exception):
    pass


class DHTRemoteError(DHTError):
    """The node REPLIED with a KRPC error — it is alive (a 204 from a
    non-BEP44 node must not count as a routing-table failure)."""

    def __init__(self, text: str, code: int = 0):
        super().__init__(text)
        self.code = code


class _Protocol(asyncio.DatagramProtocol):
    def __init__(self, node: "DHTNode"):
        self.node = node

    def datagram_received(self, data: bytes, addr) -> None:
        self.node._on_datagram(data, addr)

    def error_received(self, exc) -> None:  # pragma: no cover - host-dependent
        log.debug("dht socket error: %s", exc)


class DHTNode:
    """One mainline-DHT endpoint: server + query client + lookups."""

    def __init__(
        self,
        node_id: bytes | None = None,
        port: int = 0,
        host: str = "0.0.0.0",
        enforce_bep42: bool = False,
        external_ip: str | None = None,
        read_only: bool = False,
    ):
        """``enforce_bep42`` keeps nodes whose ids violate BEP 42's
        IP-derived constraint out of the routing table (defense against
        id-targeting attacks; off by default — plenty of live nodes
        predate the BEP). ``external_ip`` mints our own id compliant.

        ``read_only`` is BEP 43: a node that can't (NAT'd, firewalled)
        or won't serve queries marks every outgoing query ``ro=1`` so
        responders keep it out of their routing tables, and silently
        drops inbound queries instead of answering with a node others
        would then try — and fail — to reach."""
        if node_id is None and external_ip is not None:
            node_id = bep42_node_id(external_ip)
        self.node_id = node_id or random_node_id()
        self.enforce_bep42 = enforce_bep42
        self.read_only = read_only
        self.host = host
        self.port = port
        # BEP 32 families THIS socket can reach: requesting (and merging)
        # candidates of an unreachable family would fill lookup frontiers
        # with addresses whose sendto fails, burning a full RPC timeout
        # per candidate. "::"/"" binds dual-stack on this platform.
        if host in ("::", ""):
            self._want = [b"n4", b"n6"]
        elif _is_v6(host):
            self._want = [b"n6"]
        else:
            self._want = [b"n4"]
        self.table = RoutingTable(self.node_id)
        self.tokens = TokenJar()
        # info_hash -> {(ip, port): stored_at}
        self.peer_store: dict[bytes, dict[tuple[str, int], float]] = {}
        # BEP 33: announcers that declared seed=1 (pruned with the store)
        self.seed_marks: dict[bytes, set[tuple[str, int]]] = {}
        # BEP 44: target -> {v, v_raw, k, sig, seq, ts} (k/sig/seq None
        # for immutable items)
        self.item_store: dict[bytes, dict] = {}
        self._put_tasks: set[asyncio.Task] = set()  # keep verifies alive
        # indexer seam: sync callbacks fired on harvested inbound traffic
        # — ``cb(kind, info_hash, addr, port, seed)`` with kind one of
        # "get_peers" (demand signal) / "announce_peer" (a live peer).
        # Observers must be fast and non-blocking (datagram path).
        self._observers: list = []
        self._transport: asyncio.DatagramTransport | None = None
        # tid -> (queried address, future): responses are only accepted
        # from the address the query went to
        self._pending: dict[bytes, tuple[tuple[str, int], asyncio.Future]] = {}
        self._tid_counter = random.randrange(1 << 16)

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> "DHTNode":
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Protocol(self), local_addr=(self.host, self.port)
        )
        sock = self._transport.get_extra_info("socket")
        self._sock_v6 = bool(sock is not None and sock.family == socket.AF_INET6)
        self.port = self._transport.get_extra_info("sockname")[1]
        return self

    def _sendto(self, data: bytes, addr) -> None:
        """Family-aware sendto: the table stores canonical dotted-quad
        text for v4 peers, but an AF_INET6 (dual-stack) socket can only
        dial them in the ``::ffff:`` mapped form — a plain v4 string
        raises gaierror, which the transport swallows, which turns every
        v4 query into a silent full-RPC-timeout stall."""
        if self._transport is None:
            return
        if getattr(self, "_sock_v6", False) and ":" not in addr[0]:
            addr = ("::ffff:" + addr[0], addr[1])
        self._transport.sendto(data, addr)

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None
        for _addr, fut in self._pending.values():
            if not fut.done():
                fut.cancel()
        self._pending.clear()

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)

    def add_observer(self, cb) -> None:
        """Register an indexer callback (see ``_observers`` above)."""
        self._observers.append(cb)

    def _notify(
        self, kind: str, info_hash: bytes, addr, port: int | None, seed: bool
    ) -> None:
        for cb in self._observers:
            try:
                cb(kind, info_hash, addr, port, seed)
            except Exception as e:  # a broken observer must not drop queries
                log.debug("dht observer failed: %s", e)

    def _table_update(self, node_id: bytes, ip: str, port: int) -> None:
        """Routing-table insertion with optional BEP 42 enforcement:
        nodes whose ids don't derive from their IP stay OUT of the table
        (they can still answer the query that surfaced them — BEP 42
        constrains routing state, not peer traffic)."""
        from torrent_tpu_torch.net.types import normalize_peer_host

        ip = normalize_peer_host(ip)  # canonical family for compact packing
        if self.enforce_bep42 and not bep42_valid(node_id, ip):
            log.debug("dht: rejecting non-BEP42 node %s at %s", node_id.hex()[:8], ip)
            return
        self.table.update(node_id, ip, port)

    # ------------------------------------------------------------ raw KRPC

    def _next_tid(self) -> bytes:
        self._tid_counter = (self._tid_counter + 1) & 0xFFFF
        return write_int(self._tid_counter, 2)

    async def _query(self, addr: tuple[str, int], q: str, args: dict) -> dict:
        """Send one KRPC query; return the response ``r`` dict."""
        if self._transport is None:
            raise DHTError("node not started")
        tid = self._next_tid()
        msg = {b"t": tid, b"y": b"q", b"q": q.encode(), b"a": {b"id": self.node_id, **args}}
        if self.read_only:
            msg[b"ro"] = 1  # BEP 43: top-level, queries only
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # The 16-bit tid alone is guessable: remember who we queried and
        # only accept the response from that address.
        self._pending[tid] = ((addr[0], addr[1]), fut)
        try:
            self._sendto(bencode(msg), addr)
            return await asyncio.wait_for(fut, RPC_TIMEOUT)
        except asyncio.TimeoutError as e:
            raise DHTError(f"{q} to {addr} timed out") from e
        finally:
            self._pending.pop(tid, None)

    def _respond(self, addr, tid: bytes, r: dict) -> None:
        self._sendto(
            bencode({b"t": tid, b"y": b"r", b"r": {b"id": self.node_id, **r}}), addr
        )

    def _error(self, addr, tid: bytes, code: int, text: str) -> None:
        self._sendto(
            bencode({b"t": tid, b"y": b"e", b"e": [code, text.encode()]}), addr
        )

    # ------------------------------------------------------------- inbound

    def _on_datagram(self, data: bytes, addr) -> None:
        from torrent_tpu_torch.net.types import normalize_peer_host

        # canonical source address: a dual-stack socket reports v4
        # senders as ::ffff:a.b.c.d, which must match the dotted-quad
        # form we queried/stored (pending-response check, tables, tokens)
        addr = (normalize_peer_host(addr[0]), addr[1])
        try:
            msg = bdecode(data)
        except BencodeError:
            return
        if not isinstance(msg, dict):
            return
        tid = msg.get(b"t")
        kind = msg.get(b"y")
        if not isinstance(tid, bytes):
            return
        if kind == b"r":
            r = msg.get(b"r")
            entry = self._pending.get(tid)
            if entry is not None:
                queried_addr, fut = entry
                # IP-only match: port-rewriting NATs legitimately answer
                # from a different source port, and an off-path spoofer
                # gains nothing from the port check (we chose the port).
                if addr[0] != queried_addr[0]:
                    log.debug("dht: response for tid from %s, queried %s; dropped", addr, queried_addr)
                    return
                if not fut.done():
                    if isinstance(r, dict):
                        rid = r.get(b"id")
                        if isinstance(rid, bytes) and len(rid) == 20:
                            self._table_update(rid, addr[0], addr[1])
                        fut.set_result(r)
                    else:
                        # fail fast instead of burning the full RPC timeout
                        fut.set_exception(DHTError("malformed response payload"))
            return
        if kind == b"e":
            entry = self._pending.get(tid)
            if entry is not None:
                queried_addr, fut = entry
                if addr[0] != queried_addr[0]:
                    return
                if not fut.done():
                    e = msg.get(b"e")
                    code = e[0] if isinstance(e, list) and e and isinstance(e[0], int) else 0
                    text = e[1].decode("utf-8", "replace") if isinstance(e, list) and len(e) > 1 and isinstance(e[1], bytes) else "remote error"
                    fut.set_exception(DHTRemoteError(text, code=code))
            return
        if kind != b"q":
            return
        if self.read_only:
            return  # BEP 43: a read-only node answers no queries
        q = msg.get(b"q")
        a = msg.get(b"a")
        if not isinstance(a, dict):
            return
        qid = a.get(b"id")
        # BEP 43: a querier marked ro=1 must stay out of the routing
        # table — it will never answer the queries a table entry invites
        if msg.get(b"ro") != 1 and isinstance(qid, bytes) and len(qid) == 20:
            self._table_update(qid, addr[0], addr[1])
        try:
            self._handle_query(addr, tid, q, a)
        except Exception as e:  # malformed args must never kill the endpoint
            log.debug("dht query error from %s: %s", addr, e)
            self._error(addr, tid, 203, "protocol error")

    def _closest_reply(self, target: bytes, addr, want) -> dict:
        """BEP 32 ``nodes``/``nodes6`` for the closest table entries.

        ``want`` is the querier's requested families ([b"n4"], [b"n6"],
        or both); absent — or containing no token we recognize — BEP 32
        says reply in the querier's own family. Each family selects its
        own closest K (filtering one shared pre-truncated list could
        return an empty nodes6 while reachable v6 entries exist in
        farther buckets).
        """
        fams = set()
        if isinstance(want, list):
            fams = {w for w in want if w in (b"n4", b"n6")}
        if not fams:
            fams = {b"n6" if _is_v6(addr[0]) else b"n4"}
        close = self.table.closest(target, count=1 << 30)  # full sorted view
        out: dict = {}
        if b"n4" in fams:
            v4 = [n for n in close if not _is_v6(n.ip)][:K]
            out[b"nodes"] = b"".join(
                pack_compact_node(n.node_id, n.ip, n.port) for n in v4
            )
        if b"n6" in fams:
            v6 = [n for n in close if _is_v6(n.ip)][:K]
            out[b"nodes6"] = b"".join(
                pack_compact_node6(n.node_id, n.ip, n.port) for n in v6
            )
        return out

    def _handle_query(self, addr, tid: bytes, q, a: dict) -> None:
        if q == b"ping":
            self._respond(addr, tid, {})
            return
        if q == b"find_node":
            target = a.get(b"target")
            if not isinstance(target, bytes) or len(target) != 20:
                self._error(addr, tid, 203, "bad target")
                return
            self._respond(
                addr, tid, self._closest_reply(target, addr, a.get(b"want"))
            )
            return
        if q == b"get_peers":
            info_hash = a.get(b"info_hash")
            if not isinstance(info_hash, bytes) or len(info_hash) != 20:
                self._error(addr, tid, 203, "bad info_hash")
                return
            # a get_peers query is a demand signal: someone wants this
            # swarm — the indexer harvests the hash even with no peer yet
            self._notify("get_peers", info_hash, addr, None, False)
            r: dict = {b"token": self.tokens.issue(addr[0])}
            peers = self._live_peers(info_hash)
            if a.get(b"scrape"):
                # BEP 33: per-swarm seed/downloader bloom filters so a
                # scraper can estimate swarm size without collecting IPs
                marks = self.seed_marks.get(info_hash, set())
                bf_seed, bf_down = ScrapeBloom(), ScrapeBloom()
                for key in peers:
                    (bf_seed if key in marks else bf_down).insert_ip(key[0])
                r[b"BFsd"] = bytes(bf_seed)
                r[b"BFpe"] = bytes(bf_down)
            if peers:
                # BEP 32: values entries are family-sized (6 or 18 bytes);
                # unpackable addresses (scoped link-local) are skipped —
                # an empty-string entry would trip strict remote decoders
                from torrent_tpu_torch.net.types import pack_compact_v6

                values = []
                for ip, port in peers:
                    v = (
                        pack_compact_v6([(ip, port)])
                        if _is_v6(ip)
                        else pack_compact_peer(ip, port)
                    )
                    if v:
                        values.append(v)
                r[b"values"] = values
            else:
                r.update(self._closest_reply(info_hash, addr, a.get(b"want")))
            self._respond(addr, tid, r)
            return
        if q == b"announce_peer":
            info_hash = a.get(b"info_hash")
            token = a.get(b"token")
            port = a.get(b"port")
            if not isinstance(info_hash, bytes) or len(info_hash) != 20:
                self._error(addr, tid, 203, "bad info_hash")
                return
            if not isinstance(token, bytes) or not self.tokens.valid(addr[0], token):
                self._error(addr, tid, 203, "bad token")
                return
            if a.get(b"implied_port"):
                port = addr[1]
            if not isinstance(port, int) or not 0 < port < 65536:
                self._error(addr, tid, 203, "bad port")
                return
            from torrent_tpu_torch.net.types import normalize_peer_host

            if (
                info_hash not in self.peer_store
                and len(self.peer_store) >= MAX_STORED_HASHES
            ):
                # at hash-count capacity a fresh hash evicts the oldest
                # store (insertion order) with its seed marks — announce
                # floods churn the store instead of growing it
                oldest = next(iter(self.peer_store))
                self.peer_store.pop(oldest, None)
                self.seed_marks.pop(oldest, None)
            store = self.peer_store.setdefault(info_hash, {})
            key = (normalize_peer_host(addr[0]), port)
            if len(store) < MAX_PEERS_PER_HASH or key in store:
                # canonical family: a dual-stack socket reports v4
                # announcers as ::ffff:a.b.c.d, which must pack as v4
                store[key] = time.monotonic()
                # BEP 33: the last announce's seed flag wins (no empty
                # set is ever created for flagless announces)
                if a.get(b"seed"):
                    # evicted in lockstep with its store (here and in the
                    # sweep): never holds a hash peer_store doesn't
                    self.seed_marks.setdefault(info_hash, set()).add(key)  # bounded-by: peer_store
                else:
                    marks = self.seed_marks.get(info_hash)
                    if marks is not None:
                        marks.discard(key)
                # token-validated announce: the strongest harvest signal
                # — a reachable peer claiming membership in the swarm
                self._notify(
                    "announce_peer", info_hash, (key[0], addr[1]), port,
                    bool(a.get(b"seed")),
                )
            self._respond(addr, tid, {})
            return
        if q == b"get":
            self._handle_get(addr, tid, a)
            return
        if q == b"put":
            self._handle_put(addr, tid, a)
            return
        if q == b"sample_infohashes":
            # BEP 51: DHT indexing — hand out a random sample of the
            # infohashes we store so crawlers need not harvest
            # get_peers traffic
            target = a.get(b"target")
            if not isinstance(target, bytes) or len(target) != 20:
                self._error(addr, tid, 203, "bad target")
                return
            # Sample FIRST, then liveness-check only the sampled keys: a
            # full-store liveness sweep per query would let a tokenless
            # UDP packet drive O(swarms * peers) work (the periodic
            # maintenance sweep owns bulk expiry). Oversample 2x so a few
            # dead hits still fill the reply; ``num`` is the approximate
            # store size the BEP asks for.
            keys = list(self.peer_store)
            candidates = random.sample(keys, min(len(keys), SAMPLE_MAX * 2))
            sample = [ih for ih in candidates if self._live_peers(ih)][:SAMPLE_MAX]
            r = {
                b"interval": SAMPLE_INTERVAL_SECS,
                b"num": len(self.peer_store),
                b"samples": b"".join(sample),
            }
            r.update(self._closest_reply(target, addr, a.get(b"want")))
            self._respond(addr, tid, r)
            return
        self._error(addr, tid, 204, "method unknown")

    # --------------------------------------------------- BEP 44 item store

    def _live_item(self, target: bytes) -> dict | None:
        ent = self.item_store.get(target)
        if ent is None:
            return None
        if time.monotonic() - ent["ts"] > ITEM_TTL_SECS:
            del self.item_store[target]
            return None
        return ent

    def _handle_get(self, addr, tid: bytes, a: dict) -> None:
        """BEP 44 ``get``: like get_peers but for stored items. Replies
        always carry a write token and closer nodes; ``v`` (+``k``/
        ``sig``/``seq`` for mutable items) when we hold the target. A
        ``seq`` argument suppresses the value when the caller is already
        current (the update-check fast path)."""
        target = a.get(b"target")
        if not isinstance(target, bytes) or len(target) != 20:
            self._error(addr, tid, 203, "bad target")
            return
        r: dict = {b"token": self.tokens.issue(addr[0])}
        r.update(self._closest_reply(target, addr, a.get(b"want")))
        ent = self._live_item(target)
        if ent is not None:
            if ent["seq"] is not None:
                r[b"seq"] = ent["seq"]
                caller_seq = a.get(b"seq")
                if isinstance(caller_seq, int) and ent["seq"] <= caller_seq:
                    self._respond(addr, tid, r)
                    return
                r[b"k"] = ent["k"]
                r[b"sig"] = ent["sig"]
            r[b"v"] = ent["v"]
        self._respond(addr, tid, r)

    def _handle_put(self, addr, tid: bytes, a: dict) -> None:
        """BEP 44 ``put``: immutable (target = sha1 of the bencoded
        value) or mutable (ed25519-signed, target = sha1(k + salt),
        monotonic ``seq`` with optional compare-and-swap)."""
        token = a.get(b"token")
        if not isinstance(token, bytes) or not self.tokens.valid(addr[0], token):
            self._error(addr, tid, 203, "bad token")
            return
        if b"v" not in a:
            self._error(addr, tid, 203, "missing v")
            return
        v = a[b"v"]
        try:
            v_raw = bencode(v)
        except (BencodeError, TypeError, ValueError):
            self._error(addr, tid, 203, "bad v")
            return
        if len(v_raw) > MAX_ITEM_V:
            self._error(addr, tid, 205, "message (v field) too big")
            return
        k = a.get(b"k")
        if k is None:
            target = hashlib.sha1(v_raw).digest()
            if self._store_full(target):
                self._error(addr, tid, 202, "server error: store full")
                return
            self.item_store[target] = {
                "v": v,
                "v_raw": v_raw,
                "k": None,
                "sig": None,
                "seq": None,
                "ts": time.monotonic(),
            }
            self._respond(addr, tid, {})
            return

        from torrent_tpu_torch.utils import ed25519

        sig = a.get(b"sig")
        seq = a.get(b"seq")
        salt = a.get(b"salt", b"")
        if not isinstance(k, bytes) or len(k) != 32:
            self._error(addr, tid, 203, "bad k")
            return
        if not isinstance(salt, bytes):
            self._error(addr, tid, 203, "bad salt")
            return
        if len(salt) > MAX_ITEM_SALT:
            self._error(addr, tid, 207, "salt too big")
            return
        if not isinstance(seq, int) or seq < 0:
            self._error(addr, tid, 203, "bad seq")
            return
        if not isinstance(sig, bytes) or len(sig) != 64:
            self._error(addr, tid, 206, "invalid signature")
            return
        target = hashlib.sha1(k + salt).digest()
        # every cheap rejection fires BEFORE the ~4 ms signature verify:
        # replayed/stale puts must not buy an attacker big-int time
        if not self._check_mutable_slot(addr, tid, target, seq, v_raw, a):
            return
        if self._store_full(target):
            self._error(addr, tid, 202, "server error: store full")
            return
        if len(self._put_tasks) >= MAX_PUT_BACKLOG:
            # shed load: unbounded queued verifies would pin memory and
            # let completions fall behind every sender's RPC timeout
            self._error(addr, tid, 202, "server error: busy")
            return

        async def _finish():
            # the big-int verify runs in a worker thread so a put flood
            # cannot stall the event loop (piece traffic, timers, RPCs)
            ok = await asyncio.get_running_loop().run_in_executor(
                None,
                ed25519.verify,
                k,
                item_signature_blob(salt, seq, v_raw),
                sig,
            )
            if not ok:
                self._error(addr, tid, 206, "invalid signature")
                return
            # the store may have advanced while we verified: re-check
            if not self._check_mutable_slot(addr, tid, target, seq, v_raw, a):
                return
            if self._store_full(target):
                self._error(addr, tid, 202, "server error: store full")
                return
            self.item_store[target] = {
                "v": v,
                "v_raw": v_raw,
                "k": k,
                "sig": sig,
                "seq": seq,
                "ts": time.monotonic(),
            }
            self._respond(addr, tid, {})

        task = asyncio.ensure_future(_finish())
        self._put_tasks.add(task)
        task.add_done_callback(self._put_tasks.discard)

    def _check_mutable_slot(
        self, addr, tid: bytes, target: bytes, seq: int, v_raw: bytes, a: dict
    ) -> bool:
        """seq/CAS preconditions vs the live store; sends the KRPC error
        and returns False on rejection."""
        old = self._live_item(target)
        if old is not None and old["seq"] is not None:
            cas = a.get(b"cas")
            if isinstance(cas, int) and old["seq"] != cas:
                self._error(addr, tid, 301, "cas mismatch")
                return False
            if seq < old["seq"] or (seq == old["seq"] and old["v_raw"] != v_raw):
                self._error(addr, tid, 302, "sequence number less than current")
                return False
        return True

    def _store_full(self, target: bytes) -> bool:
        """Cap check that never counts dead weight: at the cap, expired
        entries are purged before rejecting a new target."""
        if target in self.item_store or len(self.item_store) < MAX_ITEMS:
            return False
        cutoff = time.monotonic() - ITEM_TTL_SECS
        for t in [t for t, e in self.item_store.items() if e["ts"] < cutoff]:
            del self.item_store[t]
        return len(self.item_store) >= MAX_ITEMS

    async def maintain_once(self, stale_after: float = 10 * 60) -> int:
        """One table-maintenance pass (BEP 5 housekeeping):

        - ping entries not seen for ``stale_after`` (a response refreshes
          them via the normal path; a timeout marks a failure, and two
          failures make the entry replaceable);
        - refresh the table by walking toward a random target (keeps
          distant buckets populated on a quiet node);
        - sweep expired peer-store entries.

        Returns the number of stale nodes pinged. Long-running nodes
        call this periodically via :meth:`maintain`; the session's
        announce loop gives connected clients the same effect for free.
        """
        now = time.monotonic()
        stale = [
            n
            for bucket in self.table.buckets
            for n in bucket
            if now - n.last_seen > stale_after and n.failed < 2
        ]

        async def _refresh(n: NodeInfo) -> None:
            try:
                await self.ping(n.addr)
            except DHTError:
                self.table.note_failure(n.node_id)

        # bounded concurrency: a mostly-dead table (post-suspend) would
        # otherwise serialize RPC_TIMEOUT per entry into a minutes-long pass
        for i in range(0, len(stale), ALPHA * 2):
            await asyncio.gather(
                *(_refresh(n) for n in stale[i : i + ALPHA * 2]),
                return_exceptions=True,
            )
        try:
            await self.lookup_nodes(random_node_id())
        except DHTError:
            pass
        for ih in list(self.peer_store):
            self._live_peers(ih)  # side effect: expire old entries
            if not self.peer_store.get(ih):
                self.peer_store.pop(ih, None)
                self.seed_marks.pop(ih, None)  # never outlives its store
        for target in list(self.item_store):
            self._live_item(target)  # side effect: expire BEP 44 items
        return len(stale)

    async def maintain(self, interval: float = 600.0) -> None:
        """Run :meth:`maintain_once` forever (cancel to stop)."""
        while True:
            await asyncio.sleep(interval)
            try:
                await self.maintain_once()
            except Exception as e:  # a bad pass must not kill the loop
                log.debug("dht maintenance pass failed: %s", e)

    def _live_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        store = self.peer_store.get(info_hash)
        if not store:
            self.seed_marks.pop(info_hash, None)
            return []
        cutoff = time.monotonic() - PEER_TTL_SECS
        expired = [k for k, ts in store.items() if ts < cutoff]
        for key in expired:
            del store[key]
        if expired and info_hash in self.seed_marks:
            self.seed_marks[info_hash] &= store.keys()
        return list(store)

    # --------------------------------------------------------- client RPCs

    async def ping(self, addr: tuple[str, int]) -> bytes:
        r = await self._query(addr, "ping", {})
        rid = r.get(b"id")
        if not isinstance(rid, bytes) or len(rid) != 20:
            raise DHTError("ping response missing id")
        return rid

    def _merge_nodes(self, r: dict) -> list[tuple[bytes, str, int]]:
        """nodes (26 B) + BEP 32 nodes6 (38 B) from one response —
        ingesting only the families this socket can actually dial."""
        out: list[tuple[bytes, str, int]] = []
        nodes_blob = r.get(b"nodes")
        if b"n4" in self._want and isinstance(nodes_blob, bytes):
            out.extend(unpack_compact_nodes(nodes_blob))
        nodes6_blob = r.get(b"nodes6")
        if b"n6" in self._want and isinstance(nodes6_blob, bytes):
            out.extend(unpack_compact_nodes6(nodes6_blob))
        return out

    async def find_node(self, addr, target: bytes) -> list[tuple[bytes, str, int]]:
        r = await self._query(
            addr, "find_node", {b"target": target, b"want": self._want}
        )
        return self._merge_nodes(r)

    async def get_peers(
        self, addr, info_hash: bytes
    ) -> tuple[list[tuple[str, int]], list[tuple[bytes, str, int]], bytes | None]:
        """→ (peers, closer_nodes, write_token)."""
        from torrent_tpu_torch.net.types import unpack_compact_v6

        r = await self._query(
            addr, "get_peers", {b"info_hash": info_hash, b"want": self._want}
        )
        token = r.get(b"token")
        peers: list[tuple[str, int]] = []
        values = r.get(b"values")
        if isinstance(values, list):
            for v in values:
                if not isinstance(v, bytes):
                    continue
                # BEP 32: entry size selects the family
                peers.extend(
                    unpack_compact_v6(v) if len(v) == 18 else unpack_compact_peers(v)
                )
        nodes = self._merge_nodes(r)
        return peers, nodes, token if isinstance(token, bytes) else None

    async def announce_peer(
        self, addr, info_hash: bytes, port: int, token: bytes, seed: bool = False
    ) -> None:
        args = {
            b"info_hash": info_hash,
            b"port": port,
            b"token": token,
            b"implied_port": 0,
        }
        if seed:
            args[b"seed"] = 1  # BEP 33: lets scrapers split seeds from leeches
        await self._query(addr, "announce_peer", args)

    # ------------------------------------------------------------- lookups

    async def bootstrap(self, addrs: list[tuple[str, int]]) -> int:
        """Ping seeds then walk towards our own id to fill the table.

        Seed hostnames are resolved first — the routing table must only
        ever hold numeric addresses (compact-node packing needs them,
        and sendto on a hostname does blocking DNS per packet). The
        resolution family follows our own socket (a v4-bound node can't
        reach v6 seeds and vice versa).
        """
        # dual-stack sockets dial both families (v4 via ::ffff mapping in
        # _sendto) — resolving single-family there would silently drop
        # seeds with only an A record and brick the join
        if self.host in ("::", ""):
            fam = socket.AF_UNSPEC
        elif _is_v6(self.host):
            fam = socket.AF_INET6
        else:
            fam = socket.AF_INET
        loop = asyncio.get_running_loop()

        async def _join(addr) -> None:
            try:
                infos = await loop.getaddrinfo(addr[0], addr[1], family=fam)
                ip_addr = (infos[0][4][0], addr[1])
            except OSError:
                return
            try:
                # operator-chosen seeds bypass BEP 42 enforcement: the
                # long-lived public bootstrap nodes predate the BEP, and
                # rejecting them would leave the table empty — no
                # candidates, no lookups, a bricked join
                self.table.update(await self.ping(ip_addr), ip_addr[0], ip_addr[1])
            except DHTError:
                return

        # bounded concurrency: a persisted table full of now-dead nodes
        # would otherwise serialize RPC_TIMEOUT per seed into a
        # minutes-long start (same reasoning as maintain_once)
        for i in range(0, len(addrs), ALPHA * 2):
            await asyncio.gather(
                *(_join(a) for a in addrs[i : i + ALPHA * 2]),
                return_exceptions=True,
            )
        for _ in range(BOOTSTRAP_TARGET_RETRIES):
            await self.lookup_nodes(self.node_id)
        return len(self.table)

    async def _iterative(self, target: bytes, mode: str = "nodes"):
        """Kademlia convergence loop shared by node, peer, and BEP 44
        item lookups (``mode``: 'nodes' | 'peers' | 'get')."""
        queried: set[tuple[str, int]] = set()
        candidates: dict[tuple[str, int], bytes] = {
            n.addr: n.node_id for n in self.table.closest(target, K * 2)
        }
        found_peers: set[tuple[str, int]] = set()
        # 'get' mode appends item dicts; 'scrape' mode appends
        # (BFsd, BFpe) ScrapeBloom pairs
        found_items: list = []
        tokens: dict[tuple[str, int], bytes] = {}

        def rank(addr) -> int:
            return xor_distance(candidates[addr], target)

        while True:
            frontier = sorted(
                (a for a in candidates if a not in queried), key=rank
            )[:ALPHA]
            if not frontier:
                break

            async def visit(addr):
                queried.add(addr)
                try:
                    if mode == "peers":
                        peers, nodes, token = await self.get_peers(addr, target)
                        if token:
                            tokens[addr] = token
                        found_peers.update(peers)
                        return nodes
                    if mode == "get":
                        item, nodes, token = await self.get_rpc(addr, target)
                        if token:
                            tokens[addr] = token
                        if item is not None:
                            found_items.append(item)
                        return nodes
                    if mode == "scrape":
                        blooms, nodes, token = await self._scrape_visit(addr, target)
                        if token:
                            tokens[addr] = token
                        if blooms != (None, None):
                            found_items.append(blooms)
                        return nodes
                    return await self.find_node(addr, target)
                except DHTRemoteError:
                    # an error reply proves liveness (e.g. 204 from a
                    # node without BEP 44) — never poison the table
                    return []
                except DHTError:
                    self.table.note_failure(candidates[addr])
                    return []

            results = await asyncio.gather(*(visit(a) for a in frontier))
            progressed = False
            for nodes in results:
                for nid, ip, port in nodes:
                    a = (ip, port)
                    if a not in candidates:
                        candidates[a] = nid
                        progressed = True
            # stop when the closest K known are all queried and nothing new
            closest = sorted(candidates, key=rank)[:K]
            if not progressed and all(a in queried for a in closest):
                break
        closest = sorted((a for a in candidates if a in queried), key=rank)[:K]
        return found_peers, closest, candidates, tokens, found_items

    async def lookup_nodes(self, target: bytes) -> list[tuple[str, int]]:
        _, closest, _, _, _ = await self._iterative(target, "nodes")
        return closest

    async def lookup_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        peers, _, _, _, _ = await self._iterative(info_hash, "peers")
        return sorted(peers)

    async def announce(self, info_hash: bytes, port: int, seed: bool = False) -> int:
        """get_peers convergence then announce_peer to the closest K.

        Returns how many nodes accepted the announce.
        """
        _, closest, candidates, tokens, _ = await self._iterative(info_hash, "peers")
        accepted = 0
        for addr in closest:
            token = tokens.get(addr)
            if token is None:
                continue
            try:
                await self.announce_peer(addr, info_hash, port, token, seed=seed)
                accepted += 1
            except DHTError:
                continue
        return accepted

    # ------------------------------------------------- BEP 44 client side

    async def get_rpc(self, addr, target: bytes):
        """One ``get`` query → (item fields | None, closer_nodes, token)."""
        r = await self._query(addr, "get", {b"target": target, b"want": self._want})
        token = r.get(b"token")
        item = None
        if b"v" in r:
            item = {
                "v": r[b"v"],
                "k": r.get(b"k"),
                "sig": r.get(b"sig"),
                "seq": r.get(b"seq"),
            }
        return item, self._merge_nodes(r), token if isinstance(token, bytes) else None

    async def put_rpc(self, addr, token: bytes, args: dict) -> None:
        await self._query(addr, "put", {b"token": token, **args})

    async def get_item(self, target: bytes, salt: bytes = b"") -> DhtItem | None:
        """Iterative BEP 44 fetch + client-side validation.

        Immutable replies must hash back to ``target``; mutable replies
        must carry a valid signature under a key with
        ``sha1(k + salt) == target`` (the caller knows the salt out of
        band, like the key itself). The highest valid ``seq`` wins.
        """
        from torrent_tpu_torch.utils import ed25519

        _, _, _, _, items = await self._iterative(target, "get")
        best: DhtItem | None = None
        for it in items:
            try:
                v_raw = bencode(it["v"])
            except (BencodeError, TypeError, ValueError):
                continue
            k, sig, seq = it["k"], it["sig"], it["seq"]
            if k is None:
                if hashlib.sha1(v_raw).digest() == target:
                    return DhtItem(value=it["v"])  # immutable: first valid wins
                continue
            if (
                not isinstance(k, bytes)
                or not isinstance(sig, bytes)
                or not isinstance(seq, int)
                or hashlib.sha1(k + salt).digest() != target
            ):
                continue
            # ~4 ms big-int verify per candidate item (dozens on a popular
            # key, garbage sigs cost full price): off the event loop, like
            # the server-side put path
            ok = await asyncio.get_running_loop().run_in_executor(
                None,
                ed25519.verify,
                k,
                item_signature_blob(salt, seq, v_raw),
                sig,
            )
            if not ok:
                continue
            if best is None or seq > best.seq:
                best = DhtItem(value=it["v"], k=k, sig=sig, seq=seq)
        return best

    async def _put_to_closest(self, target: bytes, args: dict) -> int:
        _, closest, _, tokens, _ = await self._iterative(target, "get")
        stored = 0
        for addr in closest:
            token = tokens.get(addr)
            if token is None:
                continue
            try:
                await self.put_rpc(addr, token, args)
                stored += 1
            except DHTError:
                continue
        return stored

    async def put_immutable(self, value) -> tuple[bytes, int]:
        """Store a bencodable value; returns (target, nodes_stored)."""
        v_raw = bencode(value)
        if len(v_raw) > MAX_ITEM_V:
            raise ValueError(f"value too big ({len(v_raw)} > {MAX_ITEM_V})")
        target = hashlib.sha1(v_raw).digest()
        return target, await self._put_to_closest(target, {b"v": value})

    async def put_mutable(
        self,
        secret: bytes,
        value,
        seq: int,
        salt: bytes = b"",
        cas: int | None = None,
    ) -> tuple[bytes, int]:
        """Sign and store a mutable item; returns (target, nodes_stored).

        ``secret`` is a 32-byte ed25519 seed or a 64-byte expanded
        secret (the form BEP 44's vectors use). ``cas`` forwards the
        compare-and-swap precondition.
        """
        from torrent_tpu_torch.utils import ed25519

        v_raw = bencode(value)
        if len(v_raw) > MAX_ITEM_V:
            raise ValueError(f"value too big ({len(v_raw)} > {MAX_ITEM_V})")
        if len(salt) > MAX_ITEM_SALT:
            raise ValueError(f"salt too big ({len(salt)} > {MAX_ITEM_SALT})")
        if len(secret) == 32:
            k = ed25519.publickey(secret)
            sig = ed25519.sign(secret, item_signature_blob(salt, seq, v_raw))
        elif len(secret) == 64:
            k = ed25519.publickey_expanded(secret)
            sig = ed25519.sign_expanded(secret, item_signature_blob(salt, seq, v_raw))
        else:
            raise ValueError("secret must be a 32-byte seed or 64-byte expanded key")
        args: dict = {b"v": value, b"k": k, b"sig": sig, b"seq": seq}
        if salt:
            args[b"salt"] = salt
        if cas is not None:
            args[b"cas"] = cas
        target = hashlib.sha1(k + salt).digest()
        return target, await self._put_to_closest(target, args)

    # --------------------------------------- BEP 33 scrape / BEP 51 sample

    async def _scrape_visit(self, addr, info_hash: bytes):
        """One scraping get_peers → ((BFsd, BFpe), closer_nodes, token)."""
        r = await self._query(
            addr,
            "get_peers",
            {b"info_hash": info_hash, b"scrape": 1, b"want": self._want},
        )
        out = []
        for field_name in (b"BFsd", b"BFpe"):
            raw = r.get(field_name)
            out.append(
                ScrapeBloom(raw) if isinstance(raw, bytes) and len(raw) == 256 else None
            )
        token = r.get(b"token")
        return (
            (out[0], out[1]),
            self._merge_nodes(r),
            token if isinstance(token, bytes) else None,
        )

    async def scrape_rpc(self, addr, info_hash: bytes):
        """One scraping get_peers → (seed bloom, downloader bloom) or
        (None, None) when the node doesn't implement BEP 33."""
        blooms, _, _ = await self._scrape_visit(addr, info_hash)
        return blooms

    async def scrape_swarm(self, info_hash: bytes) -> tuple[float, float]:
        """BEP 33 swarm-size estimate: one scraping convergence (every
        get_peers in the walk carries scrape=1, so the closest nodes'
        blooms arrive with the lookup itself — no second RPC round),
        blooms unioned for a statistically de-duplicated
        (≈seeds, ≈downloaders)."""
        _, _, _, _, bloom_pairs = await self._iterative(info_hash, "scrape")
        bf_seed, bf_down = ScrapeBloom(), ScrapeBloom()
        for sd, pe in bloom_pairs:
            if sd is not None:
                bf_seed.union(sd)
            if pe is not None:
                bf_down.union(pe)
        return bf_seed.estimate(), bf_down.estimate()

    # ------------------------------------------------------ state persistence

    def save_state(self, path: str) -> None:
        """Persist the node id and good routing-table entries so the next
        start rejoins the DHT without public bootstrap seeds (the
        standard fast-restart behavior of long-lived clients)."""
        v4 = b"".join(
            pack_compact_node(n.node_id, n.ip, n.port)
            for b in self.table.buckets
            for n in b
            if n.good and not _is_v6(n.ip)
        )
        v6 = b"".join(
            pack_compact_node6(n.node_id, n.ip, n.port)
            for b in self.table.buckets
            for n in b
            if n.good and _is_v6(n.ip)
        )
        if not v4 and not v6 and os.path.exists(path):
            # an empty table (e.g. a session started during an outage)
            # must not overwrite a previously good saved table — for a
            # seedless fast-restart config that file IS the only way
            # back into the DHT
            return
        blob = bencode({b"id": self.node_id, b"nodes": v4, b"nodes6": v6})
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    @staticmethod
    def load_state(path: str):
        """→ (node_id | None, [(ip, port), ...]) from :meth:`save_state`;
        (None, []) when absent or malformed (a fresh id + empty table is
        always a safe fallback)."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
            state = bdecode(raw)
        except (OSError, BencodeError):
            return None, []
        if not isinstance(state, dict):
            return None, []
        node_id = state.get(b"id")
        if not isinstance(node_id, bytes) or len(node_id) != 20:
            node_id = None
        addrs: list[tuple[str, int]] = []
        nodes = state.get(b"nodes")
        if isinstance(nodes, bytes):
            addrs.extend((ip, port) for _, ip, port in unpack_compact_nodes(nodes))
        nodes6 = state.get(b"nodes6")
        if isinstance(nodes6, bytes):
            addrs.extend((ip, port) for _, ip, port in unpack_compact_nodes6(nodes6))
        return node_id, addrs

    async def sample_infohashes(
        self, addr, target: bytes
    ) -> tuple[list[bytes], int, int, list[tuple[bytes, str, int]]]:
        """BEP 51 → (sampled infohashes, total stored, refresh interval,
        closer nodes) from one node."""
        r = await self._query(
            addr, "sample_infohashes", {b"target": target, b"want": self._want}
        )
        raw = r.get(b"samples")
        samples = (
            [raw[i : i + 20] for i in range(0, len(raw) - len(raw) % 20, 20)]
            if isinstance(raw, bytes)
            else []
        )
        num = r.get(b"num")
        interval = r.get(b"interval")
        return (
            samples,
            num if isinstance(num, int) else len(samples),
            interval if isinstance(interval, int) else SAMPLE_INTERVAL_SECS,
            self._merge_nodes(r),
        )
