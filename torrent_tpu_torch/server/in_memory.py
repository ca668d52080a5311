"""Reference in-memory tracker (ref: server/in_memory_tracker.ts, 186 LoC).

The policy layer over TrackerServer's transport stream: per-torrent swarm
state, seeder/leecher accounting, random peer selection, idle sweeps.

Deliberate fixes vs the reference (SURVEY §8.13):
- ``random_selection`` cannot loop forever when the pool is exactly the
  requester (in_memory_tracker.ts:42-50) — it samples from a materialized
  candidate list.
- Scrape returns stats for the hashes it knows and zeros for the ones it
  doesn't, instead of rejecting the whole batch when any hash is unknown
  (in_memory_tracker.ts:155-159).
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from torrent_tpu_torch.net.constants import DEFAULT_ANNOUNCE_INTERVAL
from torrent_tpu_torch.net.types import AnnounceEvent, AnnouncePeer
from torrent_tpu_torch.server.tracker import (
    AnnounceRequest,
    ScrapeRequest,
    ServeOptions,
    TrackerServer,
    serve_tracker,
)

PEER_TTL = 15 * 60  # evict peers idle > 15 min (in_memory_tracker.ts:16)
SWEEP_INTERVAL = 15 * 60


@dataclass
class PeerState:
    peer_id: bytes
    ip: str
    port: int
    left: int
    last_seen: float = field(default_factory=time.monotonic)

    @property
    def is_seeder(self) -> bool:
        # seeder/leecher classification (in_memory_tracker.ts:23-28)
        return self.left == 0


@dataclass
class FileInfo:
    """Swarm state for one torrent (in_memory_tracker.ts:53-59)."""

    complete: int = 0  # current seeders
    downloaded: int = 0  # lifetime completions
    incomplete: int = 0  # current leechers
    peers: dict[bytes, PeerState] = field(default_factory=dict)


class InMemoryTracker:
    """Tracker policy over in-process maps; drive with handle()."""

    def __init__(
        self,
        interval: int = DEFAULT_ANNOUNCE_INTERVAL,
        clock=time.monotonic,
        rng: random.Random | None = None,
    ):
        self.interval = interval
        self.files: dict[bytes, FileInfo] = {}
        # determinism seams (same contract as ShardedSwarmStore): all
        # timestamps and peer-selection draws route through these so a
        # scenario replay with virtual clock + seeded rng is bit-stable
        self._clock = clock
        self._rng: random.Random = rng if rng is not None else random  # type: ignore[assignment]

    # ------------------------------------------------------------ helpers

    def random_selection(self, info: FileInfo, exclude: bytes, n: int) -> list[AnnouncePeer]:
        """Up to n random peers, excluding the requester (in_memory_tracker.ts:30-51)."""
        candidates = [p for pid, p in info.peers.items() if pid != exclude]
        if len(candidates) > n:
            candidates = self._rng.sample(candidates, n)
        return [AnnouncePeer(ip=p.ip, port=p.port, peer_id=p.peer_id) for p in candidates]

    # ------------------------------------------------------------ announce

    async def handle_announce(self, req: AnnounceRequest) -> None:
        """State update + response (in_memory_tracker.ts:79-143)."""
        info = self.files.setdefault(req.info_hash, FileInfo())
        prev = info.peers.get(req.peer_id)

        if req.event == AnnounceEvent.STOPPED:
            if prev is not None:
                del info.peers[req.peer_id]
                if prev.is_seeder:
                    info.complete -= 1
                else:
                    info.incomplete -= 1
            await req.respond(self.interval, info.complete, info.incomplete, [])
            return

        now_seeder = req.left == 0
        if prev is None:
            if now_seeder:
                info.complete += 1
            else:
                info.incomplete += 1
            if req.event == AnnounceEvent.COMPLETED and now_seeder:
                info.downloaded += 1
        else:
            if prev.is_seeder != now_seeder:
                if now_seeder:  # leecher → seeder promotion (:113-125)
                    info.incomplete -= 1
                    info.complete += 1
                    info.downloaded += 1
                else:
                    info.complete -= 1
                    info.incomplete += 1
            elif req.event == AnnounceEvent.COMPLETED and now_seeder:
                info.downloaded += 1

        info.peers[req.peer_id] = PeerState(
            peer_id=req.peer_id, ip=req.ip, port=req.port, left=req.left,
            last_seen=self._clock(),
        )
        peers = self.random_selection(info, req.peer_id, req.num_want)
        await req.respond(self.interval, info.complete, info.incomplete, peers)

    # ------------------------------------------------------------ scrape

    async def handle_scrape(self, req: ScrapeRequest) -> None:
        """(in_memory_tracker.ts:145-164); an empty request scrapes every
        tracked torrent (ts:149-152). Unknown hashes scrape as zeros
        rather than rejecting the whole request (deliberate divergence:
        one stale hash in a batched scrape shouldn't void the rest)."""
        hashes = req.info_hashes or list(self.files.keys())
        files = []
        for h in hashes:
            info = self.files.get(h)
            if info is None:
                files.append((h, 0, 0, 0))
            else:
                files.append((h, info.complete, info.downloaded, info.incomplete))
        await req.respond(files)

    # ------------------------------------------------------------ sweep

    def sweep(self) -> int:
        """Evict idle peers (in_memory_tracker.ts:61-77); returns evictions."""
        cutoff = self._clock() - PEER_TTL
        evicted = 0
        for info in self.files.values():
            for pid in [pid for pid, p in info.peers.items() if p.last_seen < cutoff]:
                p = info.peers.pop(pid)
                if p.is_seeder:
                    info.complete -= 1
                else:
                    info.incomplete -= 1
                evicted += 1
        return evicted

    # ------------------------------------------------------------ dispatch

    # -------------------------------------------------------- persistence

    def save_state(self, path: str) -> None:
        """Snapshot swarm state to disk (bencoded) so a tracker restart
        keeps its lifetime counters and live peer lists.

        ``last_seen`` is stored as *age in seconds* — monotonic clocks
        don't survive a process, ages do.
        """
        import os

        from torrent_tpu_torch.codec.bencode import bencode

        now = self._clock()
        files = {}
        for ih, info in self.files.items():
            files[ih] = {
                b"complete": info.complete,
                b"downloaded": info.downloaded,
                b"incomplete": info.incomplete,
                b"peers": {
                    ps.peer_id: {
                        b"ip": ps.ip.encode(),
                        b"port": ps.port,
                        b"left": ps.left,
                        b"age": int(now - ps.last_seen),
                    }
                    for ps in info.peers.values()
                },
            }
        blob = bencode({b"version": 1, b"files": files})
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)  # atomic: no torn state file on crash

    def load_state(self, path: str) -> bool:
        """Restore a ``save_state`` snapshot; False if absent/invalid."""
        from torrent_tpu_torch.codec.bencode import BencodeError, bdecode

        try:
            with open(path, "rb") as f:
                decoded = bdecode(f.read())
        except (OSError, BencodeError):
            return False
        if not isinstance(decoded, dict) or decoded.get(b"version") != 1:
            return False
        files = decoded.get(b"files")
        if not isinstance(files, dict):
            return False
        now = self._clock()
        # Parse fully into a scratch dict first — a snapshot that turns
        # out malformed halfway through must not leave partial state.
        loaded: dict[bytes, FileInfo] = {}
        try:
            for ih, d in files.items():
                if not (isinstance(ih, bytes) and len(ih) == 20 and isinstance(d, dict)):
                    continue
                counters = [d.get(k, 0) for k in (b"complete", b"downloaded", b"incomplete")]
                if not all(isinstance(c, int) for c in counters):
                    continue
                info = FileInfo(
                    complete=counters[0], downloaded=counters[1], incomplete=counters[2]
                )
                peers = d.get(b"peers")
                if isinstance(peers, dict):
                    for pid, p in peers.items():
                        if not (isinstance(pid, bytes) and isinstance(p, dict)):
                            continue
                        ip, port, left = p.get(b"ip"), p.get(b"port"), p.get(b"left")
                        age = p.get(b"age", 0)
                        if not (
                            isinstance(ip, bytes)
                            and isinstance(port, int)
                            and 0 < port < 65536  # compact packing needs u16
                            and isinstance(left, int)
                            and left >= 0
                            and isinstance(age, int)
                            and age >= 0  # a future last_seen never expires
                        ):
                            continue
                        try:
                            info.peers[pid] = PeerState(
                                peer_id=pid,
                                ip=ip.decode(),
                                port=port,
                                left=left,
                                last_seen=now - age,
                            )
                        except UnicodeDecodeError:
                            continue
                # Live counters are derived state — recompute from the
                # peers that actually survived validation so a dropped
                # entry can't leave a phantom seeder/leecher behind.
                info.complete = sum(1 for ps in info.peers.values() if ps.is_seeder)
                info.incomplete = len(info.peers) - info.complete
                loaded[ih] = info
        except (TypeError, ValueError, AttributeError):
            return False
        self.files.update(loaded)
        self.sweep()  # drop peers whose stored age already exceeds the TTL
        return True

    async def handle(self, req) -> None:
        if isinstance(req, AnnounceRequest):
            await self.handle_announce(req)
        elif isinstance(req, ScrapeRequest):
            await self.handle_scrape(req)


async def run_tracker(
    opts: ServeOptions | None = None, state_file: str | None = None
) -> tuple[TrackerServer, asyncio.Task]:
    """Serve + drive an InMemoryTracker (in_memory_tracker.ts:167-181).

    Returns the server (for ports/close) and the pump task. The periodic
    sweep rides the pump loop's timeout rather than a separate timer.
    With ``state_file``, swarm state is restored at startup and saved on
    every sweep and at shutdown — a restart keeps lifetime ``downloaded``
    counters and live peers.
    """
    server = await serve_tracker(opts)
    tracker = InMemoryTracker(interval=(opts.interval if opts else DEFAULT_ANNOUNCE_INTERVAL))
    if state_file:
        tracker.load_state(state_file)

    def _persist():
        if state_file:
            try:
                tracker.save_state(state_file)
            except OSError:
                pass  # persistence is best-effort; serving goes on

    async def pump():
        last_sweep = time.monotonic()
        it = server.__aiter__()
        try:
            while True:
                try:
                    req = await asyncio.wait_for(it.__anext__(), timeout=60)
                except asyncio.TimeoutError:
                    req = None
                except StopAsyncIteration:
                    break
                if req is not None:
                    try:
                        await tracker.handle(req)
                    except Exception:
                        pass  # one bad request must not kill the tracker
                if time.monotonic() - last_sweep > SWEEP_INTERVAL:
                    tracker.sweep()
                    _persist()
                    last_sweep = time.monotonic()
        finally:
            _persist()

    task = asyncio.create_task(pump())
    task.tracker = tracker  # expose state for tests/stats
    return server, task


def main(argv=None):  # pragma: no cover - manual entrypoint (in_memory_tracker.ts:183-186)
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--http-port", type=int, default=8000)
    parser.add_argument(
        "--udp-port", type=int, default=6969, help="negative value disables UDP"
    )
    parser.add_argument("--interval", type=int, default=600)
    parser.add_argument("--state-file", help="persist swarm state across restarts")
    args = parser.parse_args(argv)

    async def go():
        server, task = await run_tracker(
            ServeOptions(
                http_port=args.http_port,
                udp_port=args.udp_port if args.udp_port >= 0 else None,
                interval=args.interval,
            ),
            state_file=args.state_file,
        )
        print(f"tracker listening: http={server.http_port} udp={server.udp_port}")
        await task

    asyncio.run(go())
    return 0


if __name__ == "__main__":  # pragma: no cover
    main()
