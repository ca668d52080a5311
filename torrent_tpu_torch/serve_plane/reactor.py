"""The serve reactor: bounded workers multiplexing peer request queues.

The legacy model serves a request inline in the requesting peer's read
loop: one slow disk read head-of-line blocks that peer's entire wire
(incoming Haves, keepalives, everything), and a thousand greedy leechers
mean a thousand interleaved serve coroutines racing the same piece
cache. The reactor decouples the wire from the disk:

* each peer gets a bounded FIFO of pending requests
  (:attr:`per_peer_queue`); ``submit`` returns ``False`` when it's full
  — the session answers with a BEP 6 reject instead of buffering
  unbounded hostile demand (per-peer send backpressure);
* a fixed pool of :attr:`workers` drains peers round-robin, up to
  :attr:`batch` requests per turn — a peer hammering pipelined requests
  can't starve the others, and sequential blocks of one piece batch
  through the serve cache together;
* ``cancel`` removes queued entries by predicate (BEP 3 Cancel /
  BEP 6 reject-on-cancel for requests that never reached a worker) and
  ``drop`` clears a disconnecting peer's queue.

Everything here is event-loop confined (the session's asyncio loop): no
locks by design — the cross-thread surfaces are the telemetry
registries, which carry their own. Workers are spawned through the
session's ``_spawn`` so task accounting and teardown stay uniform.
"""

from __future__ import annotations

import asyncio
from collections import deque

__all__ = ["ReactorPool"]


class ReactorPool:
    """Bounded request multiplexer for one torrent's serve side."""

    def __init__(self, serve, workers: int = 4, per_peer_queue: int = 64, batch: int = 8):
        self._serve = serve  # async (peer_key, item) -> None
        self.workers = max(1, int(workers))
        self.per_peer_queue = max(1, int(per_peer_queue))
        self.batch = max(1, int(batch))
        self._queues: dict[object, deque] = {}
        # keys with work, in arrival order; _scheduled keeps each key in
        # the ready ring at most once
        self._ready: deque = deque()
        self._scheduled: set = set()
        self._wakeup = asyncio.Event()
        self._tasks: list[asyncio.Task] = []
        self._closing = False
        self.submitted = 0
        self.rejected = 0
        self.served = 0

    # ---------------------------------------------------------- lifecycle

    @property
    def running(self) -> bool:
        return bool(self._tasks) and not self._closing

    def start(self, spawn) -> None:
        """Spawn the worker pool via the session's task factory."""
        if self._tasks:
            return
        self._closing = False
        for i in range(self.workers):
            self._tasks.append(spawn(self._worker(), name=f"serve-reactor-{i}"))

    def forget(self) -> None:
        """Detach from workers someone else is tearing down (the session
        cancels its own spawned tasks): queues drop, state resets so a
        later ``start`` respawns cleanly."""
        self._closing = True
        self._wakeup.set()
        self._tasks.clear()
        self._queues.clear()
        self._ready.clear()
        self._scheduled.clear()

    async def aclose(self) -> None:
        self._closing = True
        self._wakeup.set()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        self._queues.clear()
        self._ready.clear()
        self._scheduled.clear()

    # ------------------------------------------------------------- intake

    def submit(self, key, item) -> bool:
        """Enqueue one request for ``key``. ``False`` = queue full
        (the caller owes the peer an explicit reject)."""
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
        if len(q) >= self.per_peer_queue:
            self.rejected += 1
            return False
        q.append(item)
        self.submitted += 1
        if key not in self._scheduled:
            self._scheduled.add(key)
            self._ready.append(key)
        self._wakeup.set()
        return True

    def cancel(self, key, predicate) -> list:
        """Remove queued items matching ``predicate``; returns them (the
        session sends BEP 6 rejects for each on fast connections)."""
        q = self._queues.get(key)
        if not q:
            return []
        kept, gone = deque(), []
        for item in q:
            (gone if predicate(item) else kept).append(item)
        self._queues[key] = kept
        if not kept and key in self._scheduled:
            # leave the ready-ring entry; the worker skips empty queues
            pass
        return gone

    def drop(self, key) -> int:
        """Forget a departing peer's queue; returns the request count
        it abandoned."""
        q = self._queues.pop(key, None)
        return len(q) if q else 0

    def depth(self, key) -> int:
        q = self._queues.get(key)
        return len(q) if q else 0

    # ------------------------------------------------------------ workers

    async def _worker(self) -> None:
        while not self._closing:
            if not self._ready:
                self._wakeup.clear()
                await self._wakeup.wait()
                continue
            key = self._ready.popleft()
            q = self._queues.get(key)
            if not q:
                self._scheduled.discard(key)
                continue
            served = 0
            while q and served < self.batch:
                item = q.popleft()
                served += 1
                try:
                    await self._serve(key, item)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # the serve callback owns its error handling (drops,
                    # rejects); a leak here must not kill the worker
                    pass
                self.served += 1
                q = self._queues.get(key)  # drop() may have removed it
            if q:
                # round-robin: leftover work goes to the back of the ring
                self._ready.append(key)
            else:
                self._scheduled.discard(key)
