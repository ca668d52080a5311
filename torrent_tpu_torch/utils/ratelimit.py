"""Async token-bucket rate limiter for transfer caps.

No reference counterpart (the reference serves blocks unthrottled,
torrent.ts:158-176); real clients cap upload so seeding doesn't saturate
the uplink, and optionally download. One bucket per direction lives on
the Client and is shared by every torrent, so the cap is global.

Continuous refill at ``rate`` bytes/s with a one-second burst capacity;
``take(n)`` waits (without blocking the event loop) until ``n`` tokens
are available. ``n`` may exceed the capacity — the cost is carried as a
deficit so oversized requests still pace correctly instead of hanging.
The clock is injectable for deterministic tests.
"""

from __future__ import annotations

import asyncio
import time


class TokenBucket:
    """``rate`` bytes/s; ``rate <= 0`` means unlimited (take returns at once)."""

    def __init__(self, rate: float, clock=time.monotonic):
        self.rate = float(rate)
        self._clock = clock
        self._tokens = float(rate)
        self._last = clock()
        # FIFO fairness: takers queue on one lock so a large request
        # can't be starved by a stream of small ones slipping past it
        self._lock = asyncio.Lock()

    @property
    def unlimited(self) -> bool:
        return self.rate <= 0

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.rate, self._tokens + (now - self._last) * self.rate)
        self._last = now

    async def take(self, n: int) -> None:
        if self.unlimited or n <= 0:
            return
        async with self._lock:
            self._refill()
            while self._tokens < min(n, self.rate):
                need = min(n, self.rate) - self._tokens
                await asyncio.sleep(need / self.rate)
                self._refill()
            # oversized takes (> 1 s of rate) go negative: the deficit
            # pushes subsequent takers out, preserving the average rate
            self._tokens -= n
