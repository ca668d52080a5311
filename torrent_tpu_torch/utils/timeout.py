"""Timeout helpers (reference layer L0: utils.ts).

Unlike the reference's ``withTimeout`` (utils.ts:16-29, SURVEY §8.6) which
races a timer but leaves the underlying operation running, asyncio's
cancellation actually tears the awaitable down, so sockets don't leak.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, TypeVar

T = TypeVar("T")


class TimeoutError_(Exception):
    """Raised when an operation exceeds its deadline (utils.ts:10)."""


async def with_timeout(aw: Awaitable[T], seconds: float) -> T:
    """Await ``aw`` with a deadline; cancel it and raise on expiry."""
    try:
        return await asyncio.wait_for(aw, timeout=seconds)
    except asyncio.TimeoutError as e:
        raise TimeoutError_(f"operation timed out after {seconds}s") from e
