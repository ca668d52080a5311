"""Piece bitfield (the reference sizes one per peer, peer.ts:25).

BEP 3 bit order: bit 0 of byte 0 is piece 0, MSB-first within each byte.
Spare bits in the final byte must be zero on the wire.

numpy-backed: at the framework's target geometry (100k+ pieces, dozens
of peers) per-piece Python loops over bitfields make every bitfield
message and interest check O(n_pieces) of interpreter work — here
membership is an array load, counts are cached, and bulk ops
(availability accounting, interest checks, rarity ordering) run as
vector ops over ``as_numpy()`` views.
"""

from __future__ import annotations

import numpy as np


class Bitfield:
    __slots__ = ("n", "_bits", "_count")

    def __init__(self, n: int, data: bytes | None = None):
        self.n = n
        nbytes = (n + 7) // 8
        if data is None:
            self._bits = np.zeros(n, dtype=bool)
            self._count = 0
        else:
            if len(data) != nbytes:
                raise ValueError(f"bitfield needs {nbytes} bytes for {n} pieces, got {len(data)}")
            if n % 8 and data[-1] & ((1 << (8 - n % 8)) - 1):
                raise ValueError("bitfield has spare bits set")
            raw = np.frombuffer(data, dtype=np.uint8)
            self._bits = np.unpackbits(raw, count=n).astype(bool) if n else np.zeros(0, dtype=bool)
            self._count = int(self._bits.sum())

    def __len__(self) -> int:
        return self.n

    def has(self, i: int) -> bool:
        if not 0 <= i < self.n:
            raise IndexError(i)
        return bool(self._bits[i])

    def set(self, i: int, value: bool = True) -> None:
        if not 0 <= i < self.n:
            raise IndexError(i)
        if bool(self._bits[i]) != value:
            self._count += 1 if value else -1
            self._bits[i] = value

    def count(self) -> int:
        return self._count

    @property
    def complete(self) -> bool:
        return self._count == self.n

    def to_bytes(self) -> bytes:
        return np.packbits(self._bits).tobytes()

    def missing(self) -> list[int]:
        """Indices not yet set (vectorized; Python ints)."""
        return np.flatnonzero(~self._bits).tolist()

    def as_numpy(self) -> np.ndarray:
        """Read-only bool view for vectorized bulk ops (availability
        deltas, interest checks). Mutate only through ``set``/``from_numpy``
        so the cached count stays honest."""
        v = self._bits.view()
        v.setflags(write=False)
        return v

    def from_numpy(self, arr) -> None:
        """Bulk-load from a bool array (the verify plane's output)."""
        if len(arr) != self.n:
            raise ValueError("array length mismatch")
        self._bits = np.array(arr, dtype=bool)
        self._count = int(self._bits.sum())

    def __repr__(self) -> str:
        return f"Bitfield({self._count}/{self.n})"
