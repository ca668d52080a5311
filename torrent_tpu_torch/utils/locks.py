"""Named locks and guarded cells.

The reference creates every lock through ``analysis/sanitizer.py``'s
``named_lock``, which can swap in an instrumented lock (its tsan-lite
lockset and lock-order checker), and declares the shared state those
locks guard with ``guard_attrs``. That sanitizer is not ported yet, so
here a name is documentation only: the lock is a plain
``threading.Lock`` and a cell group's ``read``/``write`` do nothing.
Call sites keep the reference's lock and cell names, so porting the
sanitizer later changes this module and no caller.
"""

from __future__ import annotations

import threading


def named_lock(name: str) -> threading.Lock:
    """A plain lock; ``name`` identifies it to a future sanitizer."""
    del name
    return threading.Lock()


class _NullCells:
    """The cell group of a process without the sanitizer: one shared
    instance whose accesses record nothing."""

    __slots__ = ()

    def read(self, cell: str) -> None:
        pass

    def write(self, cell: str) -> None:
        pass


_NULL_CELLS = _NullCells()


def guard_attrs(owner: str, *cells: str) -> _NullCells:
    """The cells ``cells`` of ``owner`` (e.g. ``guard_attrs("sched.slab",
    "refs")`` names ``sched.slab.refs``); their ``read``/``write`` are
    no-ops until the sanitizer is ported."""
    del owner, cells
    return _NULL_CELLS
