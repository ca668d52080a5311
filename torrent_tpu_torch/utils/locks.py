"""Named locks.

The reference creates every lock through ``analysis/sanitizer.py``'s
``named_lock``, which can swap in an instrumented lock (its tsan-lite
lockset and lock-order checker). That sanitizer is not ported yet, so
here a name is documentation only and the lock is a plain
``threading.Lock``. Call sites keep the reference's names, so porting
the sanitizer later changes this module and no caller.
"""

from __future__ import annotations

import threading


def named_lock(name: str) -> threading.Lock:
    """A plain lock; ``name`` identifies it to a future sanitizer."""
    del name
    return threading.Lock()
