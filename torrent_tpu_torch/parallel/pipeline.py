"""The recheck plane's batch pipeline: how a recheck overlaps the read
of one batch with the copy and hashing of the one before.

Every device recheck (``GPUVerifier`` for the v1 routes, direct,
multi-process and bulk, and ``parallel/verify.py::verify_pieces_v2_gpu``)
runs its batches through :func:`run_batches`; each route says only how a
batch is loaded, launched and drained.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from torrent_tpu_torch.obs.profiler import annotate, maybe_profile_batch


def run_batches(
    n: int,
    load: Callable[[int], Any],
    launch: Callable[[int, Any, bool], Any],
    drain: Callable[[Any], None],
    region: str,
) -> None:
    """Run batches ``0..n-1``: ``load(i)`` on one loader thread,
    ``launch(i, loaded, beside)`` and ``drain(pending)`` on this one.

    Batch ``i+1``'s load is submitted before batch ``i`` launches, so
    the loader fills one buffer while the other is copied and hashed;
    ``beside`` says whether that load was still running as batch ``i``
    launched (False for the last batch: no load is left). ``launch``
    returns what ``drain`` takes. One batch stays in flight beyond the
    one being launched: batch ``i-1`` drains after batch ``i`` launched,
    so the kernel of ``i`` overlaps the host's wait for ``i-1``, and
    the last batch drains inside its own region.

    Each batch is a ``region`` profiler region (``maybe_profile_batch``:
    the first N captured under ``TORRENT_TPU_PROFILE``) holding this
    thread's ``verify.wait_load`` wait for its load. An exception of a
    load or a launch leaves the loop: no later batch launches, and the
    loader is shut down once its running load ends.
    """
    if n == 0:
        return
    with ThreadPoolExecutor(max_workers=1) as loader:
        fut = loader.submit(load, 0)
        pending = None
        for i in range(n):
            with maybe_profile_batch(region):
                with annotate("verify.wait_load"):
                    loaded = fut.result()
                if i + 1 < n:
                    fut = loader.submit(load, i + 1)
                launched = launch(i, loaded, not fut.done())
                if pending is not None:
                    drain(pending)
                pending = launched
                if i + 1 == n:
                    drain(pending)
