"""The host-to-device copy, counted: how fast each slot copy ran on the
card, and whether a load ran beside it.

Two pipeline-ledger counters (``obs/ledger.py``), charged by
:meth:`PipelineLedger.record` on every v1 recheck route
(``models/verifier.py::GPUVerifier``) and the v2 recheck
(``parallel/verify.py::verify_pieces_v2_gpu``):

* ``h2d_beside_load`` / ``h2d_alone`` — one op a slot copy: its bytes
  (the data rows and the block counts) and its seconds on the card, from
  two timing events around it on the stream that carries it. A copy is
  ``beside_load`` when the loader's next load was still running as the
  copy was enqueued.

The counters are ``PipelineLedger.COUNTERS``: ``obs/attrib.py`` never
names one the bottleneck.
"""

from __future__ import annotations

__all__ = ["Copy"]


class Copy:
    """One slot copy bracketed on the card: ``start`` and ``end`` are timing
    events around its data rows and block counts on the stream that
    carries it, ``beside`` whether a load was running as it was enqueued.
    :meth:`charge` once the path has waited past ``end``."""

    __slots__ = ("start", "end", "nbytes", "beside")

    def __init__(self, start, end, nbytes: int, beside: bool):
        self.start, self.end, self.nbytes, self.beside = start, end, nbytes, beside

    def charge(self, ledger=None) -> None:
        from torrent_tpu_torch.obs.ledger import pipeline_ledger

        led = ledger or pipeline_ledger()
        seconds = self.start.elapsed_time(self.end) / 1e3
        led.record("h2d_beside_load" if self.beside else "h2d_alone", self.nbytes, seconds)
