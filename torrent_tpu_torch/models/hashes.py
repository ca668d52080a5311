"""BEP 52 merkle hash transfer: serve and verify ``hash request`` data.

v2/hybrid swarms exchange per-file merkle subtrees on the wire
(messages 21-23, net/protocol.py) so a downloader can verify 16 KiB
blocks against the ``pieces root`` in the info dict without trusting
the sender. This module is the math behind both sides:

- ``HashTreeCache.serve`` answers a request from a file's *piece
  layer* (what a `.torrent`'s ``piece layers`` dict carries): the
  requested run of hashes plus the uncle hashes that chain its subtree
  root up to ``pieces root``.
- ``verify_hash_response`` replays that chain and accepts only if it
  lands exactly on the expected root — the client-side check.

Layer numbering follows the BEP: layer 0 is the 16 KiB leaf layer and
grows upward, so a file's piece layer sits at
``log2(piece_length / 16384)``. The served layer is padded to a power
of two with zero-subtree roots of matching height (the same padding
rule the file root itself is computed with, models/merkle.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from torrent_tpu_torch.codec.metainfo_v2 import BLOCK
from torrent_tpu_torch.models.merkle import zero_chain

# DoS bound: the longest hash run a single request may ask for (16 KiB
# of digests); every validation on a request lives in serve() itself
MAX_RUN = 512


@dataclass(frozen=True)
class HashRequestFields:
    """The five fields shared by request/response/reject (BEP 52)."""

    pieces_root: bytes
    base_layer: int
    index: int
    length: int
    proof_layers: int


def _layer_height(piece_length: int) -> int:
    """Piece layer number = log2(piece_length / BLOCK)."""
    return (piece_length // BLOCK).bit_length() - 1


class HashTreeCache:
    """Per-torrent cache of reconstructed upper merkle layers.

    Built lazily per ``pieces_root`` from the piece layer; a layer of n
    hashes reconstructs ``log2(n)`` upper levels of 32-byte digests —
    a 100k-piece file costs ~6.4 MB once, then every request is a
    slice + a handful of sibling lookups.
    """

    def __init__(self, piece_layers: dict[bytes, tuple[bytes, ...]], piece_length: int):
        self.piece_layers = piece_layers
        self.piece_length = piece_length
        self.base = _layer_height(piece_length)
        self._trees: dict[bytes, list[list[bytes]]] = {}
        self._single_roots: set[bytes] = set()
        # serve() runs in worker threads (session offloads the first
        # build); one lock bounds a pipelined burst of requests for the
        # same root to a single tree construction
        from torrent_tpu_torch.utils.locks import named_lock

        self._build_lock = named_lock("models.hashes._build_lock")

    def _tree_for(self, root: bytes) -> list[list[bytes]] | None:
        with self._build_lock:
            return self._tree_for_locked(root)

    def _tree_for_locked(self, root: bytes) -> list[list[bytes]] | None:
        tree = self._trees.get(root)
        if tree is not None:
            return tree
        layer = self.piece_layers.get(root)
        if layer is None:
            # single-piece files carry no piece-layers entry: their root
            # IS the only piece hash, a one-node base layer — but only
            # for roots the owner registered (anything else is unknown)
            if root not in self._known_single_roots():
                return None
            layer = (root,)
        padded = 1 << max(0, (len(layer) - 1).bit_length())
        zero = zero_chain(self.base)[self.base]
        level = list(layer) + [zero] * (padded - len(layer))
        levels = [level]
        while len(level) > 1:
            level = [
                hashlib.sha256(level[i] + level[i + 1]).digest()
                for i in range(0, len(level), 2)
            ]
            levels.append(level)
        if levels[-1][0] != root:
            return None  # corrupt layer; never serve from it
        self._trees[root] = levels
        return levels

    def _known_single_roots(self) -> set[bytes]:
        return self._single_roots

    def add_single_piece_roots(self, roots) -> None:
        """Register roots of files that fit in one piece (no layer entry)."""
        self._single_roots = set(roots)

    def serve(self, req: HashRequestFields) -> list[bytes] | None:
        """→ ``length + proof_layers`` hashes, or None (reject).

        Requests below the piece layer need file data we don't index
        here; requests above it are equivalent to a shorter piece-layer
        request, so both are rejected — real clients ask at the piece
        layer (libtorrent does exactly this for seeding from metadata).
        """
        if (
            req.base_layer != self.base
            or req.length < 1
            or req.length > MAX_RUN
            or req.length & (req.length - 1)
            or req.index % req.length
            or req.index < 0
            or req.proof_layers < 0
        ):
            return None
        levels = self._tree_for(req.pieces_root)
        if levels is None or req.index >= len(levels[0]):
            return None
        # levels[0] is already zero-padded to a power of two, and the
        # proof-availability check below rejects any span past it
        run = levels[0][req.index : req.index + req.length]
        # the span [index, index+length) reduces to one node this many
        # levels up; proofs are that node's successive siblings
        span_level = req.length.bit_length() - 1
        avail = len(levels) - 1 - span_level
        if req.proof_layers > avail:
            return None
        proofs = []
        pos = req.index >> span_level
        for k in range(req.proof_layers):
            level = levels[span_level + k]
            proofs.append(level[pos ^ 1])
            pos >>= 1
        return run + proofs


def verify_hash_response(req: HashRequestFields, hashes: list[bytes]) -> bool:
    """Client-side acceptance: the run + proofs must chain to pieces_root.

    ``proof_layers`` must cover the whole distance to the root (the
    normal request shape); anything shorter reduces to an unverifiable
    midpoint and is refused — a partial proof proves nothing without a
    trusted intermediate digest.
    """
    if (
        req.length < 1
        or req.length & (req.length - 1)
        or req.index < 0
        or req.proof_layers < 0
        or len(hashes) != req.length + req.proof_layers
    ):
        return False  # malformed geometry can't verify (and must not raise)
    run, proofs = hashes[: req.length], hashes[req.length :]
    level = list(run)
    while len(level) > 1:
        level = [
            hashlib.sha256(level[i] + level[i + 1]).digest()
            for i in range(0, len(level), 2)
        ]
    node = level[0]
    pos = req.index >> (req.length.bit_length() - 1)
    for sibling in proofs:
        pair = (sibling + node) if pos & 1 else (node + sibling)
        node = hashlib.sha256(pair).digest()
        pos >>= 1
    return pos == 0 and node == req.pieces_root
