"""Merkle-committed verify receipts + deterministic audit sampling.

The Byzantine verdict layer (``FabricConfig.byzantine_f > 0``) needs
three pure primitives, all of which must be bit-stable across
processes (this module is in the determinism pass SCOPE):

* **Commitments** — a publisher's per-unit verdict is committed as a
  Merkle root over leaves ``(unit, piece, digest, ok)``.  The root
  rides the heartbeat (40 hex chars per published unit, so
  AllgatherHeartbeat budgets stay fixed); the full leaf set is
  recomputable by ANY process from the published verdict bits plus the
  torrent's expected piece digests, which makes a forged root (root
  that does not match the claimed bits) detectable for free, and a
  bounded ``merkle_proof`` can be served on demand for any single
  leaf.
* **Audit sampling** — each round every process re-hashes a
  pseudo-random slice of every peer's claimed-ok pieces.  The sample
  is a keyed threshold draw over ``(fingerprint, seed, round, peer,
  unit, piece)`` so the schedule is deterministic given the plan
  fingerprint and seed: the same run replays bit-identically, yet no
  publisher can predict which of its claims will be audited without
  knowing the auditor's seed.
* **Evidence** — a mismatching leaf (claimed-ok piece that re-hashes
  bad) is self-certifying: any process holding the same storage bytes
  can re-verify it locally, so conviction evidence travels as the
  bare ``(peer, unit, piece)`` triple.

The tree shape follows RFC 6962 (Certificate Transparency): leaves are
domain-separated with ``0x00``, interior nodes with ``0x01``, and an
``n``-leaf tree splits at the largest power of two strictly less than
``n``.  sha1 matches the fabric's existing digest plane (BEP 3 piece
hashes); the commitment binds a *claim*, not content secrecy.
"""

# determinism-scope: module
# (Merkle commitments, audit draws, proofs: all exchanged/replayed bytes)

from __future__ import annotations

import hashlib

__all__ = [
    "audit_sample",
    "leaf_hash",
    "merkle_proof",
    "merkle_root",
    "unit_leaves",
    "verify_proof",
]

_LEAF = b"\x00"
_NODE = b"\x01"

# audit draws compare 32-bit keyed hashes against rate * 2**32
_DRAW_SPAN = 1 << 32


def leaf_hash(uid: int, piece: int, digest_hex: str, ok: bool) -> bytes:
    """Hash one receipt leaf ``(unit, piece, digest, ok)``.

    ``digest_hex`` is the *expected* piece digest for a claimed-ok
    piece (the claim being committed is "my bytes hash to the
    torrent's expected digest"); a claimed-bad piece commits the empty
    string so a liar cannot smuggle an arbitrary digest into the tree.
    """
    body = "%d|%d|%s|%d" % (int(uid), int(piece), digest_hex, 1 if ok else 0)
    return hashlib.sha1(_LEAF + body.encode("ascii")).digest()


def unit_leaves(uid, start, bits, digests) -> list[bytes]:
    """Leaves for one unit's verdict: piece indices are absolute.

    ``bits`` is the per-piece verdict slice for pieces
    ``[start, start + len(bits))`` and ``digests`` the matching
    expected piece digests (hex).  Claimed-bad pieces commit ``""``
    (see ``leaf_hash``).
    """
    out: list[bytes] = []
    for i in range(len(bits)):
        ok = bool(bits[i])
        out.append(leaf_hash(uid, start + i, digests[i] if ok else "", ok))
    return out


def _split(n: int) -> int:
    """Largest power of two strictly less than ``n`` (RFC 6962 §2.1)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def _subtree(leaves: list[bytes], lo: int, hi: int) -> bytes:
    if hi - lo == 1:
        return leaves[lo]
    k = _split(hi - lo)
    left = _subtree(leaves, lo, lo + k)
    right = _subtree(leaves, lo + k, hi)
    return hashlib.sha1(_NODE + left + right).digest()


def merkle_root(leaves: list[bytes]) -> str:
    """Hex Merkle root of a leaf list (empty list commits ``H("")``)."""
    if not leaves:
        return hashlib.sha1(b"").hexdigest()
    return _subtree(leaves, 0, len(leaves)).hex()


def merkle_proof(leaves: list[bytes], index: int) -> list[str]:
    """Audit path for ``leaves[index]``, sibling hashes leaf -> root."""
    if not 0 <= index < len(leaves):
        raise IndexError(f"leaf index {index} out of range [0, {len(leaves)})")

    def walk(lo: int, hi: int) -> list[bytes]:
        if hi - lo == 1:
            return []
        k = _split(hi - lo)
        if index < lo + k:
            return walk(lo, lo + k) + [_subtree(leaves, lo + k, hi)]
        return walk(lo + k, hi) + [_subtree(leaves, lo, lo + k)]

    return [h.hex() for h in walk(0, len(leaves))]


def verify_proof(
    leaf: bytes, index: int, nleaves: int, path: list[str], root_hex: str
) -> bool:
    """Check a ``merkle_proof`` audit path against a committed root.

    Total: returns ``False`` (never raises) on malformed input —
    out-of-range index, wrong path length, or non-hex path elements —
    so untrusted proof bytes can be fed straight in.
    """
    if nleaves < 1 or not 0 <= index < nleaves:
        return False
    try:
        siblings = [bytes.fromhex(p) for p in path]
    except (ValueError, TypeError):
        return False
    # Re-derive the tree shape top-down: at each level the proof's
    # sibling is either the right subtree (we descended left) or the
    # left (we descended right).
    sides: list[str] = []
    lo, hi = 0, nleaves
    while hi - lo > 1:
        k = _split(hi - lo)
        if index < lo + k:
            sides.append("R")
            hi = lo + k
        else:
            sides.append("L")
            lo = lo + k
    if len(siblings) != len(sides):
        return False
    node = leaf
    for side, sib in zip(reversed(sides), siblings):
        if side == "L":
            node = hashlib.sha1(_NODE + sib + node).digest()
        else:
            node = hashlib.sha1(_NODE + node + sib).digest()
    return node.hex() == root_hex


def audit_sample(
    fingerprint: str,
    seed: int,
    round_no: int,
    peer: int,
    uid: int,
    piece: int,
    rate: float,
) -> bool:
    """Deterministic audit coin for one claimed-ok piece.

    True iff the keyed 32-bit draw over ``(fingerprint, seed, round,
    peer, unit, piece)`` lands under ``rate``.  Pure: the same inputs
    always flip the same way, so a run's audit schedule replays
    bit-identically, while distinct rounds re-draw so every claim is
    eventually sampled with probability ``1 - (1 - rate)**rounds``.
    """
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    key = "audit|%s|%d|%d|%d|%d|%d" % (
        fingerprint,
        int(seed),
        int(round_no),
        int(peer),
        int(uid),
        int(piece),
    )
    draw = int.from_bytes(hashlib.sha1(key.encode("ascii")).digest()[:4], "big")
    return draw < int(rate * _DRAW_SPAN)
