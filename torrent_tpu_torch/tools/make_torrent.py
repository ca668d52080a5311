""".torrent authoring (ref L7: tools/make_torrent.ts, 250 LoC).

The reference's only compute-bound path: read every piece, SHA1 it, emit
the metainfo (tools/make_torrent.ts:115-174). Differences by design:

- **Batched hashing**: pieces accumulate into batches and hash through
  the device hash plane (``GPUVerifier.hash_pieces``, ``hasher='gpu'``)
  or hashlib (``hasher='cpu'``) — the reference pipelines per-piece WebCrypto
  promises (tools/make_torrent.ts:96-111); we pipeline whole batches.
- Same piece-length heuristic: power of two, 32 KiB–1 MiB, targeting
  ~1000 pieces (tools/make_torrent.ts:18-33).
- Multi-file pieces span file boundaries via a carry buffer
  (tools/make_torrent.ts:62-113) — here a single streaming reader over
  the concatenated file list.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Iterator

from torrent_tpu_torch.codec.bencode import bencode

MIN_PIECE_LEN = 32 * 1024
MAX_PIECE_LEN = 1024 * 1024
TARGET_PIECES = 1000


def choose_piece_length(total_size: int) -> int:
    """Power of 2 in [32 KiB, 1 MiB] targeting ~1000 pieces
    (tools/make_torrent.ts:18-33)."""
    target = max(1, total_size // TARGET_PIECES)
    plen = MIN_PIECE_LEN
    while plen < target and plen < MAX_PIECE_LEN:
        plen *= 2
    return plen


def collect_files(root: str) -> list[tuple[str, int]]:
    """Deterministic walk → [(relpath, size)] (tools/make_torrent.ts:35-60)."""
    out: list[tuple[str, int]] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            out.append((os.path.relpath(full, root), os.path.getsize(full)))
    return out


def _iter_pieces(paths: list[str], piece_len: int, pad: bool = False) -> Iterator[bytes]:
    """Stream fixed-size pieces across file boundaries (the carry-buffer
    loop of tools/make_torrent.ts:62-113, as a generator).

    With ``pad``, zero bytes fill to the next piece boundary after every
    file but the last (BEP 47): the zeros are hashed into the piece
    stream exactly as a downloader's virtual pad spans will replay them.
    """
    carry = bytearray()
    for i, path in enumerate(paths):
        with open(path, "rb") as f:
            while True:
                chunk = f.read(max(piece_len, 1 << 20))
                if not chunk:
                    break
                carry += chunk
                while len(carry) >= piece_len:
                    yield bytes(carry[:piece_len])
                    del carry[:piece_len]
        if pad and i < len(paths) - 1 and len(carry) % piece_len:
            carry += bytes(piece_len - len(carry) % piece_len)
            while len(carry) >= piece_len:
                yield bytes(carry[:piece_len])
                del carry[:piece_len]
    if carry:
        yield bytes(carry)


@dataclass
class _Hasher:
    """Batched piece hasher: hashlib or the GPU hash plane."""

    hasher: str = "gpu"
    piece_length: int = MIN_PIECE_LEN
    batch_size: int = 256
    device: object = None
    _verifier: object = None

    def digests(self, pieces: Iterator[bytes], progress: Callable | None = None) -> list[bytes]:
        if self.hasher == "cpu":
            import hashlib

            out = []
            for i, p in enumerate(pieces):
                out.append(hashlib.sha1(p).digest())
                if progress and (i + 1) % 64 == 0:
                    progress(i + 1)
            if progress and out:
                progress(len(out))  # final count (not a multiple of 64)
            return out
        if self.hasher == "gpu":
            from torrent_tpu_torch.models.verifier import GPUVerifier

            if self._verifier is None:
                self._verifier = GPUVerifier(
                    piece_length=self.piece_length,
                    batch_size=self.batch_size,
                    device=self.device,
                )
            out = []
            batch: list[bytes] = []
            for p in pieces:
                batch.append(p)
                if len(batch) >= self.batch_size:
                    out.extend(self._verifier.hash_pieces(batch))
                    batch.clear()
                    if progress:
                        progress(len(out))
            if batch:
                out.extend(self._verifier.hash_pieces(batch))
            if progress and out:
                progress(len(out))
            return out
        raise ValueError(f"unknown hasher {self.hasher!r}")


def make_torrent(
    path: str,
    tracker: str,
    comment: str | None = None,
    piece_length: int | None = None,
    hasher: str = "gpu",
    progress: Callable | None = None,
    announce_list: list[list[str]] | None = None,
    private: bool = False,
    web_seeds: list[str] | None = None,
    pad_files: bool = False,
    similar: list[bytes] | None = None,
    collections: list[str] | None = None,
    update_url: str | None = None,
    device=None,
) -> bytes:
    """Author a .torrent for a file or directory (tools/make_torrent.ts:115).

    Returns the bencoded metainfo bytes; caller writes them where it wants.
    ``announce_list`` adds BEP 12 tiers; ``private`` sets BEP 27's flag
    (changes the infohash — clients then skip DHT/PEX); ``web_seeds``
    adds a BEP 19 ``url-list``; ``pad_files`` inserts BEP 47 pad entries
    so every file after the first starts on a piece boundary (single-GET
    webseed ranges, per-file piece reuse — multi-file only); ``similar``
    (infohashes) and ``collections`` (group names) are BEP 38 hints that
    let downloaders reuse identical local files from related torrents —
    written INSIDE the info dict so the hints are infohash-bound.
    ``hasher="gpu"`` (the default) hashes on ``device`` (None means the
    GPU; a host without one raises); ``hasher="cpu"`` is hashlib.
    """
    path = os.fspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    is_dir = os.path.isdir(path)
    name = os.path.basename(os.path.abspath(path))

    if is_dir:
        files = collect_files(path)
        if not files:
            raise ValueError(f"directory {path!r} contains no files")
        total = sum(size for _, size in files)
        abs_paths = [os.path.join(path, rel) for rel, _ in files]
    else:
        total = os.path.getsize(path)
        abs_paths = [path]

    plen = piece_length or choose_piece_length(total)
    pad = bool(pad_files and is_dir and len(abs_paths) > 1)
    hasher_obj = _Hasher(hasher=hasher, piece_length=plen, device=device)
    digests = hasher_obj.digests(_iter_pieces(abs_paths, plen, pad=pad), progress)

    info: dict = {
        b"name": name.encode("utf-8"),
        b"piece length": plen,
        b"pieces": b"".join(digests),
    }
    if is_dir:
        entries = []
        for i, (rel, size) in enumerate(files):
            entries.append(
                {b"length": size, b"path": [c.encode("utf-8") for c in rel.split(os.sep)]}
            )
            short = size % plen
            if pad and i < len(files) - 1 and short:
                # BEP 47: an attr-p entry downloaders virtualize as zeros
                pad_len = plen - short
                entries.append(
                    {
                        b"attr": b"p",
                        b"length": pad_len,
                        b"path": [b".pad", str(pad_len).encode()],
                    }
                )
        info[b"files"] = entries
    else:
        info[b"length"] = total

    if private:
        info[b"private"] = 1  # BEP 27 — inside info: part of the infohash
    if similar:
        for h in similar:
            if not isinstance(h, bytes) or len(h) not in (20, 32):
                raise ValueError("similar entries must be 20- or 32-byte infohashes")
        info[b"similar"] = list(similar)  # BEP 38
    if collections:
        info[b"collections"] = [c.encode("utf-8") for c in collections]  # BEP 38
    if update_url:
        info[b"update-url"] = update_url.encode("utf-8")  # BEP 39

    top: dict = {b"announce": tracker.encode("utf-8"), b"info": info}
    if announce_list:
        top[b"announce-list"] = [
            [t.encode("utf-8") for t in tier] for tier in announce_list
        ]
    if web_seeds:
        top[b"url-list"] = [u.encode("utf-8") for u in web_seeds]  # BEP 19
    if comment:
        top[b"comment"] = comment.encode("utf-8")
    top[b"creation date"] = int(time.time())
    top[b"created by"] = b"torrent-tpu/0.1"
    return bencode(top)


def main(argv: list[str] | None = None) -> int:  # pragma: no cover - CLI shell
    """argv CLI with a \\r progress line (tools/make_torrent.ts:190-250)."""
    import argparse

    parser = argparse.ArgumentParser(prog="make_torrent", description=__doc__)
    parser.add_argument("path", help="file or directory to share")
    parser.add_argument("tracker", help="announce URL")
    parser.add_argument("-o", "--output", help="output .torrent path")
    parser.add_argument("-c", "--comment")
    parser.add_argument("--piece-length", type=int)
    parser.add_argument("--hasher", choices=("cpu", "gpu"), default="gpu")
    args = parser.parse_args(argv)

    def progress(n):
        sys.stderr.write(f"\rhashed {n} pieces...")
        sys.stderr.flush()

    data = make_torrent(
        args.path,
        args.tracker,
        comment=args.comment,
        piece_length=args.piece_length,
        hasher=args.hasher,
        progress=progress,
    )
    out = args.output or (os.path.basename(os.path.abspath(args.path)) + ".torrent")
    with open(out, "wb") as f:
        f.write(data)
    sys.stderr.write(f"\rwrote {out} ({len(data)} bytes)\n")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
