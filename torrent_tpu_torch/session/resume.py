"""Fastresume: checkpoint/resume of session state (SURVEY §5 gap).

The reference lists "Resumption of torrent" as unchecked roadmap
(README.md:34); its only substrate is the bitfield + StorageMethod.exists.
Here resume is two complementary paths:

1. **Fastresume file** (this module): a bencoded sidecar checkpoint of
   the bitfield + transfer counters, saved on stop/progress and loaded
   on start — O(1) resume for cleanly-stopped sessions.
2. **Full recheck** (parallel/verify.py): hash everything on the cpu|gpu
   plane — the trustless path for missing/stale checkpoints, and the
   BASELINE north-star workload.

A loaded checkpoint is cross-checked against file sizes; any mismatch
falls back to the full recheck, so a lying checkpoint can't corrupt the
swarm (we'd serve bad pieces and get banned — worse than rechecking).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from torrent_tpu_torch.codec.bencode import BencodeError, bdecode, bencode
from torrent_tpu_torch.utils.bitfield import Bitfield

FORMAT_VERSION = 1


# partial-piece persistence caps: the resume file must stay small and a
# hostile checkpoint must not balloon memory
MAX_SAVED_PARTIALS = 64


@dataclass
class ResumeData:
    info_hash: bytes
    num_pieces: int
    bitfield: bytes
    uploaded: int = 0
    downloaded: int = 0
    # in-flight pieces at checkpoint time: piece index -> (block bitmap
    # LSB-first, buffer with received spans filled). Restart re-ingests
    # them so up to piece_length per partial isn't re-downloaded;
    # verification still gates persistence when the piece completes.
    partials: dict = field(default_factory=dict)
    # BEP 3 `completed` bookkeeping across restarts: ``completed_reported``
    # latches that the event was ever queued (a piece lost via BEP 54 and
    # re-fetched later must not announce a second completion);
    # ``completed_owed`` survives a crash between queuing the event and
    # the tracker actually receiving it, so the restarted session still
    # delivers the snatch.
    completed_reported: bool = False
    completed_owed: bool = False

    def encode(self) -> bytes:
        top = {
            b"version": FORMAT_VERSION,
            b"info_hash": self.info_hash,
            b"num_pieces": self.num_pieces,
            b"bitfield": self.bitfield,
            b"uploaded": self.uploaded,
            b"downloaded": self.downloaded,
        }
        if self.completed_reported:
            top[b"completed"] = 1
        if self.completed_owed:
            top[b"completed_owed"] = 1
        if self.partials:
            top[b"partials"] = {
                str(i).encode(): {b"mask": mask, b"data": data}
                for i, (mask, data) in sorted(self.partials.items())[
                    :MAX_SAVED_PARTIALS
                ]  # the single cap point (bounds file size + decode memory)
            }
        return bencode(top)

    @classmethod
    def decode(cls, raw: bytes) -> "ResumeData | None":
        try:
            d = bdecode(raw)
        except BencodeError:
            return None
        if not isinstance(d, dict) or d.get(b"version") != FORMAT_VERSION:
            return None
        partials: dict = {}
        saved = d.get(b"partials")
        if isinstance(saved, dict):
            for key, ent in list(saved.items())[:MAX_SAVED_PARTIALS]:
                if not (
                    isinstance(key, bytes)
                    and key.isdigit()
                    and isinstance(ent, dict)
                    and isinstance(ent.get(b"mask"), bytes)
                    and isinstance(ent.get(b"data"), bytes)
                ):
                    return None  # corrupt partial section → full recheck
                partials[int(key)] = (ent[b"mask"], ent[b"data"])
        try:
            rd = cls(
                info_hash=d[b"info_hash"],
                num_pieces=d[b"num_pieces"],
                bitfield=d[b"bitfield"],
                uploaded=d[b"uploaded"],
                downloaded=d[b"downloaded"],
                partials=partials,
                completed_reported=d.get(b"completed", 0) == 1,
                completed_owed=d.get(b"completed_owed", 0) == 1,
            )
        except KeyError:
            return None
        # Field types are attacker-controlled (bdecode gives int|bytes|...);
        # any type confusion means a corrupt checkpoint → full recheck.
        if not (
            isinstance(rd.info_hash, bytes)
            and isinstance(rd.num_pieces, int)
            and isinstance(rd.bitfield, bytes)
            and isinstance(rd.uploaded, int)
            and isinstance(rd.downloaded, int)
        ):
            return None
        if len(rd.info_hash) != 20 or rd.num_pieces < 0:
            return None
        if rd.uploaded < 0 or rd.downloaded < 0:
            return None
        try:
            Bitfield(rd.num_pieces, rd.bitfield)
        except ValueError:
            return None
        return rd


class FsResumeStore:
    """One ``.resume`` file per torrent, keyed by info hash, in ``root``."""

    def __init__(self, root: str | os.PathLike):
        self.root = os.fspath(root)

    def _path(self, info_hash: bytes) -> str:
        return os.path.join(self.root, f".{info_hash.hex()}.resume")

    def load(self, info_hash: bytes) -> ResumeData | None:
        try:
            with open(self._path(info_hash), "rb") as f:
                raw = f.read()
        except OSError:
            return None
        rd = ResumeData.decode(raw)
        if rd is None or rd.info_hash != info_hash:
            return None
        return rd

    def save(self, data: ResumeData) -> None:
        os.makedirs(self.root, exist_ok=True)
        tmp = self._path(data.info_hash) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data.encode())
        os.replace(tmp, self._path(data.info_hash))  # atomic checkpoint

    def delete(self, info_hash: bytes) -> None:
        try:
            os.remove(self._path(info_hash))
        except OSError:
            pass


class MemoryResumeStore:
    """In-memory store for tests."""

    def __init__(self):
        self.data: dict[bytes, bytes] = {}

    def load(self, info_hash: bytes) -> ResumeData | None:
        raw = self.data.get(info_hash)
        return ResumeData.decode(raw) if raw else None

    def save(self, data: ResumeData) -> None:
        self.data[data.info_hash] = data.encode()

    def delete(self, info_hash: bytes) -> None:
        self.data.pop(info_hash, None)
