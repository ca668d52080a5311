"""State carried across from the reference package.

The system has no weights: what both packages must share is the torrent
(v1 info dicts, v2 metainfo and v2 session geometry) and the staged
batches. These helpers take the reference's objects and
numpy arrays by duck typing, so this package never imports
``torrent_tpu``; the differential tests use them to feed both packages
identical input.
"""

from __future__ import annotations

import numpy as np
import torch

from torrent_tpu_torch.codec.metainfo import FileEntry, InfoDict
from torrent_tpu_torch.codec.metainfo_v2 import InfoDictV2, MetainfoV2, V2File
from torrent_tpu_torch.session.v2 import V2SessionInfo
from torrent_tpu_torch.utils.device import resolve_device


def info_from_reference(obj) -> InfoDict:
    """This package's ``InfoDict`` from the reference's (or any object
    with ``name``, ``piece_length``, ``pieces``, ``length`` and
    ``files`` attributes, where each file has ``length``, ``path`` and,
    optionally, ``pad``)."""
    files = None
    if obj.files is not None:
        files = tuple(
            FileEntry(
                length=int(f.length),
                path=tuple(f.path),
                pad=bool(getattr(f, "pad", False)),
            )
            for f in obj.files
        )
    return InfoDict(
        name=obj.name,
        piece_length=int(obj.piece_length),
        pieces=tuple(bytes(p) for p in obj.pieces),
        length=int(obj.length),
        files=files,
    )


def metainfo_v2_from_reference(obj) -> MetainfoV2:
    """This package's ``MetainfoV2`` from the reference's (or any object
    with ``announce``, ``info``, ``info_hash_v2``, ``piece_layers`` and
    ``raw``, whose ``info`` has ``name``, ``piece_length``, ``files`` and
    ``private``, and each file ``path``, ``length`` and ``pieces_root``)."""
    info = obj.info
    return MetainfoV2(
        announce=obj.announce,
        info=InfoDictV2(
            name=info.name,
            piece_length=int(info.piece_length),
            files=tuple(
                V2File(path=tuple(f.path), length=int(f.length), pieces_root=bytes(f.pieces_root))
                for f in info.files
            ),
            private=bool(info.private),
        ),
        info_hash_v2=bytes(obj.info_hash_v2),
        piece_layers={
            bytes(k): tuple(bytes(d) for d in v) for k, v in obj.piece_layers.items()
        },
        raw=obj.raw,
    )


def v2_session_info_from_reference(obj) -> V2SessionInfo:
    """This package's ``V2SessionInfo`` from the reference's (the flat
    piece geometry of a v2 torrent: expected roots, per-piece sizes and
    leaf-pad targets, and the file table)."""
    files = None
    if obj.files is not None:
        files = tuple(FileEntry(length=int(f.length), path=tuple(f.path)) for f in obj.files)
    return V2SessionInfo(
        name=obj.name,
        piece_length=int(obj.piece_length),
        pieces=tuple(bytes(p) for p in obj.pieces),
        length=int(obj.length),
        payload_length=int(obj.payload_length),
        files=files,
        piece_sizes=tuple(int(n) for n in obj.piece_sizes),
        piece_pad_leaves=tuple(int(n) for n in obj.piece_pad_leaves),
    )


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``arr`` on ``device``; uint32 arrays travel as int32 bits.

    The caller may reuse ``arr`` as soon as this returns: the tensor
    never aliases it (a pageable host→device copy has read its source
    by then, and on the CPU the tensor is a clone)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device, copy=True)


def batch_from_numpy(
    padded: np.ndarray, nblocks: np.ndarray, expected: np.ndarray, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A staged numpy batch (``uint8[B, P]`` or host-order ``uint32[B, P/4]``
    rows, ``int32[B]`` block counts, ``uint32[B, 5]`` expected words) as
    tensors on ``device`` (None means the GPU)."""
    dev = resolve_device(device)
    return (
        to_device(padded, dev),
        to_device(np.asarray(nblocks).astype(np.int32), dev),
        to_device(np.asarray(expected).astype(np.uint32), dev),
    )
