"""State carried across from the reference package.

The system has no weights: what both packages must share is the torrent
and the staged batches. These helpers take the reference's objects and
numpy arrays by duck typing, so this package never imports
``torrent_tpu``; the differential tests use them to feed both packages
identical input.
"""

from __future__ import annotations

import numpy as np
import torch

from torrent_tpu_torch.codec.metainfo import FileEntry, InfoDict
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
