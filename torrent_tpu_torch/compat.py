"""State carried across from the reference package.

The system has no weights: what both packages must share is the torrent
(v1 info dicts, v2 metainfo and v2 session geometry), the staged
batches, the scheduler's, autopilot's and fabric's configuration, and
the obs plane's recorded history (a timeline dump). These helpers take
the reference's objects and numpy arrays by duck typing, so this
package never imports ``torrent_tpu``; the differential tests use them
to feed both packages identical input.
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


# the reference's v2 backend choices (its pallas kernel, its lax.scan
# program); the port's device alone decides its own, so the choice is
# checked and dropped
REFERENCE_SHA256_BACKENDS = (None, "auto", "pallas", "scan")


def scheduler_config_from_reference(cfg):
    """This package's ``sched.SchedulerConfig`` from the reference's,
    field by field (any object with its fields will do).

    The reference's ``sha256_backend`` must be one of its own values
    and is dropped: the port's scheduler takes the CUDA kernel on a GPU
    and the plain version on ``device="cpu"``. A ``plane_factory`` is
    refused with ``ValueError``: it is code bound to the reference's
    planes, not state."""
    import dataclasses

    from torrent_tpu_torch.sched.scheduler import SchedulerConfig

    if getattr(cfg, "plane_factory", None) is not None:
        raise ValueError(
            "plane_factory is code, not state: build the port's own "
            "(sched.faults.FaultPlan.plane_factory) instead"
        )
    backend = getattr(cfg, "sha256_backend", None)
    if backend not in REFERENCE_SHA256_BACKENDS:
        raise ValueError(f"unknown reference sha256 backend {backend!r}")
    return SchedulerConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(SchedulerConfig)
        if f.name != "plane_factory"
    })


def control_config_from_reference(cfg):
    """This package's ``sched.ControlConfig`` from the reference's,
    field by field (the autopilot's knobs are plain numbers and flags)."""
    import dataclasses

    from torrent_tpu_torch.sched.control import ControlConfig

    return ControlConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ControlConfig)}
    )


def fabric_config_from_reference(cfg):
    """This package's ``fabric.FabricConfig`` from the reference's,
    field by field: the fabric's knobs (tenant, weights, byte budgets,
    heartbeat and lapse intervals, Byzantine and fault hooks) are plain
    numbers, strings and flags, so both fabrics can run one config."""
    import dataclasses

    from torrent_tpu_torch.fabric.executor import FabricConfig

    return FabricConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(FabricConfig)}
    )


def timeline_from_reference(snap) -> dict:
    """This package's timeline snapshot from the reference's
    ``Timeline.snapshot()``, given as the dict or as its JSON dump (str
    or bytes, the body of a ``TORRENT_TPU_TIMELINE_DIR`` file).

    Both packages write one sample format (``obs/timeline.py`` is a
    copy), so the conversion is a JSON round trip: a deep copy that
    shares nothing with the caller's object. A dump of another format
    version raises ``ValueError`` rather than replay wrongly."""
    import json

    from torrent_tpu_torch.obs.timeline import TIMELINE_VERSION

    out = json.loads(snap if isinstance(snap, (str, bytes)) else json.dumps(snap))
    if not isinstance(out, dict) or out.get("v") != TIMELINE_VERSION:
        raise ValueError(
            f"not a version-{TIMELINE_VERSION} timeline snapshot: "
            f"v={out.get('v') if isinstance(out, dict) else None!r}"
        )
    return out


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``arr`` on ``device``; uint32 arrays travel as int32 bits.

    The caller may reuse ``arr`` as soon as this returns: the tensor
    never aliases it (a pageable host→device copy has read its source
    by then, and on the CPU the tensor is a clone)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device, copy=True)


def to_device_on_stream(arr: np.ndarray, stream) -> torch.Tensor:
    """A copy of ``arr`` on ``stream``'s GPU, allocated and copied on
    ``stream`` (``non_blocking``); uint32 arrays travel as int32 bits.

    From pinned memory the copy is asynchronous: ``arr`` must stay
    untouched until an event recorded on ``stream`` after this call has
    completed, and a consumer on another stream must wait on that event
    and ``record_stream`` the tensor. From pageable memory the driver
    stages the source before this returns."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    src = torch.from_numpy(arr)
    with torch.cuda.stream(stream):
        out = torch.empty(src.shape, dtype=src.dtype, device=stream.device)
        out.copy_(src, non_blocking=True)
    return out


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
