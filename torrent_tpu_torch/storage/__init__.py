from torrent_tpu_torch.storage.piece import (
    BLOCK_SIZE,
    piece_length,
    validate_requested_block,
    validate_received_block,
)
from torrent_tpu_torch.storage.storage import (
    FsStorage,
    MemoryStorage,
    Storage,
    StorageError,
    StorageMethod,
)

__all__ = [
    "BLOCK_SIZE",
    "piece_length",
    "validate_requested_block",
    "validate_received_block",
    "Storage",
    "StorageError",
    "StorageMethod",
    "FsStorage",
    "MemoryStorage",
]
