from torrent_tpu_torch.parallel.verify import VerifyResult, verify_pieces, verify_pieces_sched
from torrent_tpu_torch.parallel.bulk import (
    LibraryResult,
    verify_library,
    verify_library_fabric,
    verify_library_sched,
)
from torrent_tpu_torch.parallel.distributed import (
    initialize as init_distributed,
    verify_library_distributed,
    verify_storage_distributed,
)

__all__ = [
    "verify_pieces",
    "verify_pieces_sched",
    "VerifyResult",
    "verify_library",
    "verify_library_fabric",
    "verify_library_sched",
    "LibraryResult",
    "init_distributed",
    "verify_library_distributed",
    "verify_storage_distributed",
]
