from torrent_tpu_torch.utils.bytesio import (
    read_int,
    write_int,
    encode_binary_data,
    decode_binary_data,
    partition,
)
from torrent_tpu_torch.utils.timeout import TimeoutError_, with_timeout

__all__ = [
    "read_int",
    "write_int",
    "encode_binary_data",
    "decode_binary_data",
    "partition",
    "TimeoutError_",
    "with_timeout",
]
