from torrent_tpu_torch.codec.bencode import (
    bencode,
    bdecode,
    bdecode_with_info_span,
    BencodeError,
)
from torrent_tpu_torch.codec.metainfo import (
    parse_metainfo,
    Metainfo,
    InfoDict,
    FileEntry,
)

__all__ = [
    "bencode",
    "bdecode",
    "bdecode_with_info_span",
    "BencodeError",
    "parse_metainfo",
    "Metainfo",
    "InfoDict",
    "FileEntry",
]
