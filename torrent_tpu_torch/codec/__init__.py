from torrent_tpu_torch.codec.bencode import (
    bencode,
    bdecode,
    bdecode_with_info_span,
    BencodeError,
)
from torrent_tpu_torch.codec.metainfo import (
    parse_any_metainfo,
    parse_metainfo,
    Metainfo,
    InfoDict,
    FileEntry,
)
from torrent_tpu_torch.codec.metainfo_v2 import (
    BLOCK,
    InfoDictV2,
    MetainfoV2,
    V2File,
    encode_metainfo_v2,
    parse_metainfo_v2,
    parse_v2_info_dict,
    valid_path_component,
)

__all__ = [
    "bencode",
    "bdecode",
    "bdecode_with_info_span",
    "BencodeError",
    "parse_any_metainfo",
    "parse_metainfo",
    "Metainfo",
    "InfoDict",
    "FileEntry",
    "BLOCK",
    "InfoDictV2",
    "MetainfoV2",
    "V2File",
    "encode_metainfo_v2",
    "parse_metainfo_v2",
    "parse_v2_info_dict",
    "valid_path_component",
]
