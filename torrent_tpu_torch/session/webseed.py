"""BEP 19 webseeds (HTTP seeding) — beyond the reference's surface.

A web server holding the torrent's payload acts as an always-available
seed: pieces are fetched with HTTP Range requests and enter the torrent
through the same verify→persist→have path as wire pieces, so a corrupt
or lying webseed is caught by SHA1 exactly like a poisoning peer.

URL mapping (BEP 19): a ``url-list`` entry ending in ``/`` is a base —
append ``name`` (single-file) or ``name/…path`` (multi-file, each
component %-escaped); otherwise the URL is used as-is for single-file
torrents. Multi-file pieces that span file boundaries issue one ranged
GET per file segment.
"""

from __future__ import annotations

import http.client
import urllib.error
import urllib.parse
import urllib.request

from torrent_tpu_torch.codec.metainfo import InfoDict
from torrent_tpu_torch.storage.storage import Storage
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("session.webseed")

FETCH_TIMEOUT = 30.0


class WebSeedError(Exception):
    pass


def allowed_url(url: str) -> bool:
    """True for http/https webseed URLs. Both url-list fields (torrent
    files) and ws= params (magnets) are UNTRUSTED input, and fetch_range
    feeds the URL to urllib — which happily opens file:// and ftp://.
    Anything but plain web schemes is refused before a loop ever spawns
    (SSRF / local-file-read guard)."""
    try:
        return urllib.parse.urlsplit(url).scheme in ("http", "https")
    except ValueError:
        return False


def url_for(base: str, info: InfoDict, path: tuple[str, ...]) -> str:
    """Resolve the GET URL for one file of the torrent (BEP 19 §url-list)."""
    if base.endswith("/"):
        parts = [urllib.parse.quote(c) for c in path]
        return base + "/".join(parts)
    if info.is_multi_file:
        # non-slash base with multi-file still appends per convention
        parts = [urllib.parse.quote(c) for c in path]
        return base + "/" + "/".join(parts)
    return base


def fetch_range(url: str, start: int, length: int) -> bytes:
    """One ranged GET; raises WebSeedError on anything but full success."""
    req = urllib.request.Request(
        url,
        headers={
            "Range": f"bytes={start}-{start + length - 1}",
            "User-Agent": "torrent-tpu/0.1",
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=FETCH_TIMEOUT) as resp:
            if resp.status not in (200, 206):
                raise WebSeedError(f"{url}: HTTP {resp.status}")
            data = resp.read(length + 1)
    except (urllib.error.URLError, http.client.HTTPException, OSError, TimeoutError) as e:
        raise WebSeedError(f"{url}: {e}") from e
    if resp.status == 200:
        # server ignored the Range header; BEP 19 servers shouldn't, and
        # re-downloading the whole file per piece would be pathological
        raise WebSeedError(f"{url}: server ignored Range request")
    if len(data) != length:
        raise WebSeedError(f"{url}: short range read {len(data)}/{length}")
    return data


def fetch_piece(base: str, storage: Storage, info: InfoDict, index: int) -> bytes:
    """Assemble one piece from ranged GETs (per spanned file segment)."""
    from torrent_tpu_torch.storage.piece import piece_length

    plen = piece_length(info, index)
    out = bytearray()
    for path, foff, chunk in storage.segments(index * info.piece_length, plen):
        if path is None:
            out += bytes(chunk)  # BEP 47 pad span: zeros, nothing to fetch
            continue
        out += fetch_range(url_for(base, info, path), foff, chunk)
    return bytes(out)


def fetch_piece_bep17(url: str, info_hash: bytes, info: InfoDict, index: int) -> bytes:
    """BEP 17 httpseed GET: ``{url}?info_hash=<%-escaped>&piece=N``.

    The Hoffman protocol serves whole pieces keyed by infohash rather
    than file byte ranges (BEP 19); the response body IS the piece."""
    from torrent_tpu_torch.storage.piece import piece_length

    sep = "&" if urllib.parse.urlsplit(url).query else "?"
    get = (
        f"{url}{sep}info_hash={urllib.parse.quote_from_bytes(info_hash)}"
        f"&piece={index}"
    )
    plen = piece_length(info, index)
    req = urllib.request.Request(get, headers={"User-Agent": "torrent-tpu/0.1"})
    try:
        with urllib.request.urlopen(req, timeout=FETCH_TIMEOUT) as resp:
            if resp.status != 200:
                raise WebSeedError(f"{url}: HTTP {resp.status}")
            data = resp.read(plen + 1)
    except (urllib.error.URLError, http.client.HTTPException, OSError, TimeoutError) as e:
        raise WebSeedError(f"{url}: {e}") from e
    if len(data) != plen:
        raise WebSeedError(f"{url}: piece {index} wrong size {len(data)}/{plen}")
    return data
