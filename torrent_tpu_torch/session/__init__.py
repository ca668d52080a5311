"""The BitTorrent session: ``Client`` (listener, torrent registry,
accept loop), ``Torrent`` (announce, peer loops, piece picking, ingest
verification on the hash plane, seeding, resume) and the BEP 52 session
geometry (``v2``).

The names below load their module on first use, so importing a sibling
such as ``session.v2`` does not pull in the whole session.
"""

import importlib

_EXPORTS = {
    "PeerConnection": "torrent_tpu_torch.session.peer",
    "Torrent": "torrent_tpu_torch.session.torrent",
    "TorrentConfig": "torrent_tpu_torch.session.torrent",
    "TorrentState": "torrent_tpu_torch.session.torrent",
    "Client": "torrent_tpu_torch.session.client",
    "ClientConfig": "torrent_tpu_torch.session.client",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
