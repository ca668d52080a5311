"""torrent_tpu_torch — the PyTorch/CUDA port of torrent_tpu.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. It carries the hash plane and the
BitTorrent session around it:

- ``codec`` (bencode, .torrent parsing), ``storage`` (piece→file
  mapping, batched reads through the native pread pool), ``ops`` (host
  padding, the plain PyTorch SHA-1 and the hand-written Hopper kernel);
- ``models.verifier.GPUVerifier`` and ``parallel.verify.verify_pieces``
  (``hasher="cpu"|"gpu"``): the full recheck, on a grid of the
  process's cards (``parallel.mesh``);
- ``tools.make_torrent``: authoring on the same plane;
- ``session`` (``Client``, ``Torrent``), ``net`` (peer wire, trackers)
  and ``server`` (the in-memory tracker): download, seed and resume a
  torrent, every finished piece verified on the hash plane;
- ``codec.magnet``, ``session.metadata``, ``net.dht`` (BEP 5/44/46
  with ``codec.signing`` and ``utils.ed25519``), ``net.utp`` and the
  network helpers (``net.lsd``, ``natpmp``, ``upnp``, ``socks``,
  ``ipfilter``, ``dnsprefs``): joining a swarm from a magnet;
- ``server.shard`` and ``net.indexer`` (the sharded tracker the DHT
  indexer feeds), ``tools.serve`` (its deployment), ``tools.stream``
  (HTTP streaming of verified bytes while a torrent downloads),
  ``tools.feed``, ``tools.netbench``, ``utils.metrics.MetricsServer``
  and ``scenario`` (the deterministic chaos plane): the tracker
  deployment and the serving tools;
- ``tools.ci`` (the PR gate, ``python -m torrent_tpu_torch.tools.ci``)
  and ``examples`` (the reference's three, on the card).

Entry points take ``device=None``, which means the GPU; without one
they raise. Pass ``device="cpu"`` for the plain PyTorch path. The
package imports neither jax nor torrent_tpu, and importing it loads
nothing beyond this module: the names below (the session's, storage,
the metainfo parsers and ``verify_pieces``) load their module on first
use.
"""

import importlib

# name -> the module it loads from on first use
_LAZY = {
    **dict.fromkeys(
        ("Client", "ClientConfig", "Torrent", "TorrentConfig", "TorrentState"),
        "torrent_tpu_torch.session",
    ),
    "FsStorage": "torrent_tpu_torch.storage.storage",
    "Storage": "torrent_tpu_torch.storage.storage",
    "parse_metainfo": "torrent_tpu_torch.codec.metainfo",
    "parse_metainfo_v2": "torrent_tpu_torch.codec.metainfo_v2",
    "verify_pieces": "torrent_tpu_torch.parallel.verify",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_LAZY[name]), name)
