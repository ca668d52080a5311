"""torrent_tpu_torch — the PyTorch/CUDA port of torrent_tpu.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. It carries the hash plane and the
BitTorrent session around it:

- ``codec`` (bencode, .torrent parsing), ``storage`` (piece→file
  mapping, batched reads through the native pread pool), ``ops`` (host
  padding, the plain PyTorch SHA-1 and the hand-written Hopper kernel);
- ``models.verifier.GPUVerifier`` and ``parallel.verify.verify_pieces``
  (``hasher="cpu"|"gpu"``): the full recheck;
- ``tools.make_torrent``: authoring on the same plane;
- ``session`` (``Client``, ``Torrent``), ``net`` (peer wire, trackers)
  and ``server`` (the in-memory tracker): download, seed and resume a
  torrent, every finished piece verified on the hash plane;
- ``codec.magnet``, ``session.metadata``, ``net.dht`` (BEP 5/44/46
  with ``codec.signing`` and ``utils.ed25519``), ``net.utp`` and the
  network helpers (``net.lsd``, ``natpmp``, ``upnp``, ``socks``,
  ``ipfilter``, ``dnsprefs``): joining a swarm from a magnet.

Entry points take ``device=None``, which means the GPU; without one
they raise. Pass ``device="cpu"`` for the plain PyTorch path. The
package imports neither jax nor torrent_tpu, and importing it loads
nothing beyond this module: the session's names below load their module
on first use.
"""

import importlib

_SESSION = ("Client", "ClientConfig", "Torrent", "TorrentConfig", "TorrentState")

__all__ = list(_SESSION)


def __getattr__(name):
    if name not in _SESSION:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module("torrent_tpu_torch.session"), name)
