"""torrent_tpu_torch — the PyTorch/CUDA port of torrent_tpu.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. This slice carries the v1 hash plane:

- ``codec`` (bencode, .torrent parsing), ``storage`` (piece→file
  mapping, batched reads through the native pread pool), ``ops`` (host
  padding, the plain PyTorch SHA-1 and the hand-written Hopper kernel);
- ``models.verifier.GPUVerifier`` and ``parallel.verify.verify_pieces``
  (``hasher="cpu"|"gpu"``): the full recheck;
- ``tools.make_torrent``: authoring on the same plane.

Entry points take ``device=None``, which means the GPU; without one
they raise. Pass ``device="cpu"`` for the plain PyTorch path. The
package imports neither jax nor torrent_tpu, and importing it loads
nothing beyond this docstring: import the modules you need.
"""
