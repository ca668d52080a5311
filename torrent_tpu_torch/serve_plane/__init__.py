"""The crowd seeder plane's telemetry, ahead of the rest of the plane.

The reference's ``serve_plane`` package also holds the reactor pool,
the zero-copy egress engine and the upload choke economics; those come
with the session slice. What is here already is :mod:`.telemetry`, the
bounded serve-side registry and its pure
:func:`~torrent_tpu_torch.serve_plane.telemetry.build_serve_snapshot`
rollup behind the ``torrent_tpu_serve_*`` metrics, which the bridge's
``/metrics`` and ``/v1/swarm`` read.
"""

from torrent_tpu_torch.serve_plane.telemetry import (
    EGRESS_PATHS,
    ServeTelemetry,
    build_serve_snapshot,
    serve_telemetry,
)

__all__ = [
    "EGRESS_PATHS",
    "ServeTelemetry",
    "build_serve_snapshot",
    "serve_telemetry",
]
