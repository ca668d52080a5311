"""Reproducible swarm-throughput benchmarks on loopback.

The session layer's swarm rates (single-leech TCP, single-leech uTP,
N-leech fanout) come from here.
Everything runs real clients over real sockets against the in-memory
tracker — the only synthetic part is MemoryStorage, so the measurement
isolates protocol + scheduler + transport cost from disk.

Usage::

    python -m torrent_tpu_torch.tools.netbench [--mode single|fanout|utp|raw-utp]
        [--mb 256] [--piece-kb 256] [--leeches 8] [--hasher gpu|cpu]
        [--device DEV] [--json]

Every client verifies pieces with ``--hasher`` (default ``gpu``: the
SHA-1 kernel on ``--device``, CUDA when none is given; a host without
CUDA raises). ``--device cpu`` runs the plain PyTorch SHA-1 instead.

One line per run; --json emits machine-readable records. Run on an
otherwise-idle machine: every client shares the host's cores, so a
loaded box understates (never overstates) the numbers.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time


async def _swarm(
    total: int, piece: int, n_leech: int, utp: bool, hasher: str = "gpu", device=None
) -> dict:
    import numpy as np

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.storage.storage import MemoryStorage, Storage

    # the test harness's tracker and torrent helpers are intentionally
    # reused: the bench must measure the same stack the suite proves
    # (resolved relative to this file so `python -m
    # torrent_tpu_torch.tools.netbench` works from any working directory)
    sys.path.insert(
        0,
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests"),
    )
    from test_torch_session import build_torrent_bytes, fast_config, start_tracker

    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, size=total, dtype=np.uint8).tobytes()
    server, pump, announce_url = await start_tracker()
    meta = parse_metainfo(
        build_torrent_bytes(payload, piece, announce_url.encode(), name=b"bench.bin")
    )

    def mk() -> Client:
        c = Client(
            ClientConfig(
                host="127.0.0.1", enable_upnp=False, enable_utp=utp,
                hasher=hasher, device=device,
            )
        )
        c.config.torrent = fast_config(
            unchoke_slots=max(4, n_leech)
        )
        return c

    seed = mk()
    await seed.start()
    ss = Storage(MemoryStorage(), meta.info)
    for off in range(0, total, 1 << 20):
        ss.set(off, payload[off : off + (1 << 20)])
    await seed.add(meta, ss)
    leeches = []
    for _ in range(n_leech):
        c = mk()
        await c.start()
        leeches.append(c)
    t0 = time.perf_counter()
    torrents = [
        await c.add(meta, Storage(MemoryStorage(), meta.info)) for c in leeches
    ]
    await asyncio.gather(
        *(asyncio.wait_for(t.on_complete.wait(), 600) for t in torrents)
    )
    secs = time.perf_counter() - t0
    for c in leeches:
        await c.close()
    await seed.close()
    server.close()
    pump.cancel()
    return {
        "metric": (
            f"swarm_{'utp' if utp else 'tcp'}_{n_leech}leech_mib_s"
        ),
        "value": round(total * n_leech / 2**20 / secs, 1),
        "unit": "MiB/s aggregate" if n_leech > 1 else "MiB/s",
        "seconds": round(secs, 2),
        "total_mb": total >> 20,
        "piece_kb": piece >> 10,
        "leeches": n_leech,
    }


async def _raw_utp(total: int) -> dict:
    """Raw uTP stream throughput (no session layer): endpoint to
    endpoint over loopback, jumbo-MTU rung active."""
    import numpy as np

    from torrent_tpu_torch.net import utp

    loop = asyncio.get_running_loop()
    got = bytearray()
    done = asyncio.Event()

    async def consume(r, w):
        while True:
            chunk = await r.read(1 << 16)
            if not chunk:
                break
            got.extend(chunk)
            if len(got) >= total:
                break
        w.close()
        done.set()

    t_b, ep_b = await loop.create_datagram_endpoint(
        lambda: utp.UtpEndpoint(consume), local_addr=("127.0.0.1", 0)
    )
    t_a, ep_a = await loop.create_datagram_endpoint(
        lambda: utp.UtpEndpoint(None), local_addr=("127.0.0.1", 0)
    )
    payload = np.random.default_rng(1).integers(
        0, 256, total, dtype=np.uint8
    ).tobytes()
    r, w = await ep_a.dial("127.0.0.1", t_b.get_extra_info("sockname")[1])
    t0 = time.perf_counter()
    for off in range(0, total, 1 << 16):
        w.write(payload[off : off + (1 << 16)])
        await w.drain()
    w.close()
    await asyncio.wait_for(done.wait(), 300)
    secs = time.perf_counter() - t0
    assert bytes(got[:total]) == payload, "corrupt transfer"
    t_a.close()
    t_b.close()
    return {
        "metric": "raw_utp_loopback_mib_s",
        "value": round(total / 2**20 / secs, 1),
        "unit": "MiB/s",
        "seconds": round(secs, 2),
        "total_mb": total >> 20,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="netbench", description=__doc__)
    ap.add_argument(
        "--mode",
        choices=("single", "fanout", "utp", "raw-utp"),
        default="single",
    )
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--piece-kb", type=int, default=256)
    ap.add_argument("--leeches", type=int, default=8)
    ap.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    total = args.mb << 20
    piece = args.piece_kb << 10
    kw = {"hasher": args.hasher, "device": args.device}
    if args.mode == "single":
        rec = asyncio.run(_swarm(total, piece, 1, utp=False, **kw))
    elif args.mode == "fanout":
        rec = asyncio.run(_swarm(total, piece, args.leeches, utp=False, **kw))
    elif args.mode == "utp":
        rec = asyncio.run(_swarm(total, piece, 1, utp=True, **kw))
    else:
        rec = asyncio.run(_raw_utp(total))
    if args.json:
        print(json.dumps(rec))
    else:
        print(f"{rec['metric']}: {rec['value']} {rec['unit']} ({rec['seconds']}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
