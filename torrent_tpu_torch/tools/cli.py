"""torrent-tpu — the command line of the PyTorch/CUDA port.

One multiplexed entry point over the whole framework, the reference's
21 subcommands in the reference's order, with its flags, output text
and exit codes::

    torrent-tpu info     FILE.torrent
    torrent-tpu make     PATH TRACKER [-o OUT] [--comment C] [--piece-length N]
                         [--hasher gpu|cpu] [--device DEV] [--v2 | --hybrid]
    torrent-tpu verify   FILE.torrent DIR [--hasher gpu|cpu] [--device DEV] [--batch N]
    torrent-tpu download SOURCE DIR [--port P] [--hasher gpu|cpu] [--device DEV]
                         [--seed] [--no-resume] [--files I,J]
    torrent-tpu tracker  [--http-port P] [--udp-port P] [--interval S]
    torrent-tpu bridge   [--port P] [--hasher gpu|cpu] [--device DEV] [--batch-target N]
                         [--flush-deadline-ms MS] [--max-queue-mb MB] [--tenant-max-mb MB]
                         [--dev --fault-plan SPEC]
    torrent-tpu fabric-verify TORRENTS_DIR DATA_ROOT
                         [--init-method tcp://HOST:PORT --num-processes N --process-id I]
                         [--heartbeat-dir DIR] [--hasher gpu|cpu] [--device DEV]
                         [--obs-port P] [--fault-plan SPEC]
    torrent-tpu top      [--url URL] [--interval S] [--once] [--fleet]
    torrent-tpu doctor   [--device DEV] [--json] [--skip-swarm] [--v2] [--faults] ...

Every subcommand that hashes takes ``--hasher gpu|cpu`` (default
``gpu``: the CUDA kernels on ``--device``, the card when none is given;
a host without CUDA fails with an error and gives no verdict) and
``--device`` (``cpu`` runs the plain PyTorch versions of the kernels).
``--hasher cpu`` is hashlib. ``fabric-verify`` is
``tools/fabric_verify.py``'s command, with its flags. ``bench`` runs
``tools/bench_cli.py``'s rungs (its device rungs the port's
``tools/device_bench.py``), and ``lint`` keeps its flags but exits 2
with one line until ``analysis/`` is ported.

``download`` accepts either a ``.torrent`` file or a ``magnet:?...`` URI
(BEP 9 metadata fetch). Also runnable as ``python -m torrent_tpu_torch``.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys


def _parse_hostport(spec: str) -> "tuple[str, int] | None":
    """Parse ``HOST:PORT`` / ``[v6]:PORT``; None when the host is empty
    or the port is outside 1..65535 (the magnet/x.pe validity rules —
    emitting specs our own parser rejects helps nobody)."""
    host, _, port_s = spec.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        return None
    host = host.strip("[]")
    if not host or not 0 < port < 65536:
        return None
    return (host, port)


def _cmd_magnet(args) -> int:
    """Emit a magnet URI for a .torrent: btih and/or btmh topics (hybrids
    carry both), dn, the announce-list as tr= params, url-list webseeds
    as ws=, plus any --peer x.pe bootstrap addresses."""
    from torrent_tpu_torch.codec.magnet import Magnet
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2
    from torrent_tpu_torch.net.multitracker import parse_announce_list

    try:
        with open(args.torrent, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"error: cannot read {args.torrent}: {e}", file=sys.stderr)
        return 1
    m1 = parse_metainfo(data)
    m2 = parse_metainfo_v2(data)
    if m1 is None and m2 is None:
        print("error: not a valid .torrent file", file=sys.stderr)
        return 1
    trackers: list[str] = []
    if not args.no_trackers:
        raw = (m1.raw if m1 is not None else m2.raw) or {}
        tiers = parse_announce_list(raw)
        seen = set()
        for tier in tiers or []:
            for t in tier:
                if t not in seen:
                    seen.add(t)
                    trackers.append(t)
        announce = m1.announce if m1 is not None else (m2.announce or "")
        if announce and announce not in seen:
            trackers.insert(0, announce)
    peers = []
    for spec in args.peer:
        addr = _parse_hostport(spec)
        if addr is None:
            print(f"error: bad --peer {spec!r}", file=sys.stderr)
            return 1
        peers.append(addr)
    from torrent_tpu_torch.codec.metainfo import parse_url_list

    raw_top = m1.raw if m1 is not None else m2.raw
    magnet = Magnet(
        info_hash=m1.info_hash if m1 is not None else None,
        info_hash_v2=m2.info_hash_v2 if m2 is not None else None,
        display_name=(m1.info.name if m1 is not None else m2.info.name),
        trackers=tuple(trackers),
        peer_addrs=tuple(peers),
        # url-list lives at the top level for BOTH planes
        web_seeds=parse_url_list((raw_top or {}).get(b"url-list")),
    )
    print(magnet.to_uri())
    return 0


def _cmd_info(args) -> int:
    from torrent_tpu_torch.codec.metainfo import parse_metainfo

    with open(args.torrent, "rb") as f:
        data = f.read()

    def print_signers() -> None:
        from torrent_tpu_torch.codec import signing

        for name in signing.list_signers(data):
            if not signing.has_embedded_certificate(data, name):
                # BEP 35 allows out-of-band keys: unverifiable is not bad
                print(
                    f"signed by:    {name} (BEP 35, no embedded certificate"
                    f" — check with `sign --check {name} --pub KEY`)"
                )
                continue
            ok = signing.verify_torrent(data, name)
            print(
                f"signed by:    {name} (BEP 35, embedded key "
                f"{'verifies' if ok else 'DOES NOT verify'})"
            )

    m = parse_metainfo(data)
    if m is None:
        from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2

        v2 = parse_metainfo_v2(data)
        if v2 is not None:
            print(f"name:         {v2.info.name}  (BitTorrent v2)")
            print(f"info hash v2: {v2.info_hash_v2.hex()}")
            print(f"announce:     {v2.announce}")
            print(f"total size:   {v2.info.length:,} bytes")
            print(f"piece length: {v2.info.piece_length:,}")
            print(f"files:        {len(v2.info.files)}")
            for i, fe in enumerate(v2.info.files[:20]):
                print(f"  [{i}] {'/'.join(fe.path)}  ({fe.length:,} bytes)")
            if len(v2.info.files) > 20:
                print(f"  ... and {len(v2.info.files) - 20} more")
            from torrent_tpu_torch.codec.metainfo import (
                parse_collections,
                parse_similar,
                parse_update_url,
            )

            raw = getattr(v2, "raw", {}) or {}
            if similar := parse_similar(raw):
                print(f"similar:      {len(similar)} torrents (BEP 38)")
                for h in similar[:5]:
                    print(f"  - {h.hex()}")
            if cols := parse_collections(raw):
                print(f"collections:  {', '.join(cols)} (BEP 38)")
            if upd := parse_update_url(raw):
                print(f"update url:   {upd} (BEP 39)")
            print_signers()
            return 0
        print("error: not a valid .torrent file", file=sys.stderr)
        return 1
    info = m.info
    print(f"name:         {info.name}")
    print(f"info hash:    {m.info_hash.hex()}")
    print(f"announce:     {m.announce}")
    print(f"total size:   {info.length:,} bytes")
    print(f"piece length: {info.piece_length:,}")
    print(f"pieces:       {info.num_pieces:,}")
    if m.raw.get(b"info", {}).get(b"private") == 1:
        print("private:      yes (BEP 27)")
    if m.web_seeds:
        print(f"web seeds:    {len(m.web_seeds)} (BEP 19)")
        for u in m.web_seeds[:5]:
            print(f"  - {u}")
    if m.http_seeds:
        print(f"http seeds:   {len(m.http_seeds)} (BEP 17)")
        for u in m.http_seeds[:5]:
            print(f"  - {u}")
    if m.similar:
        print(f"similar:      {len(m.similar)} torrents (BEP 38)")
        for h in m.similar[:5]:
            print(f"  - {h.hex()}")
    if m.collections:
        print(f"collections:  {', '.join(m.collections)} (BEP 38)")
    if m.update_url:
        print(f"update url:   {m.update_url} (BEP 39)")
    print_signers()
    if info.files is not None:
        pads = sum(1 for fe in info.files if getattr(fe, "pad", False))
        print(
            f"files:        {len(info.files) - pads}"
            + (f" (+{pads} BEP 47 pad files)" if pads else "")
        )
        # indices are the handles `download --files I,J` takes
        shown = 0
        for i, fe in enumerate(info.files):
            if getattr(fe, "pad", False):
                continue
            print(f"  [{i}] {'/'.join(fe.path)}  ({fe.length:,} bytes)")
            shown += 1
            if shown >= 20:
                break
        if len(info.files) - pads > 20:
            print(f"  ... and {len(info.files) - pads - 20} more")
    return 0


def _cmd_feed(args) -> int:
    return asyncio.run(_feed_loop(args))


async def _feed_loop(args) -> int:
    """BEP 36 subscription: poll the feed, add new entries, seed what
    completes — until interrupted (or once with --once)."""
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.tools.feed import FeedPoller

    # gate spec parses before anything is constructed: a typo'd key is a
    # deterministic usage error, never a partially-started session
    require_signed = None
    if getattr(args, "require_signed", None):
        require_signed = _parse_require_signed(args.require_signed)
        if require_signed is None:
            return 2

    config = ClientConfig(port=args.port, hasher=args.hasher, device=args.device)
    if args.proxy:
        config.proxy = args.proxy
    try:
        client = Client(config)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    poller = None

    def save_seen() -> None:
        # atomic replace: a crash mid-write must not truncate the
        # subscription memory (a lost --seen file re-adds the whole feed
        # history on the next run) — same pattern as FsResumeStore
        if args.seen and poller is not None:
            tmp = args.seen + ".tmp"
            with open(tmp, "w") as f:
                f.write("\n".join(sorted(poller.seen)) + "\n")
            os.replace(tmp, args.seen)

    # everything after construction lives under the finally: an
    # unreadable --seen file or a failed start must still close the
    # client (and report cleanly, not as a traceback)
    try:
        await client.start()
        seen: set[str] = set()
        if args.seen and os.path.exists(args.seen):
            with open(args.seen) as f:
                seen = {line.strip() for line in f if line.strip()}
        poller = FeedPoller(
            client,
            args.url,
            args.dir,
            interval=args.interval,
            seen=seen,
            require_signed=require_signed,
        )
        added = await poller.poll_once()
        save_seen()
        for t in added:
            print(f"added: {t.info.name} ({t.metainfo.info_hash.hex()[:16]}...)")
        if not added:
            print("no new entries")
        if args.once:
            return 0
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # pragma: no cover - non-unix
                pass
        print(f"polling {args.url} every {args.interval:.0f}s (ctrl-c to stop)")
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=args.interval)
            except asyncio.TimeoutError:
                pass
            if stop.is_set():
                break
            try:
                added = await poller.poll_once()
                save_seen()
                for t in added:
                    print(f"added: {t.info.name}")
            except Exception as e:
                print(f"poll failed (will retry): {e}", file=sys.stderr)
        return 0
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await client.close()


def _parse_require_signed(spec: str) -> tuple[str, bytes] | None:
    """``SIGNER=PUBHEX`` → (signer, 32-byte key), or None + stderr."""
    signer, _, pub_hex = spec.partition("=")
    try:
        pub = bytes.fromhex(pub_hex)
    except ValueError:
        pub = b""
    if len(pub) != 32 or not signer:
        print(
            "error: --require-signed wants SIGNER=PUBHEX (64 hex chars)",
            file=sys.stderr,
        )
        return None
    return signer, pub


def _cmd_update(args) -> int:
    """BEP 39 from the command line: fetch the update-url and write the
    successor verbatim (no session needed — just the poll)."""
    from torrent_tpu_torch.codec.metainfo import Metainfo, parse_any_metainfo
    from torrent_tpu_torch.session.client import fetch_update

    with open(args.torrent, "rb") as f:
        data = f.read()
    parsed = parse_any_metainfo(data)
    if parsed is None:
        print("error: not a valid .torrent file", file=sys.stderr)
        return 1
    meta = parsed[0]
    if not isinstance(meta, Metainfo):
        # pure v2: the session wrapper carries update_url + the
        # truncated-SHA-256 identity fetch_update compares against
        from torrent_tpu_torch.session.v2 import v2_session_meta

        meta = v2_session_meta(meta)
    url = getattr(meta, "update_url", None)
    if not url:
        print("no update-url in this torrent (BEP 39 key absent)")
        return 1
    proxy = None
    if args.proxy:
        from torrent_tpu_torch.net.socks import ProxySpec

        try:
            proxy = ProxySpec.parse(args.proxy)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    # validate the gate spec BEFORE the fetch: a typo'd key must fail
    # deterministically, not lie dormant until the first real update
    req = getattr(args, "require_signed", None)
    parsed_req = None
    if req:
        parsed_req = _parse_require_signed(req)
        if parsed_req is None:
            return 2
    raw_out: list = []
    try:
        new_meta = asyncio.run(
            fetch_update(meta, proxy=proxy, raw_bytes_out=raw_out)
        )
    except Exception as e:
        print(f"error: update fetch failed: {e}", file=sys.stderr)
        return 1
    if new_meta is None:
        print(f"current: {url} serves the same torrent")
        return 0
    name = getattr(getattr(new_meta, "info", None), "name", "updated")
    if parsed_req is not None:
        # BEP 39 + BEP 35: a secure publishing pipeline. The SUCCESSOR
        # must carry a valid signature under the trusted key — an
        # update-url takeover cannot push an unsigned replacement.
        from torrent_tpu_torch.codec import signing

        try:
            signing.ensure_signed(raw_out[0], *parsed_req)
        except ValueError as e:
            print(f"error: refusing update from {url}: {e}", file=sys.stderr)
            return 2
    if args.check:
        print(f"update available: {name!r} at {url}")
        return 0
    base = (
        args.torrent[: -len(".torrent")]
        if args.torrent.endswith(".torrent")
        else args.torrent
    )
    out = args.output or (base + ".updated.torrent")
    with open(out, "wb") as f:
        f.write(raw_out[0])
    print(f"update available: wrote {out} ({len(raw_out[0]):,} bytes)")
    return 0


def _cmd_make(args) -> int:
    similar = _parse_similar_args(args)
    if similar is None:
        return 2
    if args.v2 or args.hybrid:
        if getattr(args, "pad_files", False):
            # hybrid authoring piece-aligns on its own; pure v2 has no
            # pad concept — a silently ignored flag would mislead
            print(
                "note: --pad-files applies to v1 authoring only (v2/hybrid "
                "are piece-aligned by construction); ignoring",
                file=sys.stderr,
            )
        return _make_v2(args)
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    def progress(n):
        print(f"\rhashed {n} pieces", end="", file=sys.stderr, flush=True)
    data = make_torrent(
        args.path,
        args.tracker,
        comment=args.comment,
        piece_length=args.piece_length,
        hasher=args.hasher,
        progress=progress,
        announce_list=[[t] for t in args.also_tracker] or None,
        private=args.private,
        web_seeds=args.web_seed or None,
        pad_files=getattr(args, "pad_files", False),
        similar=similar or None,
        collections=args.collection or None,
        update_url=args.update_url,
        device=args.device,
    )
    print("", file=sys.stderr)
    out = args.output or (args.path.rstrip("/").rsplit("/", 1)[-1] + ".torrent")
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out} ({len(data):,} bytes)")
    return 0


def _make_v2(args) -> int:
    """Author a pure-v2 (BEP 52) torrent: SHA-256 merkle file tree.

    File contents are passed as filesystem paths so hashing streams in
    bounded chunks — authoring a 60 GiB directory holds ~64 MiB resident.
    """
    import os

    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2
    from torrent_tpu_torch.models.v2 import build_v2

    path = args.path.rstrip("/")
    name = os.path.basename(path)
    files: list[tuple[tuple[str, ...], str]] = []
    if os.path.isfile(path):
        files.append(((name,), path))
    else:
        for dirpath, _, names in sorted(os.walk(path)):
            for fn in sorted(names):
                fp = os.path.join(dirpath, fn)
                rel = os.path.relpath(fp, path)
                files.append((tuple(rel.split(os.sep)), fp))
    plen = args.piece_length or (1 << 20)
    kwargs = dict(
        name=name, piece_length=plen, hasher=args.hasher,
        announce=args.tracker, private=args.private, comment=args.comment,
        announce_list=[[t] for t in args.also_tracker] or None,
        web_seeds=args.web_seed or None,
        device=args.device,
    )
    try:
        if args.hybrid:
            from torrent_tpu_torch.models.v2 import build_hybrid

            data, meta = build_hybrid(files, **kwargs)
            kind = "hybrid v1+v2"
        else:
            meta = build_v2(files, **kwargs)
            data = encode_metainfo_v2(
                meta.info, meta.piece_layers, announce=args.tracker,
                comment=args.comment,
                announce_list=[[t] for t in args.also_tracker] or None,
                web_seeds=args.web_seed or None,
            )
            kind = "v2"
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    similar = _parse_similar_args(args)
    if similar is None:
        return 2
    if similar or args.collection or args.update_url:
        # BEP 38/39 hints for v2/hybrid go in the ROOT dict (the BEPs'
        # mutable placement): the v2 info-dict builders don't carry
        # them, and top-level keys leave the infohash untouched
        from torrent_tpu_torch.codec.bencode import bdecode, bencode

        top = bdecode(data)
        if similar:
            top[b"similar"] = similar
        if args.collection:
            top[b"collections"] = [c.encode("utf-8") for c in args.collection]
        if args.update_url:
            top[b"update-url"] = args.update_url.encode("utf-8")
        # canonical bencode wants sorted dict keys; the appended keys land
        # at the end of the decoded order, so shallow-sort the TOP level
        # only (the info value's bytes — and thus the infohash — are
        # untouched; sort_keys=False keeps nested dicts verbatim)
        top = {k: top[k] for k in sorted(top)}
        data = bencode(top, sort_keys=False)
    out = args.output or (name + ".torrent")
    with open(out, "wb") as f:
        f.write(data)
    print(
        f"wrote {out} ({len(data):,} bytes, {kind}, "
        f"infohash {meta.info_hash_v2.hex()[:16]}...)"
    )
    return 0


def _parse_similar_args(args) -> list[bytes] | None:
    """``--similar`` hex strings → infohash bytes; None after printing a
    CLI-style error on malformed input (a traceback is not an error
    message)."""
    out = []
    for h in getattr(args, "similar", []):
        try:
            raw = bytes.fromhex(h)
        except ValueError:
            raw = b""
        if len(raw) not in (20, 32):
            print(
                f"error: --similar {h!r} is not a 40- or 64-digit hex infohash",
                file=sys.stderr,
            )
            return None
        out.append(raw)
    return out


def _verify_v2(v2, args) -> int:
    import os

    from torrent_tpu_torch.models.v2 import verify_v2

    root = os.path.join(args.dir, v2.info.name)
    # single-file convention matches v1 Storage: the payload lives at
    # <dir>/<name>, not <dir>/<name>/<name>
    single = len(v2.info.files) == 1 and v2.info.files[0].path == (v2.info.name,)

    def read_file(path):
        fp = root if single else os.path.join(root, *path)
        # parse_metainfo_v2 already rejects traversal components; this is
        # defense in depth for callers constructing MetainfoV2 directly
        if os.path.commonpath([os.path.abspath(fp), os.path.abspath(args.dir)]) != os.path.abspath(args.dir):
            return None
        if not os.path.isfile(fp):
            return None
        return fp  # path source: verify_v2 streams it

    res = verify_v2(read_file, v2, hasher=args.hasher, device=args.device)
    total = sum(len(ok) for ok in res.values())
    valid = sum(int(ok.sum()) for ok in res.values())
    for path, ok in res.items():
        if len(ok) and not ok.all():
            bad = [i for i in range(len(ok)) if not ok[i]]
            print(f"  {'/'.join(path)}: bad pieces {bad[:10]}")
    print(f"{valid}/{total} pieces valid (v2)")
    return 0 if valid == total else 2


def _cmd_verify(args) -> int:
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    with open(args.torrent, "rb") as f:
        data = f.read()
    # v2-aware parse first: hybrids verify via the per-file merkle path
    # (pad files never exist on disk, so the v1 view would fail the
    # pieces that cover them); pure-v1 torrents fall through unchanged.
    v2 = parse_metainfo_v2(data)
    if v2 is not None:
        return _verify_v2(v2, args)
    m = parse_metainfo(data)
    if m is None:
        print("error: not a valid .torrent file", file=sys.stderr)
        return 1

    def progress(done, total):
        print(f"\rverified {done}/{total} pieces", end="", file=sys.stderr, flush=True)

    kwargs = {"batch_size": args.batch, "device": args.device} if args.hasher == "gpu" else {}
    ok = verify_pieces(
        Storage(FsStorage(args.dir), m.info),
        m.info,
        hasher=args.hasher,
        progress_cb=progress,
        **kwargs,
    )
    print("", file=sys.stderr)
    valid = int(ok.sum())
    print(f"{valid}/{m.info.num_pieces} pieces valid")
    if valid < m.info.num_pieces:
        bad = [i for i in range(m.info.num_pieces) if not ok[i]]
        print(f"first invalid pieces: {bad[:10]}")
        return 2
    return 0


async def _seed_box(args) -> int:
    """Seed every .torrent in a directory against one data root — the
    long-running "seeding box" mode (no reference counterpart; its CLI
    roadmap stopped at a single-torrent proof of concept)."""
    import glob

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2
    from torrent_tpu_torch.session.client import Client, ClientConfig

    torrent_files = sorted(glob.glob(os.path.join(args.torrents, "*.torrent")))
    if not torrent_files:
        print(f"error: no .torrent files in {args.torrents!r}", file=sys.stderr)
        return 1
    config = ClientConfig(
        port=args.port,
        hasher=args.hasher,
        device=args.device,
        max_upload_bps=args.max_up * 1024,
        enable_lsd=args.lsd,
        enable_utp=args.utp,
    )
    if args.encryption:
        config.torrent.encryption = args.encryption
    if args.super_seed:
        config.torrent.super_seed = True
    client = Client(config)
    await client.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover - non-unix
            pass
    metrics_server = box_stream = None
    try:
        added = 0
        for path in torrent_files:
            if stop.is_set():
                # ctrl-c during a long recheck pass must not be absorbed
                # until the whole library has been hashed
                print("\ninterrupted during startup", file=sys.stderr)
                return 130
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                print(f"skipping {path}: {e}", file=sys.stderr)
                continue
            m = parse_metainfo(data) or parse_metainfo_v2(data)
            if m is None:
                print(f"skipping {path}: not a valid .torrent", file=sys.stderr)
                continue
            try:
                t = await client.add(m, args.data)
            except ValueError as e:  # duplicate infohash etc.
                print(f"skipping {path}: {e}", file=sys.stderr)
                continue
            have = t.bitfield.count()
            print(
                f"seeding {os.path.basename(path)}: {have}/{t.info.num_pieces} pieces",
                file=sys.stderr,
            )
            added += 1
        if not added:
            print("error: nothing to seed", file=sys.stderr)
            return 1
        if args.metrics_port is not None:
            from torrent_tpu_torch.utils.metrics import MetricsServer

            metrics_server = await MetricsServer(client).start(args.metrics_port)
            print(
                f"metrics http://127.0.0.1:{metrics_server.port}/metrics",
                file=sys.stderr,
            )
        if getattr(args, "stream_port", None) is not None:
            from torrent_tpu_torch.tools.stream import BoxStreamServer

            box_stream = await BoxStreamServer(client).start(args.stream_port)
            print(
                f"streaming http://127.0.0.1:{box_stream.port}/ "
                "(/{infohash}/{file})",
                file=sys.stderr,
            )
        print(
            f"seeding {added} torrent(s) on port {client.port} (ctrl-c to stop)",
            file=sys.stderr,
        )

        async def report():
            while not stop.is_set():
                s = client.status()
                print(
                    f"\rpeers {s['peers']} up {s['uploaded']:,} down {s['downloaded']:,}   ",
                    end="",
                    file=sys.stderr,
                    flush=True,
                )
                await asyncio.sleep(2)

        reporter = asyncio.ensure_future(report())
        await stop.wait()
        reporter.cancel()
        return 0
    finally:
        if metrics_server is not None:
            metrics_server.close()
        if box_stream is not None:
            box_stream.close()
        await client.close()


def _cmd_seed(args) -> int:
    return asyncio.run(_seed_box(args))


def _read_seed_file(path: str) -> bytes | None:
    """32-byte Ed25519 seed from a key file: 64 hex chars or raw bytes."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        print(f"error: cannot read key file {path!r}: {e}", file=sys.stderr)
        return None
    text = raw.strip()
    if len(text) == 64:
        try:
            seed = bytes.fromhex(text.decode("ascii"))
        except (ValueError, UnicodeDecodeError):
            seed = b""
        # fromhex ignores internal whitespace, so 64 chars can still
        # yield a short seed — diagnose HERE, naming the file
        if len(seed) == 32:
            return seed
    if len(raw) == 32:
        return raw
    print(f"error: {path!r} is not a 32-byte seed (raw or 64 hex chars)",
          file=sys.stderr)
    return None


def _cmd_sign(args) -> int:
    """BEP 35 torrent signing (Ed25519 — the BEP 46 key format).

    ``--keygen`` mints a key pair; ``--signer NAME --key FILE`` signs;
    ``--check NAME --pub HEX`` verifies against the trusted key (exit 0
    valid / 2 invalid). ``--check NAME`` alone can only test
    self-consistency against the attacker-controlled embedded
    certificate, so it ALWAYS exits 2 (SELF-CONSISTENT/UNTRUSTED or
    INVALID) — exit 0 is reachable only with ``--pub``.
    Signing is root-level only: the infohash never changes.
    """
    from torrent_tpu_torch.codec import signing

    if args.keygen:
        if not args.key:
            print("error: --keygen needs --key FILE to write", file=sys.stderr)
            return 2
        if os.path.exists(args.key):
            print(f"error: {args.key!r} exists; refusing to overwrite a key",
                  file=sys.stderr)
            return 2
        from torrent_tpu_torch.utils import ed25519

        seed = os.urandom(32)
        try:
            fd = os.open(args.key, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
            with os.fdopen(fd, "w") as f:
                f.write(seed.hex() + "\n")
        except OSError as e:
            print(f"error: cannot write key file {args.key!r}: {e}",
                  file=sys.stderr)
            return 1
        print(f"wrote {args.key} (keep it secret)")
        print(f"public key: {ed25519.publickey(seed).hex()}")
        return 0

    if not args.torrent:
        print("error: missing .torrent argument", file=sys.stderr)
        return 2
    try:
        with open(args.torrent, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"error: cannot read {args.torrent!r}: {e}", file=sys.stderr)
        return 1

    if args.check is not None:
        pub = None
        if args.pub:
            try:
                pub = bytes.fromhex(args.pub)
            except ValueError:
                print("error: --pub must be hex", file=sys.stderr)
                return 2
            if len(pub) != 32:
                # a wrong-length key is a usage error, not an invalid
                # signature — misreporting it as INVALID misdiagnoses
                # a perfectly good torrent as tampered
                print(
                    f"error: --pub must be 32 bytes (64 hex chars), got "
                    f"{len(pub)}",
                    file=sys.stderr,
                )
                return 2
        if pub is None:
            # no trusted key given: a certificate-less entry is
            # UNVERIFIABLE, not invalid — don't misdiagnose an
            # out-of-band-key torrent as tampered
            if args.check in signing.list_signers(
                data
            ) and not signing.has_embedded_certificate(data, args.check):
                print(
                    f"signature by {args.check!r}: UNVERIFIABLE "
                    f"(no embedded certificate — provide --pub KEY)"
                )
                return 2
        ok = signing.verify_torrent(data, args.check, pub)
        if pub is not None:
            print(f"signature by {args.check!r}: "
                  f"{'VALID' if ok else 'INVALID'} (trusted key)")
            return 0 if ok else 2
        # Embedded-certificate-only: self-consistency, NOT trust. A
        # tampered torrent whose cert+signature were replaced together
        # passes this check, so the bare --check form must never be a
        # scriptable exit-0 "valid": report loudly and
        # exit non-zero either way.
        if ok:
            print(
                f"signature by {args.check!r}: SELF-CONSISTENT "
                f"(embedded certificate — UNTRUSTED: anyone can re-sign "
                f"with a fresh key; pass --pub KEY for a trusted verdict)"
            )
        else:
            print(f"signature by {args.check!r}: INVALID (embedded certificate)")
        return 2

    if not args.key or not args.signer:
        print("error: signing needs --key FILE and --signer NAME",
              file=sys.stderr)
        return 2
    seed = _read_seed_file(args.key)
    if seed is None:
        return 1
    try:
        signed = signing.sign_torrent(data, seed, args.signer)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    out = args.output or args.torrent
    tmp = out + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(signed)
        os.replace(tmp, out)
    except OSError as e:
        print(f"error: cannot write {out!r}: {e}", file=sys.stderr)
        return 1
    names = ", ".join(signing.list_signers(signed))
    print(f"wrote {out} ({len(signed):,} bytes; signed by: {names})")
    return 0


async def _fabric_verify(args) -> int:
    """One process of a multi-process scheduler-fed library recheck:
    ``tools/fabric_verify.py``'s, on the namespace of its own flags (its
    module docstring lists how they differ from the reference's: a
    ``torch.distributed`` rendezvous in place of the ``jax.distributed``
    coordinator, and no virtual-CPU-device knob)."""
    from torrent_tpu_torch.tools.fabric_verify import fabric_verify

    return await fabric_verify(args)


def _cmd_fabric_verify(args) -> int:
    from torrent_tpu_torch.parallel.distributed import shutdown

    try:
        return asyncio.run(_fabric_verify(args))
    finally:
        shutdown()


def _cmd_lint(args) -> int:
    """Static concurrency/invariant analysis gate: the analysis plane
    (``torrent_tpu_torch/analysis``) is not ported yet, so the command
    keeps its flags and says so."""
    print(
        "error: lint needs torrent_tpu_torch.analysis, which is not ported yet",
        file=sys.stderr,
    )
    return 2


def _render_span_tree(tree: dict) -> str:
    """Human-readable span tree (torrent-tpu trace dump --id)."""
    lines = [
        f"trace {tree.get('trace_id')} — {tree.get('span_count', 0)} span(s)"
        + (
            f", {tree['dropped_spans']} dropped"
            if tree.get("dropped_spans")
            else ""
        )
    ]

    def walk(node: dict, depth: int) -> None:
        mark = "" if node.get("status") == "ok" else f" [{node.get('status')}]"
        attrs = node.get("attrs") or {}
        detail = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append(
            f"{'  ' * depth}{node.get('name')}  "
            f"+{node.get('start_ms', 0)}ms {node.get('duration_ms', 0)}ms"
            f"{mark}" + (f"  {detail}" if detail else "")
        )
        for child in node.get("children", ()):
            walk(child, depth + 1)

    for root in tree.get("spans", ()):
        walk(root, 1)
    return "\n".join(lines)


def _cmd_trace(args) -> int:
    """Fetch span trees / flight-recorder dumps (torrent_tpu_torch/obs).

    ``torrent-tpu trace dump`` reads ``GET /v1/trace`` from a running
    bridge (``--id`` narrows to one trace's span tree); ``--dir`` reads
    the newest black-box file a flight recorder wrote to disk
    (``TORRENT_TPU_FLIGHT_DIR``) instead — the post-mortem path when
    the process is already gone.
    """
    import json as _json

    if args.dir:
        import glob

        # newest by mtime, not filename: dump seqs restart per process,
        # so a restarted service's fresh dumps must not be shadowed by a
        # previous run's higher-numbered leftovers
        files = sorted(
            glob.glob(os.path.join(args.dir, "blackbox_*.json")),
            key=os.path.getmtime,
        )
        if not files:
            print(f"error: no blackbox_*.json files in {args.dir!r}", file=sys.stderr)
            return 1
        with open(files[-1]) as f:
            dump = _json.load(f)
        if args.json:
            print(_json.dumps(dump, sort_keys=True))
        else:
            print(
                f"{files[-1]}: dump #{dump.get('seq')} ({dump.get('reason')}), "
                f"{len(dump.get('recent_spans', []))} recent spans, "
                f"{len(dump.get('traces', {}))} trace(s)"
            )
            print(_json.dumps(dump.get("detail", {}), sort_keys=True))
        return 0

    import http.client
    import urllib.error
    import urllib.parse
    import urllib.request

    url = args.url.rstrip("/") + "/v1/trace"
    if args.id:
        url += "?id=" + urllib.parse.quote(args.id, safe="")
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            payload = _json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        # the bridge answered — a 404 means the trace id is unknown,
        # not that the bridge is unreachable
        print(f"error: {url} returned {e.code} {e.reason}", file=sys.stderr)
        return 1
    except (OSError, ValueError, http.client.HTTPException) as e:
        print(f"error: cannot reach {url}: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(_json.dumps(payload, sort_keys=True))
        return 0
    if args.id:
        print(_render_span_tree(payload))
        return 0
    counts = payload.get("dump_counts", {})
    dumps = payload.get("dumps", [])
    print(
        f"flight recorder: {len(dumps)} dump(s) held"
        + (
            " — " + ", ".join(f"{k}×{v}" for k, v in sorted(counts.items()))
            if counts
            else ""
        )
    )
    for d in dumps:
        print(
            f"  #{d.get('seq')} {d.get('reason')}: "
            f"{_json.dumps(d.get('detail', {}), sort_keys=True)}"
        )
    traces = payload.get("traces", [])
    print(f"traces held: {len(traces)}")
    for tid in traces[-10:]:
        print(f"  {tid}")
    return 0


def _cmd_doctor(args) -> int:
    # run_cli, not main: it prints the watchdog line before the first
    # import that could block. See tools/doctor.py module docstring.
    from torrent_tpu_torch.tools.doctor import run_cli as doctor_cli

    argv = ["--device-wait", str(args.device_wait)]
    if args.device is not None:
        argv += ["--device", args.device]
    if args.skip_swarm:
        argv.append("--skip-swarm")
    if getattr(args, "faults", False):
        argv.append("--faults")
    if getattr(args, "v2", False):
        argv.append("--v2")
    if getattr(args, "fabric", False):
        argv.append("--fabric")
    if getattr(args, "byzantine", False):
        argv.append("--byzantine")
    if getattr(args, "fleet", False):
        argv.append("--fleet")
    if getattr(args, "lint", False):
        argv.append("--lint")
    if getattr(args, "trace", False):
        argv.append("--trace")
    if getattr(args, "bottleneck", False):
        argv.append("--bottleneck")
    if getattr(args, "control", False):
        argv.append("--control")
    if getattr(args, "announce", False):
        argv.append("--announce")
    if getattr(args, "slo", False):
        argv.append("--slo")
    if getattr(args, "swarm", False):
        argv.append("--swarm")
    if getattr(args, "scenario", None):
        argv += ["--scenario", args.scenario]
    if getattr(args, "seed", False):
        argv.append("--seed")
    if getattr(args, "json", False):
        argv.append("--json")
    return doctor_cli(argv)


def _cmd_top(args) -> int:
    from torrent_tpu_torch.tools.top import main as top_main

    argv = ["--url", args.url, "--interval", str(args.interval)]
    if args.once:
        argv.append("--once")
    if getattr(args, "fleet", False):
        argv.append("--fleet")
    if getattr(args, "history", False):
        argv.append("--history")
    if getattr(args, "swarm", False):
        argv.append("--swarm")
    return top_main(argv)


def _cmd_replay(args) -> int:
    """Offline post-mortem replay of a dumped timeline (obs/timeline):
    the live attributor re-run over historical sample deltas, so "what
    was limiting at T-5m" is answerable after the process is gone."""
    import json as _json

    from torrent_tpu_torch.obs.attrib import format_rate
    from torrent_tpu_torch.obs.slo import parse_objectives
    from torrent_tpu_torch.obs.timeline import replay_report

    try:
        with open(args.file) as f:
            payload = _json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: cannot read timeline {args.file}: {e}", file=sys.stderr)
        return 2
    objectives = None
    if args.slo:
        try:
            objectives = parse_objectives(args.slo)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    rep = replay_report(payload, objectives=objectives)
    if args.json:
        print(_json.dumps(rep, sort_keys=True))
        return 0
    print(
        f"timeline replay: {rep['samples']} samples over {rep['span_s']:.1f}s"
        + (f" ({rep['drops']} dropped off the ring)" if rep["drops"] else "")
    )
    intervals = rep["intervals"][-max(1, args.intervals):]
    if not intervals:
        print("no sample intervals recorded")
        return 0
    print(f"{'age':>10s} {'limiting':10s} {'util':>6s} {'rate':>12s}  errors")
    for itv in intervals:
        sched = itv.get("sched") or {}
        errs = int(sched.get("shed", 0) or 0) + int(
            sched.get("failed_pieces", 0) or 0
        )
        print(
            f"T-{itv['age_s']:7.1f}s {itv.get('limiting') or '—':10s} "
            f"{(itv.get('utilization') or 0) * 100:5.0f}% "
            f"{format_rate(itv.get('pipeline_bps')):>12s}  "
            f"{errs if errs else '—'}"
        )
    overall = (rep.get("overall") or {}).get("bottleneck")
    if overall:
        print(
            f"overall: {overall['stage']} limited the span — "
            f"{overall.get('utilization', 0) * 100:.0f}% utilized, "
            f"{format_rate(overall.get('achieved_bps'))} achieved"
        )
    else:
        print("overall: pipeline idle across the span")
    from torrent_tpu_torch.tools.top import format_slo_line

    slo = rep.get("slo")
    for name, obj in sorted(((slo or {}).get("objectives") or {}).items()):
        print(format_slo_line(name, obj))
    return 0


def _cmd_serve(args) -> int:
    from torrent_tpu_torch.tools.serve import main as serve_main

    argv = [
        "--http-port", str(args.http_port),
        "--udp-port", str(args.udp_port),
        "--host", args.host,
        "--interval", str(args.interval),
        "--shards", str(args.shards),
        "--dht-port", str(args.dht_port),
        "--crawl-interval", str(args.crawl_interval),
        "--timeline-interval", str(args.timeline_interval),
    ]
    if args.slo is not None:
        argv.append("--slo")
        if args.slo is not True:
            argv.append(args.slo)
    return serve_main(argv)


def _cmd_bench(args) -> int:
    from torrent_tpu_torch.tools.bench_cli import main as bench_main

    argv: list[str] = []
    if args.rung:
        argv.append(args.rung)
    if args.smoke:
        argv.append("--smoke")
    argv += ["--mb", str(args.mb), "--piece-kb", str(args.piece_kb),
             "--batch-target", str(args.batch_target),
             "--hasher", args.hasher,
             "--clients", str(args.clients), "--swarms", str(args.swarms),
             "--per-client", str(args.per_client),
             "--shards", str(args.shards), "--numwant", str(args.numwant),
             "--leechers", str(args.leechers),
             "--tolerance", str(args.tolerance)]
    if args.device is not None:
        argv += ["--device", args.device]
    if args.timeout is not None:
        argv += ["--timeout", str(args.timeout)]
    if args.out:
        argv += ["--out", args.out]
    if args.record:
        argv += ["--record", args.record]
    if args.trajectory:
        argv += ["--trajectory", args.trajectory]
    if args.compare:
        argv.append("--compare")
    if args.report_only:
        argv.append("--report-only")
    if args.bank:
        argv.append("--bank")
    return bench_main(argv)


def _cmd_edit(args) -> int:
    """Rewrite a .torrent's top-level fields without touching the info
    dict: the infohash (and thus the swarm) is preserved byte-for-byte,
    which re-authoring cannot guarantee."""
    from torrent_tpu_torch.codec.bencode import bdecode_with_info_span, bencode

    try:
        with open(args.torrent, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"error: cannot read {args.torrent!r}: {e}", file=sys.stderr)
        return 1
    try:
        top, span = bdecode_with_info_span(data)
    except Exception as e:
        print(f"error: not a valid .torrent: {e}", file=sys.stderr)
        return 1
    if not isinstance(top, dict) or span is None:
        print("error: no info dict found", file=sys.stderr)
        return 1
    raw_info = data[span[0] : span[1]]

    if args.tracker:
        top[b"announce"] = args.tracker[0].encode()
        if len(args.tracker) > 1 or b"announce-list" in top:
            top[b"announce-list"] = [[t.encode()] for t in args.tracker]
    if args.clear_trackers:
        top.pop(b"announce-list", None)
        top[b"announce"] = b""  # schema requires the key; empty = trackerless
    if args.web_seed:
        top[b"url-list"] = [u.encode() for u in args.web_seed]
    if args.clear_web_seeds:
        top.pop(b"url-list", None)
        top.pop(b"httpseeds", None)
    if args.comment is not None:
        if args.comment:
            top[b"comment"] = args.comment.encode()
        else:
            top.pop(b"comment", None)

    # re-encode everything EXCEPT the info dict, which is spliced back
    # raw so the infohash cannot shift (bencode canonicalization of a
    # foreign encoder's info dict could change it)
    head = (
        b"d"
        + b"".join(
            bencode(k) + (raw_info if k == b"info" else bencode(top[k]))
            for k in sorted(set(top) | {b"info"})
        )
        + b"e"
    )
    out_path = args.output or args.torrent
    # atomic: a full disk or interrupt mid-write must never leave the
    # (possibly only) copy truncated
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(head)
    os.replace(tmp, out_path)
    import hashlib as _h

    print(f"wrote {out_path} (infohash {_h.sha1(raw_info).hexdigest()} unchanged)")
    return 0


async def _download(args) -> int:
    from torrent_tpu_torch.session.client import Client, ClientConfig

    bootstrap = []
    for spec in args.dht_bootstrap:
        addr = _parse_hostport(spec)
        if addr is None:
            print(f"error: bad --dht-bootstrap {spec!r}", file=sys.stderr)
            return 1
        bootstrap.append(addr)
    config = ClientConfig(
        port=args.port,
        hasher=args.hasher,
        device=args.device,
        resume=not args.no_resume,
        enable_dht=args.dht or bool(bootstrap) or bool(getattr(args, "dht_state", "")),
        dht_bootstrap=tuple(bootstrap),
        dht_state_path=getattr(args, "dht_state", "") or "",
        max_upload_bps=args.max_up * 1024,
        max_download_bps=args.max_down * 1024,
        enable_lsd=args.lsd,
        enable_utp=args.utp,
        proxy=getattr(args, "proxy", "") or "",
    )
    if args.sequential:
        config.torrent.sequential = True
    if getattr(args, "super_seed", False):
        config.torrent.super_seed = True
    if getattr(args, "encryption", None):
        config.torrent.encryption = args.encryption
    try:
        client = Client(config)
    except ValueError as e:
        # e.g. --proxy with --dht/--lsd: a clean CLI error, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 1
    await client.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover - non-unix
            pass
    stream_server = metrics_server = None
    try:
        if args.source.startswith("magnet:"):
            if getattr(args, "require_signed", None):
                # BEP 35 signatures live at the torrent's ROOT — swarm
                # metadata (BEP 9) carries only the info dict, so a
                # magnet can never satisfy the gate; refuse honestly
                print(
                    "error: --require-signed needs a .torrent file "
                    "(magnet metadata cannot carry BEP 35 signatures)",
                    file=sys.stderr,
                )
                return 2
            print("fetching metadata from swarm...", file=sys.stderr)
            torrent = await client.add_magnet(args.source, args.dir)
        else:
            with open(args.source, "rb") as f:
                data = f.read()
            req = getattr(args, "require_signed", None)
            if req:
                from torrent_tpu_torch.codec import signing

                parsed_req = _parse_require_signed(req)
                if parsed_req is None:
                    return 2
                try:
                    signing.ensure_signed(data, *parsed_req)
                except ValueError as e:
                    print(f"error: refusing {args.source!r}: {e}",
                          file=sys.stderr)
                    return 2
            try:
                torrent = await client.add_torrent_bytes(data, args.dir)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        if args.files:
            try:
                wanted = sorted({int(x) for x in args.files.split(",")})
                await torrent.select_files(wanted)
            except (ValueError, IndexError) as e:
                print(f"error: bad --files selection: {e}", file=sys.stderr)
                return 1
            print(f"downloading files {wanted} only", file=sys.stderr)
        print(f"listening on port {client.port}", file=sys.stderr)

        async def report():
            while not stop.is_set():
                s = torrent.status()
                print(
                    f"\r[{s['state']}] pieces {s['pieces']} peers {s['peers']} "
                    f"down {s['downloaded']:,} up {s['uploaded']:,}   ",
                    end="",
                    file=sys.stderr,
                    flush=True,
                )
                await asyncio.sleep(1)

        if getattr(args, "metrics_port", None) is not None:
            from torrent_tpu_torch.utils.metrics import MetricsServer

            metrics_server = await MetricsServer(client).start(args.metrics_port)
            print(
                f"metrics http://127.0.0.1:{metrics_server.port}/metrics",
                file=sys.stderr,
            )
        if getattr(args, "stream_port", None) is not None:
            from torrent_tpu_torch.tools.stream import StreamServer

            stream_server = await StreamServer(torrent).start(args.stream_port)
            from torrent_tpu_torch.tools.stream import content_files

            for i, name, _, _ in content_files(torrent):
                print(
                    f"streaming http://127.0.0.1:{stream_server.port}/{i}  ({name})",
                    file=sys.stderr,
                )
        reporter = asyncio.ensure_future(report())
        done_wait = asyncio.ensure_future(torrent.on_complete.wait())
        stop_wait = asyncio.ensure_future(stop.wait())
        await asyncio.wait({done_wait, stop_wait}, return_when=asyncio.FIRST_COMPLETED)
        if torrent.on_complete.is_set():
            print("\ndownload complete", file=sys.stderr)
            if (args.seed or stream_server is not None) and not stop.is_set():
                print(
                    "seeding/streaming (ctrl-c to stop)"
                    if stream_server is not None
                    else "seeding (ctrl-c to stop)",
                    file=sys.stderr,
                )
                await stop.wait()
        reporter.cancel()
        done_wait.cancel()
        stop_wait.cancel()
        return 0 if torrent.on_complete.is_set() else 130
    finally:
        # sidecar servers close on every exit path, not just success
        if stream_server is not None:
            stream_server.close()
        if metrics_server is not None:
            metrics_server.close()
        await client.close()


def _cmd_download(args) -> int:
    return asyncio.run(_download(args))


def _cmd_scrape(args) -> int:
    from torrent_tpu_torch.net.tracker import TrackerError, scrape

    hashes = []
    if args.torrent:
        from torrent_tpu_torch.codec.metainfo import parse_metainfo

        with open(args.torrent, "rb") as f:
            m = parse_metainfo(f.read())
        if m is None:
            print("error: not a valid .torrent file", file=sys.stderr)
            return 1
        hashes.append(m.info_hash)
        url = args.url or m.announce
    else:
        url = args.url
    for h in args.info_hash:
        try:
            raw = bytes.fromhex(h)
        except ValueError:
            print(f"error: bad info hash {h!r}", file=sys.stderr)
            return 1
        if len(raw) != 20:
            print(f"error: info hash must be 40 hex chars: {h!r}", file=sys.stderr)
            return 1
        hashes.append(raw)
    if not url or not hashes:
        print("error: need a tracker URL and at least one info hash", file=sys.stderr)
        return 1

    proxy = None
    if getattr(args, "proxy", ""):
        from torrent_tpu_torch.net.socks import ProxySpec

        try:
            proxy = ProxySpec.parse(args.proxy)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    async def go():
        try:
            entries = await scrape(url, hashes, proxy=proxy)
        except TrackerError as e:
            print(f"scrape failed: {e}", file=sys.stderr)
            return 1
        # key by the entry's own hash — HTTP trackers return files in
        # their own order and may omit hashes they don't know
        by_hash = {e.info_hash: e for e in entries}
        for h in hashes:
            e = by_hash.get(h)
            if e is None:
                print(f"{h.hex()}  (unknown to tracker)")
            else:
                print(
                    f"{h.hex()}  seeders={e.complete} leechers={e.incomplete} "
                    f"downloaded={e.downloaded}"
                )
        return 0

    return asyncio.run(go())


def _cmd_tracker(args) -> int:
    base = ["--http-port", str(args.http_port),
            "--udp-port", str(args.udp_port),
            "--interval", str(args.interval)]
    if getattr(args, "shards", 0) > 0:
        if args.state_file:
            # refuse rather than silently drop persistence: the sharded
            # plane has no snapshot file (persistent-tracker semantics
            # come from the DHT indexer seam), and an operator relying
            # on --state-file must learn that BEFORE losing state
            print(
                "error: --state-file is not supported with --shards "
                "(the sharded plane persists swarms via the DHT indexer, "
                "not a snapshot file)",
                file=sys.stderr,
            )
            return 2
        from torrent_tpu_torch.server.shard import main as shard_main

        return shard_main(base + ["--shards", str(args.shards)])
    from torrent_tpu_torch.server.in_memory import main as tracker_main

    return tracker_main(
        base + (["--state-file", args.state_file] if args.state_file else [])
    )


def _cmd_bridge(args) -> int:
    from torrent_tpu_torch.bridge.__main__ import main as bridge_main

    return bridge_main(
        [
            "--port", str(args.port),
            "--hasher", args.hasher,
        ]
        + (["--device", args.device] if args.device is not None else [])
        + [
            "--batch-target", str(args.batch_target),
            "--flush-deadline-ms", str(args.flush_deadline_ms),
            "--max-queue-mb", str(args.max_queue_mb),
            "--tenant-max-mb", str(args.tenant_max_mb),
        ]
        + (["--autopilot", "--autopilot-interval", str(args.autopilot_interval)]
           if args.autopilot else [])
        + ((["--slo"] + ([] if args.slo is True else [args.slo])
            + ["--timeline-interval", str(args.timeline_interval)])
           if args.slo is not None else [])
        + (["--fault-plan", args.fault_plan] if args.fault_plan else [])
        + (["--dev"] if args.dev else [])
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torrent-tpu", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("info", help="print .torrent metadata")
    sp.add_argument("torrent")
    sp.set_defaults(fn=_cmd_info)

    sp = sub.add_parser("magnet", help="emit a magnet URI for a .torrent")
    sp.add_argument("torrent")
    sp.add_argument(
        "--no-trackers", action="store_true", help="omit tr= parameters"
    )
    sp.add_argument(
        "--peer",
        action="append",
        default=[],
        metavar="HOST:PORT",
        help="x.pe bootstrap address (repeatable)",
    )
    sp.set_defaults(fn=_cmd_magnet)

    sp = sub.add_parser("make", help="author a .torrent (GPU-batched hashing)")
    sp.add_argument("path")
    sp.add_argument("tracker")
    sp.add_argument("-o", "--output")
    sp.add_argument("--comment")
    sp.add_argument("--piece-length", type=int)
    sp.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu",
                    help="gpu: the CUDA kernels on --device; cpu: hashlib "
                    "(default %(default)s)")
    sp.add_argument("--device", default=None,
                    help="torch device of --hasher gpu: cuda (the default; a "
                    "host without CUDA fails), cuda:N, or cpu for the plain "
                    "PyTorch versions of the kernels")
    sp.add_argument("--also-tracker", action="append", default=[],
                    help="extra tracker tier (BEP 12, repeatable)")
    sp.add_argument("--private", action="store_true", help="BEP 27 private flag")
    sp.add_argument(
        "--pad-files",
        action="store_true",
        help="BEP 47: piece-align every file with pad entries (multi-file)",
    )
    sp.add_argument("--web-seed", action="append", default=[],
                    help="BEP 19 url-list entry (repeatable)")
    sp.add_argument("--similar", action="append", default=[],
                    help="BEP 38: hex infohash of a torrent sharing files (repeatable)")
    sp.add_argument("--collection", action="append", default=[],
                    help="BEP 38: collection name grouping related torrents (repeatable)")
    sp.add_argument("--update-url",
                    help="BEP 39: URL where updated versions of this torrent appear")
    sp.add_argument("--v2", action="store_true",
                    help="author a BitTorrent v2 (BEP 52) torrent: SHA-256 merkle file tree")
    sp.add_argument("--hybrid", action="store_true",
                    help="author a hybrid v1+v2 torrent (BEP 52 upgrade path, BEP 47 pad files)")
    sp.set_defaults(fn=_cmd_make)

    sp = sub.add_parser(
        "sign", help="BEP 35: sign a .torrent / verify signatures / keygen"
    )
    sp.add_argument("torrent", nargs="?", help=".torrent file")
    sp.add_argument("--key", help="Ed25519 seed file (64 hex chars or raw 32B)")
    sp.add_argument("--signer", help="identity string for the signature entry")
    sp.add_argument("-o", "--output", help="write here instead of in place")
    sp.add_argument("--check", metavar="SIGNER",
                    help="verify SIGNER's signature instead of signing")
    sp.add_argument("--pub", help="trusted public key (hex) for --check")
    sp.add_argument("--keygen", action="store_true",
                    help="generate a new key pair into --key")
    sp.set_defaults(fn=_cmd_sign)

    sp = sub.add_parser("verify", help="recheck downloaded data against a .torrent")
    sp.add_argument("torrent")
    sp.add_argument("dir")
    sp.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu",
                    help="gpu: the CUDA kernels on --device; cpu: hashlib "
                    "(default %(default)s)")
    sp.add_argument("--device", default=None,
                    help="torch device of --hasher gpu: cuda (the default; a "
                    "host without CUDA fails), cuda:N, or cpu for the plain "
                    "PyTorch versions of the kernels")
    sp.add_argument("--batch", type=int, default=256)
    sp.set_defaults(fn=_cmd_verify)

    sp = sub.add_parser(
        "feed", help="BEP 36: subscribe to a torrent RSS/Atom feed"
    )
    sp.add_argument("url", help="feed URL (RSS 2.0 or Atom)")
    sp.add_argument("dir", help="download directory for added torrents")
    sp.add_argument("--interval", type=float, default=300,
                    help="poll interval in seconds (default 300)")
    sp.add_argument("--once", action="store_true",
                    help="poll once, print what was added, exit")
    sp.add_argument("--seen",
                    help="file remembering added entry URLs across runs "
                         "(one per line; created if missing)")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--proxy", help="SOCKS5 proxy URL")
    sp.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu",
                    help="gpu: the CUDA kernels on --device; cpu: hashlib "
                    "(default %(default)s)")
    sp.add_argument("--device", default=None,
                    help="torch device of --hasher gpu: cuda (the default; a "
                    "host without CUDA fails), cuda:N, or cpu for the plain "
                    "PyTorch versions of the kernels")
    sp.add_argument(
        "--require-signed",
        metavar="SIGNER=PUBHEX",
        help="only add feed entries whose .torrent carries a valid "
        "BEP 35 signature by SIGNER under this trusted Ed25519 key "
        "(magnet entries are refused under the gate)",
    )
    sp.set_defaults(fn=_cmd_feed)

    sp = sub.add_parser(
        "update", help="BEP 39: poll a torrent's update-url for a successor"
    )
    sp.add_argument("torrent")
    sp.add_argument("-o", "--output",
                    help="where to write the successor .torrent "
                         "(default: alongside the original as NAME.updated.torrent)")
    sp.add_argument("--check", action="store_true",
                    help="only report whether an update exists (write nothing)")
    sp.add_argument("--proxy", help="SOCKS5 proxy URL for the fetch")
    sp.add_argument(
        "--require-signed",
        metavar="SIGNER=PUBHEX",
        help="refuse the successor unless it carries a valid BEP 35 "
        "signature by SIGNER under this trusted Ed25519 key "
        "(an update-url takeover cannot push an unsigned replacement)",
    )
    sp.set_defaults(fn=_cmd_update)

    sp = sub.add_parser("download", help="download a .torrent file or magnet URI")
    sp.add_argument("source", help=".torrent path or magnet:?xt=urn:btih:... URI")
    sp.add_argument("dir")
    sp.add_argument(
        "--require-signed",
        metavar="SIGNER=PUBHEX",
        help="refuse the .torrent unless it carries a valid BEP 35 "
        "signature by SIGNER under this trusted Ed25519 key",
    )
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu",
                    help="gpu: the CUDA kernels on --device; cpu: hashlib "
                    "(default %(default)s)")
    sp.add_argument("--device", default=None,
                    help="torch device of --hasher gpu: cuda (the default; a "
                    "host without CUDA fails), cuda:N, or cpu for the plain "
                    "PyTorch versions of the kernels")
    sp.add_argument("--seed", action="store_true", help="keep seeding after completion")
    sp.add_argument(
        "--super-seed",
        action="store_true",
        help="BEP 16 super-seeding while complete (reveal pieces one-by-one)",
    )
    sp.add_argument("--no-resume", action="store_true", help="skip fastresume checkpoints")
    sp.add_argument(
        "--encryption",
        choices=("disabled", "enabled", "required"),
        default="enabled",
        help="MSE/PE protocol encryption policy (default: enabled)",
    )
    sp.add_argument(
        "--proxy",
        default="",
        help="SOCKS5 proxy for TCP peers + HTTP trackers "
        "(socks5://[user:pass@]host:port; UDP paths are disabled)",
    )
    sp.add_argument(
        "--stream-port",
        type=int,
        default=None,
        metavar="PORT",
        help="serve files over HTTP (Range-capable) WHILE downloading; "
        "the reader position steers piece priority (0 = ephemeral port)",
    )
    sp.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        metavar="PORT",
        help="Prometheus /metrics endpoint for session counters (0 = ephemeral)",
    )
    sp.add_argument(
        "--files",
        metavar="I,J,...",
        help="download only these file indices (see `info` for the list)",
    )
    sp.add_argument(
        "--max-up", type=int, default=0, metavar="KIB_S",
        help="upload cap in KiB/s (0 = unlimited)",
    )
    sp.add_argument(
        "--max-down", type=int, default=0, metavar="KIB_S",
        help="download cap in KiB/s (0 = unlimited)",
    )
    sp.add_argument("--dht", action="store_true", help="enable BEP 5 mainline DHT discovery")
    sp.add_argument(
        "--lsd", action="store_true", help="enable BEP 14 local service discovery"
    )
    sp.add_argument(
        "--sequential",
        action="store_true",
        help="download pieces in order (streaming) instead of rarest-first",
    )
    sp.add_argument(
        "--utp",
        action="store_true",
        help="enable BEP 29 uTP transport (prefer uTP dials, TCP fallback)",
    )
    sp.add_argument(
        "--dht-bootstrap",
        action="append",
        default=[],
        metavar="HOST:PORT",
        help="DHT bootstrap node (repeatable; implies --dht)",
    )
    sp.add_argument(
        "--dht-state",
        default="",
        metavar="FILE",
        help="persist the DHT routing table here for seedless fast "
        "restarts (implies --dht)",
    )
    sp.set_defaults(fn=_cmd_download)

    sp = sub.add_parser("scrape", help="scrape seeder/leecher stats from a tracker")
    sp.add_argument(
        "--proxy",
        default="",
        help="SOCKS5 proxy for the scrape (socks5://[user:pass@]host:port)",
    )
    sp.add_argument("--url", help="tracker announce URL (derived from --torrent if omitted)")
    sp.add_argument("--torrent", help=".torrent whose tracker + hash to scrape")
    sp.add_argument("info_hash", nargs="*", help="40-hex info hashes")
    sp.set_defaults(fn=_cmd_scrape)

    sp = sub.add_parser(
        "edit", help="rewrite trackers/webseeds/comment without changing the infohash"
    )
    sp.add_argument("torrent")
    sp.add_argument("-o", "--output", help="write here instead of in place")
    trackers = sp.add_mutually_exclusive_group()
    trackers.add_argument(
        "--tracker", action="append", default=[], help="replace announce (+tiers)"
    )
    trackers.add_argument("--clear-trackers", action="store_true")
    sp.add_argument(
        "--web-seed", action="append", default=[], help="replace BEP 19 url-list"
    )
    sp.add_argument("--clear-web-seeds", action="store_true")
    sp.add_argument("--comment", default=None, help="set ('' removes)")
    sp.set_defaults(fn=_cmd_edit)

    sp = sub.add_parser(
        "seed", help="seed every .torrent in a directory (seeding-box mode)"
    )
    sp.add_argument("torrents", help="directory of .torrent files")
    sp.add_argument("data", help="data root the torrents' content lives under")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu",
                    help="gpu: the CUDA kernels on --device; cpu: hashlib "
                    "(default %(default)s)")
    sp.add_argument("--device", default=None,
                    help="torch device of --hasher gpu: cuda (the default; a "
                    "host without CUDA fails), cuda:N, or cpu for the plain "
                    "PyTorch versions of the kernels")
    sp.add_argument("--max-up", type=int, default=0, metavar="KiB/s")
    sp.add_argument("--lsd", action="store_true", help="BEP 14 local discovery")
    sp.add_argument("--utp", action="store_true", help="BEP 29 uTP transport")
    sp.add_argument(
        "--encryption", choices=("disabled", "enabled", "required"), default=""
    )
    sp.add_argument("--super-seed", action="store_true", help="BEP 16 on every torrent")
    sp.add_argument("--metrics-port", type=int, default=None, metavar="PORT")
    sp.add_argument(
        "--stream-port",
        type=int,
        default=None,
        metavar="PORT",
        help="HTTP media server over every torrent: / lists torrents, "
        "/<infohash>/<file> streams (0 = ephemeral)",
    )
    sp.set_defaults(fn=_cmd_seed)

    sp = sub.add_parser(
        "fabric-verify",
        help="one process of a multi-process scheduler-fed library recheck",
    )
    from torrent_tpu_torch.tools.fabric_verify import add_arguments as fabric_arguments

    fabric_arguments(sp)
    sp.set_defaults(fn=_cmd_fabric_verify)

    sp = sub.add_parser(
        "lint",
        help="concurrency/invariant static analysis (lock order, "
        "blocking-in-async, device-under-lock, determinism, "
        "guarded-state, lifecycle)",
    )
    sp.add_argument("--root", default=None,
                    help="package dir to lint (default: installed torrent_tpu_torch)")
    sp.add_argument("--baseline", default=None,
                    help="baseline JSON (default: analysis_baseline.json "
                    "next to the package)")
    sp.add_argument("--passes", default=None, metavar="A,B",
                    help="comma-separated pass subset")
    sp.add_argument("--no-baseline", action="store_true",
                    help="raw findings; exit 1 if any")
    sp.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline, keeping justifications")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable findings report")
    sp.add_argument("--graph", action="store_true",
                    help="dump the static lock-acquisition graph and the "
                    "inferred attr->guard map")
    sp.add_argument("--sarif", default=None, metavar="PATH",
                    help="write findings as SARIF 2.1.0 for CI annotation")
    sp.set_defaults(fn=_cmd_lint)

    sp = sub.add_parser(
        "trace",
        help="ticket-lifecycle tracing: span trees and flight-recorder "
        "dumps from a running bridge (torrent_tpu_torch/obs)",
    )
    sp.add_argument("action", choices=("dump",),
                    help="dump: fetch GET /v1/trace (all dumps + trace ids, "
                    "or one span tree with --id)")
    sp.add_argument("--url", default="http://127.0.0.1:8421",
                    help="bridge base URL (default %(default)s)")
    sp.add_argument("--id", default=None, metavar="TRACE",
                    help="trace id (the X-Trace-Id a request carried/got "
                    "back) to fetch as an ordered span tree")
    sp.add_argument("--dir", default=None, metavar="DIR",
                    help="read the newest blackbox_*.json from DIR "
                    "(TORRENT_TPU_FLIGHT_DIR) instead of a bridge — the "
                    "post-mortem path")
    sp.add_argument("--json", action="store_true",
                    help="raw JSON instead of the rendered tree/summary")
    sp.set_defaults(fn=_cmd_trace)

    sp = sub.add_parser(
        "doctor", help="environment triage: deps, device, kernels, swarm smoke"
    )
    sp.add_argument("--device-wait", type=float, default=20.0)
    sp.add_argument("--device", default=None,
                    help="where the kernel checks and the device smokes run: "
                    "cuda (the default; a host without CUDA FAILs them), "
                    "cuda:N, or cpu for the plain PyTorch versions")
    sp.add_argument("--skip-swarm", action="store_true")
    sp.add_argument("--faults", action="store_true",
                    help="also run the fault-tolerance smoke: injected "
                    "fail-then-recover plan proving bisection isolation "
                    "and breaker trip/recovery")
    sp.add_argument("--v2", action="store_true",
                    help="also run the BEP 52 plane smoke: leaf + "
                    "merkle-pair digests vs hashlib through the scheduler's "
                    "sha256 lane on --device (the CUDA kernel on a card)")
    sp.add_argument("--bottleneck", action="store_true",
                    help="also run the pipeline-ledger smoke: a "
                    "scheduler-fed recheck attributed stage by stage; "
                    "with --faults the H2D stage is latency-throttled "
                    "and the attributor must name it")
    sp.add_argument("--control", action="store_true",
                    help="also run the scheduler-autopilot smoke: an "
                    "h2d-throttled scheduler must get its lane target "
                    "grown and its admission budget pulled toward the "
                    "limiting stage (controller-off moves nothing)")
    sp.add_argument("--fabric", action="store_true",
                    help="also run the verify-fabric self-test: two local "
                    "worker processes plan/execute/heartbeat, one dies "
                    "mid-run, the survivor adopts its shard")
    sp.add_argument("--byzantine", action="store_true",
                    help="also run the Byzantine-fabric self-test: two "
                    "workers at byzantine_f=1, one publishing forged "
                    "Merkle receipts; the audit plane must convict the "
                    "liar on both processes with identical bitfields "
                    "and exactly one fabric_distrust flight dump each")
    sp.add_argument("--fleet", action="store_true",
                    help="also run the fleet-observability smoke: two "
                    "workers, one h2d-throttled; the healthy peer's "
                    "/v1/fleet must name the throttled process (and its "
                    "h2d stage) as the fleet bottleneck")
    sp.add_argument("--announce", action="store_true",
                    help="also run the announce-plane smoke: concurrent "
                    "announces from multiple simulated swarms against "
                    "the sharded store; sampled replies well-formed, "
                    "shard counts reconcile")
    sp.add_argument("--slo", action="store_true",
                    help="also run the SLO-engine smoke: a FaultPlan "
                    "fail burst through a --slo bridge must burn the "
                    "availability budget, flip /v1/health ready→"
                    "degraded, fire exactly one slo_breach flight "
                    "dump, and recover")
    sp.add_argument("--swarm", action="store_true",
                    help="also run the swarm wire-plane smoke: a "
                    "throttled two-peer loopback download must be "
                    "attributed to the recv stage via /v1/pipeline, "
                    "/v1/swarm must report bounded per-peer telemetry, "
                    "and a driven snub storm must fire exactly one "
                    "flight dump")
    sp.add_argument("--lint", action="store_true",
                    help="also run the analysis-plane smoke (exits 2 until "
                    "the analysis plane is ported)")
    sp.add_argument("--scenario", metavar="NAMES",
                    help="also run bundled hostile-internet scenarios "
                    "(comma-separated names from scenario/library): each "
                    "runs twice against the real serve stack on a "
                    "virtual timeline; SLO verdict must pass and the "
                    "same-seed replay must be bit-identical")
    sp.add_argument("--seed", action="store_true",
                    help="also run the seeder-plane smoke: raw-wire "
                    "leechers against a real seeding client; every "
                    "piece must arrive bit-exact, /v1/swarm must carry "
                    "the serve sub-document, and the choke economics "
                    "must rotate the optimistic slot")
    sp.add_argument("--trace", action="store_true",
                    help="also run the observability smoke: traced "
                    "fault-injected run producing a span tree, latency "
                    "histograms, and flight-recorder dumps")
    sp.add_argument("--json", action="store_true",
                    help="emit a machine-readable JSON summary line")
    sp.set_defaults(fn=_cmd_doctor)

    sp = sub.add_parser(
        "top",
        help="live terminal view of the pipeline ledger from a running "
        "bridge (per-stage utilization + bottleneck verdict)",
    )
    sp.add_argument("--url", default="http://127.0.0.1:8421",
                    help="bridge base URL (default %(default)s)")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds (default %(default)s)")
    sp.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    sp.add_argument("--fleet", action="store_true",
                    help="render the swarm-wide fleet view (/v1/fleet: "
                    "straggler scoreboard + limiting process/stage) "
                    "instead of the local pipeline ledger")
    sp.add_argument("--history", action="store_true",
                    help="render the timeline view (/v1/timeline: "
                    "per-stage sparkline rows over the sample ring + "
                    "SLO burn/budget lines)")
    sp.add_argument("--swarm", action="store_true",
                    help="render the swarm wire-plane view (/v1/swarm: "
                    "per-peer scoreboard with state flags, pipeline "
                    "depth, block-RTT p99, snubs, overflow fold)")
    sp.set_defaults(fn=_cmd_top)

    sp = sub.add_parser(
        "replay",
        help="post-mortem replay of a dumped timeline (obs/timeline): "
        "the bottleneck attributor re-run over historical sample "
        "deltas — 'what was limiting at T-5m' after the process died",
    )
    sp.add_argument("file", help="a TORRENT_TPU_TIMELINE_DIR dump or a "
                    "saved GET /v1/timeline payload")
    sp.add_argument("--slo", default=None, metavar="SPEC",
                    help="also evaluate SLO objectives over the ring "
                    "(obs/slo spec, e.g. 'availability=0.999;integrity=on')")
    sp.add_argument("--intervals", type=int, default=12,
                    help="most-recent intervals to print (default %(default)s)")
    sp.add_argument("--json", action="store_true",
                    help="emit the full replay report as JSON")
    sp.set_defaults(fn=_cmd_replay)

    sp = sub.add_parser(
        "serve",
        help="long-running tracker deployment: sharded announce plane + "
        "DHT indexer crawl loop + /v1/health + /metrics in one command",
    )
    sp.add_argument("--http-port", type=int, default=8000)
    sp.add_argument("--udp-port", type=int, default=6969,
                    help="negative disables the UDP transport")
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--interval", type=int, default=600)
    sp.add_argument("--shards", type=int, default=8)
    sp.add_argument("--dht-port", type=int, default=6881,
                    help="DHT indexer UDP port (negative disables)")
    sp.add_argument("--crawl-interval", type=float, default=300.0,
                    help="seconds between BEP 51 crawl steps")
    sp.add_argument("--slo", nargs="?", const=True, default=None,
                    metavar="SPEC",
                    help="arm the timeline sampler + SLO engine (no SPEC "
                    "= the default availability+integrity contract)")
    sp.add_argument("--timeline-interval", type=float, default=2.0)
    sp.set_defaults(fn=_cmd_serve)

    sp = sub.add_parser(
        "bench",
        help="unified bench rungs (smoke/v2/fabric/flagship): banked-"
        "schema records with the pipeline-ledger stage breakdown "
        "embedded, plus the trajectory comparator",
    )
    sp.add_argument("rung", nargs="?",
                    choices=("smoke", "e2e", "v2", "fabric", "flagship",
                             "controller", "announce", "swarm", "seed"))
    sp.add_argument("--smoke", action="store_true",
                    help="alias for the smoke rung (the CI spelling)")
    sp.add_argument("--mb", type=int, default=8,
                    help="smoke rung payload MiB (default %(default)s)")
    sp.add_argument("--piece-kb", type=int, default=256,
                    help="smoke rung piece KiB (default %(default)s)")
    sp.add_argument("--batch-target", type=int, default=32,
                    help="smoke rung scheduler launch target")
    sp.add_argument("--hasher", default="gpu", choices=("gpu", "cpu"),
                    help="e2e rung hash plane (default %(default)s)")
    sp.add_argument("--device", default=None,
                    help="torch device of --hasher gpu (default: cuda)")
    sp.add_argument("--clients", type=int, default=8,
                    help="announce rung announcer threads")
    sp.add_argument("--swarms", type=int, default=32,
                    help="announce rung distinct info-hashes")
    sp.add_argument("--per-client", type=int, default=2000,
                    help="announce rung announces per client per rep")
    sp.add_argument("--shards", type=int, default=8,
                    help="announce rung store shard count")
    sp.add_argument("--numwant", type=int, default=30,
                    help="announce rung peers requested per announce")
    sp.add_argument("--leechers", type=int, default=64,
                    help="seed rung concurrent loopback leechers "
                    "(default %(default)s)")
    sp.add_argument("--timeout", type=float, default=None,
                    help="device-rung subprocess timeout seconds")
    sp.add_argument("--out", default=None, help="also write the record here")
    sp.add_argument("--record", default=None, metavar="FILE",
                    help="skip the run; compare/bank this record instead")
    sp.add_argument("--compare", action="store_true",
                    help="gate the record against the banked trajectory "
                    "(unarmed when no like-for-like record is banked)")
    sp.add_argument("--trajectory", default=None, metavar="FILE",
                    help="trajectory file (default BENCH_trajectory_cuda.json)")
    sp.add_argument("--tolerance", type=float, default=0.10,
                    help="allowed fractional regression (default %(default)s)")
    sp.add_argument("--report-only", action="store_true",
                    help="comparator reports but never fails the run")
    sp.add_argument("--bank", action="store_true",
                    help="append the record to the trajectory (self-banking)")
    sp.set_defaults(fn=_cmd_bench)

    sp = sub.add_parser("tracker", help="run the in-memory tracker server")
    sp.add_argument("--http-port", type=int, default=8080)
    # same default as the standalone torrent-tracker entrypoint; negative
    # disables UDP
    sp.add_argument("--udp-port", type=int, default=6969)
    sp.add_argument("--interval", type=int, default=600)
    sp.add_argument("--state-file", help="persist swarm state across restarts")
    sp.add_argument("--shards", type=int, default=0,
                    help="run the sharded announce plane with N shards "
                    "(batched announces, O(numwant) sampling, per-shard "
                    "TTL sweeps, /metrics route; 0 = legacy single-dict "
                    "tracker)")
    sp.set_defaults(fn=_cmd_tracker)

    sp = sub.add_parser("bridge", help="run the GPU hash-plane HTTP bridge")
    sp.add_argument("--port", type=int, default=8421)
    sp.add_argument("--hasher", choices=("gpu", "cpu"), default="gpu",
                    help="gpu: the CUDA kernels on --device; cpu: hashlib "
                    "(default %(default)s)")
    sp.add_argument("--device", default=None,
                    help="torch device of --hasher gpu: cuda (the default; a "
                    "host without CUDA fails), cuda:N, or cpu for the plain "
                    "PyTorch versions of the kernels")
    # continuous-batching scheduler knobs (torrent_tpu_torch/sched): launch
    # fill target, deadline for stranded small requests, and the
    # admission-control byte bounds that turn overload into 429s
    sp.add_argument("--batch-target", type=int, default=256,
                    help="pieces per device launch the scheduler fills to")
    sp.add_argument("--flush-deadline-ms", type=float, default=20.0,
                    help="max ms a queued piece waits before a partial flush")
    sp.add_argument("--max-queue-mb", type=int, default=256,
                    help="global queued-bytes bound (requests shed with 429 beyond)")
    sp.add_argument("--tenant-max-mb", type=int, default=128,
                    help="per-tenant queued-bytes bound")
    sp.add_argument("--autopilot", action="store_true",
                    help="arm the scheduler autopilot: adaptive lane "
                    "targets/deadlines, limiting-stage admission budgets, "
                    "hysteresis-guarded backend steering (GET /v1/control)")
    sp.add_argument("--autopilot-interval", type=float, default=1.0,
                    metavar="S",
                    help="seconds between controller decisions "
                    "(default %(default)s)")
    sp.add_argument("--slo", nargs="?", const=True, default=None,
                    metavar="SPEC",
                    help="arm the timeline sampler + SLO engine "
                    "(obs/slo spec; no SPEC = the default availability+"
                    "integrity contract). Serves /v1/timeline, /v1/slo "
                    "and the torrent_tpu_slo_*/timeline_* series; "
                    "/v1/health reflects breaches")
    sp.add_argument("--timeline-interval", type=float, default=1.0,
                    metavar="S",
                    help="seconds between timeline samples when --slo "
                    "is armed (default %(default)s)")
    sp.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="inject deterministic hash-plane faults "
                    "(sched/faults.py spec; requires --dev or TORRENT_TPU_DEV=1)")
    sp.add_argument("--dev", action="store_true",
                    help="dev/test mode: unlocks chaos knobs like --fault-plan")
    sp.set_defaults(fn=_cmd_bridge)

    return p


def main(argv: list[str] | None = None) -> int:
    from torrent_tpu_torch.utils.device import DeviceUnavailable

    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except DeviceUnavailable as e:
        # the default --hasher gpu on a host without CUDA: an error, never
        # a verdict from another hasher
        print(f"error: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:  # pragma: no cover - interactive
        return 130


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
