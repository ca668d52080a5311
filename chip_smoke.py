#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU host

Phases (any failure exits non-zero, and no phase hides an error):

1. The card: ``nvidia-smi``'s name and power limit, ``torch``'s device
   name. Without CUDA, or outside a checkout, the script exits 1.
2. Build: the SHA-1 and SHA-256 kernels (``torrent_tpu_torch/csrc/
   sha1.cu`` and ``sha256.cu``, one nvcc for sm_90a each, started
   together) and the host pread pool, from the checkout's sources; prints
   ptxas' registers, spills and static shared memory, the SHA-1 kernel's
   dynamic shared memory, each kernel's SASS instruction count and the
   SHA-1 kernel's SASS opcode mix.
3. Each kernel against its plain PyTorch version on the card, bit for
   bit, and both against hashlib. SHA-1: the NIST vectors, a ragged
   batch (lengths 0 … 256 KiB-1), sentinel rows, a 33-row and a 4097-row
   batch (a partial last CTA of 32 pieces), one full 4096 x 256 KiB
   batch. SHA-256: the NIST vectors (the 1,000,000 x "a" vector against
   hashlib only: the plain version would take minutes over its 15,626
   blocks), ragged lengths 0 … 16 KiB with sentinel rows, u8 and
   int32-viewed input, one full 32768 x 16 KiB leaf launch, and a merkle
   pair level against ``hashlib.sha256(left + right)``. The merkle kernel:
   whole reductions of [B, L, 8] grids (one launch up to its 9-level cap,
   two above it, up to one 2**17-leaf tree) against the plain version and
   a hashlib pair-fold of every tree.
4. The v1 main path at a real size, on a seeded payload written to a
   temporary directory: a single-file torrent of 8192 pieces of 256 KiB
   (the last one short, 2 GiB in all) and a multi-file torrent of 6
   files (184 MB) whose files cross piece boundaries. Each is authored
   with ``make_torrent(hasher="gpu")`` and checked against hashlib's
   authoring, rechecked with ``verify_pieces(hasher="gpu",
   batch_size=4096)`` (all True), then one byte is flipped and a fresh
   storage must flag exactly that piece; the byte is flipped back after.
   The SHA-1 kernel's launch counter is reset before this phase and must
   have grown after it.
5. The v2 (BEP 52) main path on the same payloads at ``make --v2``'s
   default 1 MiB pieces (2048 pieces, the last one short, and the 6
   files): ``build_v2(hasher="gpu")`` must encode the same bytes as
   ``hasher="cpu"``, and ``build_hybrid(hasher="gpu")`` of the multi-file
   payload the same bytes as hashlib's (its v1 pieces go through the
   SHA-1 kernel). ``verify_v2`` and ``verify_pieces`` on the
   ``v2_session_info`` must be all True; after one flipped byte both must
   flag exactly that piece, as hashlib's rechecks do. Every launch
   counter is reset before this phase; the SHA-256 row and merkle kernels
   (and, through hybrid authoring, SHA-1) must have launched in it, the
   merkle kernel at most 58 times (one launch a reduction up to its cap).
6. Times, from CUDA events after warm-up (SHA-1 at 4096 x 256 KiB and
   4096 x 1 MiB, a batch sweep of SHA-1 at 1, 256, 4096 and 16384 rows
   x 256 KiB on rows filled on the card, spot-checked against hashlib,
   SHA-256 at the 32768-leaf authoring launch and the
   16384-leaf recheck launch, one 65536-pair merkle level, and each plain
   version), the merkle reduction at the v2 paths' shapes with its chain
   floor in cycles per level (``torrent_tpu_torch/tools/time_merkle.py``:
   one synced call, back to back, and the device's own time), and from
   the host clock (end-to-end rechecks, authoring and the hashlib
   baselines of the 2 GiB file), each printed beside the card's name and
   power limit.
7. The hash-plane scheduler (``torrent_tpu_torch/sched``) on the card,
   BASELINE config 5 (1000 torrents of ~1 GiB) cut in count only: a
   library of 2 single-file torrents of 1 GiB at 256 KiB pieces (8192
   pieces, 2 GiB), written from the seed and authored with
   ``make_torrent(hasher="gpu")`` (equal to hashlib's). One started ``HashPlaneScheduler(hasher="gpu")`` serves
   three tenants at once: ``verify_library_sched`` of the library as
   ``bulk`` (weight 0.25), ``verify_pieces_sched`` of phase 4's 184 MB
   multi-file torrent as ``cli``, and the first 512 MiB of phase 4's
   2 GiB file as 32768 leaves of 16 KiB through ``submit(...,
   algo="sha256")`` as ``stream`` (the bridge's v2 stream route shape);
   once with the default ``SchedulerConfig`` and once at batch_target
   4096 with a staging budget that affords 4096 rows of 256 KiB. Every
   bitfield and digest must equal hashlib's; the SHA-1 and SHA-256
   launch counters (reset just before each run) must have grown; there
   must be no CPU-fallback launch and no launch failure, every lane's
   breaker closed, every ingest pool drained after ``close()``, and the
   ledger's h2d, launch and digest stages carrying bytes and seconds.
   One flipped byte in library torrent 1 must flag exactly that piece
   (flipped back after), and a poisoned-prefix ``FaultPlan`` must fail
   exactly the poisoned ticket while the others get their digests from
   the CUDA plane. Printed beside the card's name and power limit: the
   library sweep's wall time through the scheduler and through hashlib,
   launches, mean fill, flush reasons, staged and copied launches, the
   ledger's stages with the attributor's bottleneck and the sum of its
   h2d + launch spans over the wall (host clock: spans of concurrent
   threads overlap and hold GIL waits, so it is no share of the card),
   and the staging slots' first-use pinned allocation time. A third run
   at the default config, under a ``torch.profiler`` capture
   (``TORRENT_TPU_PROFILE``, ``obs/profiler.py``), gives the card's busy
   time: the union of the trace's kernel and copy intervals, printed as
   a share of the unprofiled default run's wall (the same work without
   the capture's host cost), of the first to last device event, and of
   the profiled run's own wall.

8. The multi-process routes (``torrent_tpu_torch/parallel/distributed.py``,
   ``fabric/``) on the same payloads. Two ranks are fresh interpreters
   (``chip_smoke.py --dist-rank R ...``; never a fork of this CUDA
   process) in one gloo group at a free localhost port, both on
   ``cuda:0``: the machine has one card, and NCCL runs no two ranks on
   one device. A rank only loads the kernels phase 2 built (a stale
   library fails it), and every collective has a timeout; if a rank
   fails, the parent kills both. Each rank, with its launch counts at 0
   just before each sub-phase: ``verify_pieces(hasher="gpu",
   batch_size=4096)`` of phase 4's 2 GiB torrent, auto-routed (each rank
   hashes its 2048 rows of each global batch: one SHA-1 launch a batch),
   clean, with one byte flipped by rank 0, and ``verify_storage_distributed``
   of the flipped file for ``n_valid``; ``verify_pieces`` of phase 5's
   v2 info (round-robin strides), clean and flipped;
   ``verify_library_distributed`` of phase 7's library (one torrent a
   rank); ``verify_library_fabric`` of it over ``AllgatherHeartbeat``,
   each rank with a started ``HashPlaneScheduler(hasher="gpu")``. Every
   bitfield must equal hashlib's (phases 4, 5 and 7), both ranks must
   verify fabric pieces with no adoption, no CPU-fallback launch and no
   launch failure, and SHA-1 (v1, library, fabric) and SHA-256 rows and
   merkle (v2) must launch on every rank. The parent then joins an NCCL
   group at world size 1 (as far as NCCL goes on one card): the count
   ``all_reduce`` on the card, ``allgather_bitfield``, one
   ``AllgatherHeartbeat.exchange`` and a 2 GiB ``verify_storage_distributed``.
   Printed: each sub-phase's wall per rank beside the single-process wall
   of the same work (phases 4-5, and the library routes run alone here),
   labelled as two ranks sharing one H100, not multi-card scaling.
9. The localhost HTTP bridge (``torrent_tpu_torch/bridge``) on the card:
   ``BridgeServer(hasher="gpu", slo=True, timeline_interval_s=0.25)`` on
   127.0.0.1 in this process (its ``start()`` builds the sha1 256 KiB and
   sha256 16 KiB lanes' planes and pinned slots), driven by a separate
   client process, ``chip_smoke.py --bridge-client RUN ...``, one fresh
   interpreter a run, which imports no torch: it speaks HTTP over a
   socket, sends chunked bodies in odd chunk sizes, decodes with the
   port's device-free bencode codec and checks with hashlib. Run 1:
   ``/v1/stream/verify`` of phase 4's 2 GiB file (8192 frames of 256 KiB
   with the torrent's SHA-1s, piece 5000's byte flipped meanwhile); ``ok``
   must be hashlib's bitfield (valid 8191, failed 0). Run 2:
   ``/v1/stream/digests`` with ``X-Hash-Algo: sha256`` of the file's
   first 512 MiB as 32768 frames of 16 KiB (phase 7's ``stream`` shape),
   equal to hashlib's. Run 3: four ``X-Tenant`` clients at once, each
   posting 4 ``/v1/verify`` bodies of 64 pieces of 256 KiB (one expected
   digest wrong in each); the verdicts must be hashlib's, in fewer SHA-1
   launches than requests. Run 4: ``/v1/fabric/verify`` of phase 7's
   2 x 1 GiB library, polled on ``/v1/fabric/status`` until ``done``,
   with every piece valid. Then the operator routes: ``/v1/info``
   (backend gpu, devices, sha256_backend cuda), ``/metrics`` (scheduler,
   fabric, fleet, request, SLO and timeline families), ``/v1/pipeline``,
   ``/v1/fleet``, ``/v1/control``, ``/v1/health`` (200), ``/v1/slo``
   (attached, no breach), ``/v1/timeline`` (samples) and ``/v1/trace`` of
   run 1's ``X-Trace-Id``. The launch counters are 0 just before run 1
   and read after run 4; both kernels must have launched, with no
   CPU-fallback launch, no launch failure, every breaker closed and the
   staging pools drained after ``wait_closed()``. Printed beside the
   card's name and power limit: each run's wall and rate beside the
   direct call of the same work in this run (phase 4's warm
   ``verify_pieces``, a scheduler's direct ``submit`` of run 2's leaves,
   phase 7's ``verify_library_sched``) and hashlib; run 3's requests/s
   and the p50/p99 bucket bounds of ``torrent_tpu_bridge_request_seconds``;
   the scheduler's launches, mean fill and flush reasons; and the
   attributor's bottleneck from ``/v1/pipeline``.
10. The BitTorrent session (``torrent_tpu_torch/session``, ``net``,
   ``server``) on the card, at phase 7's widths and a depth cut to 512 MiB:
   the first 2048 pieces of 256 KiB of library torrent 1 (its first half,
   copied, with the first 2048 of its piece digests) announced to the
   port's in-memory tracker
   (``run_tracker``, HTTP on 127.0.0.1) and moved over loopback TCP
   between ``Client``s with the reference's default ``TorrentConfig`` but
   a 0.15 s choke round and a 1 s announce retry. A ``hasher="gpu"`` seed
   rechecks the file through ``GPUVerifier.verify_storage`` (all
   2048 pieces, SEEDING, SHA-1 launches); a ``hasher="gpu"`` leech
   downloads it into an empty directory, every finished piece through
   ``Torrent._verify_batch_device`` (counted by a wrapper this script
   installs: at least 2048 pieces) with no piece-sized input reaching the
   session module's ``hashlib``, then a fresh hashlib recheck of its files
   must be all True, and a batch of its first 256 pieces with one flipped
   byte must fail that piece alone; a ``hasher="cpu"`` leech downloads the
   same torrent for the hashlib wall. A restart on the leech's files
   (``resume=False``, a started ``HashPlaneScheduler(hasher="gpu")`` on
   the client) rechecks through ``verify_pieces_sched`` as the
   ``selfheal`` tenant and seeds without a download, with no CPU-fallback
   launch, no launch failure and the staging drained. Last, phase 5's
   pure-v2 torrent of the 6 files (1 MiB pieces) moves from a v2 seed to
   a v2 leech, both ``hasher="gpu"``: the files must be equal, the
   SHA-256 row and merkle kernels must launch, and the pieces through
   ``_verify_batch_device_v2`` and the tail pieces folded on the host are
   counted. Launch counts are 0 just before each sub-path and read just
   after it. Printed beside the card's name and power limit: the seed's
   recheck, both download walls and MiB/s, the ingest flushes, pieces a
   flush and SHA-1 launches, the restart recheck with its scheduler
   launches, and the v2 transfer's wall. Every client, the scheduler and
   the tracker are closed, and no task is left pending.
11. Joining a swarm from a magnet (``codec/magnet.py``,
   ``session/metadata.py``, ``net/dht.py``, ``net/utp.py``) on the card,
   at phase 10's widths (256 KiB pieces, 16 KiB blocks, its
   ``TorrentConfig`` with the DHT re-announced every 0.5 s) and a depth
   cut to 256 MiB (1024 pieces). One loopback bootstrap ``DHTNode``;
   every client has the DHT (bootstrapped on it) and uTP on. 11a: a fresh
   seeded 256 MiB file, authored with ``make_torrent(hasher="gpu")`` and
   no tracker, is rechecked by a ``hasher="gpu"`` seed (SEEDING, SHA-1
   launches) that announces it to the DHT; a ``hasher="gpu"`` leech calls
   ``add_magnet`` with a magnet holding only the info hash (retried on
   ``MetadataError`` while the announce propagates) and downloads: every
   peer writer it has must be a ``_UtpWriter`` (a TCP connection that won
   the dial race fails the phase), every piece goes through
   ``Torrent._verify_batch_device`` (at least 1024), no piece-sized input
   reaches the session's ``hashlib``, the wrappers run no plain
   (CPU-fallback) version, and a fresh hashlib recheck is all True; a
   ``hasher="cpu"`` leech joins the same magnet for the hashlib wall.
   11b: phase 5's six files (1 MiB pieces) go from a v2 seed to a v2
   leech, both ``hasher="gpu"``, through a btmh magnet with the seed in
   ``x.pe`` (the info dict SHA-256-checked, the piece layers
   merkle-proven): the files must be equal and the SHA-256 row and merkle
   kernels must launch, with no CPU-fallback launch. 11c: the seed's
   client ``publish_mutable``s the 11a info hash (BEP 46) and the v2
   leech's ``resolve_mutable`` of the key's btpk magnet must return it.
   Printed beside the card's name and power limit: the authoring and the
   seed's recheck, the time from the first ``add_magnet`` to the first
   metadata byte and to the registration, both 11a download walls and
   MiB/s, the ingest flushes, pieces a flush and SHA-1 launches, the 11b
   wall with its launches, and phase 11's wall. Every client, DHT node
   and endpoint is closed, and no task is left pending.
12. The tracker deployment and the serving tools (``server/shard.py``,
   ``net/indexer.py``, ``utils/metrics.MetricsServer``, ``tools/serve.py``,
   ``tools/stream.py``, ``tools/netbench.py``, ``scenario/``) on the card,
   in this process and event loop, on loopback. 12a: ``start_service``
   (8 shards, HTTP and UDP, its ``DHTNode`` with the indexer, the
   timeline and SLO tier) is the persistent tracker; a fresh seeded
   256 MiB file (phase 11's widths and depth) is seeded by a DHT-only
   ``hasher="gpu"`` seed with no announce list, whose DHT announce the
   indexer harvests into the sharded store; a ``hasher="gpu"`` leech
   with no DHT, a ``MetricsServer`` and a ``BoxStreamServer`` joins a
   magnet holding only the info hash and the tracker's URL (metadata
   over BEP 9), and while it downloads one client streams a Range from
   128 MiB to the end, then the whole file from 0. Every streamed byte
   must equal the payload, every read of the leech's storage must lie
   in pieces that already passed ``Torrent._verify_batch_device`` (all
   1024 do, through the SHA-1 kernel, with no CPU-fallback launch and
   no piece-sized input to the session's ``hashlib``), the scheduler's
   recheck of the leech's storage (``verify_library_sched`` through a
   ``HashPlaneScheduler(hasher="gpu")``) must be all True with SHA-1
   launches, the tracker's ``/metrics`` must count announces and
   indexed peers and carry the announce-latency histogram, its
   ``/v1/health`` must answer 200 and ready, and the leech's
   ``/metrics`` must show every piece had and its ``/v1/swarm`` parse.
   12b: phase 5's pure-v2 torrent (1 MiB pieces) announced to the same
   tracker goes from a ``hasher="gpu"`` seed to a ``hasher="gpu"``
   leech, each file streamed while it downloads: the bytes must equal
   the files, and the SHA-256 row and merkle kernels must launch with no
   CPU-fallback launch. 12c: ``tools/netbench._swarm`` in fanout mode,
   4 leeches of a 64 MiB payload at 256 KiB pieces with the default
   ``"gpu"`` hasher: every leech completes with its 256 pieces through
   ``_verify_batch_device``, and the SHA-1 kernel launches once a flush
   at least (a flush may carry several pieces: fewer than 4 x 256
   launches), with no CPU-fallback launch. 12d: every scenario of
   ``scenario.library.SCENARIOS`` runs twice from its seed: the two
   runs' canonical bytes must be equal and every verdict pass (the
   scenario plane is a simulation on a virtual clock; it runs no kernel
   by design). Launch counts are 0 just before
   each sub-path and read just after it. Printed beside the card's name
   and power limit: the authoring and the seed's recheck, the time for
   the indexer to feed the store, to the first metadata byte and to the
   registration, the download wall and MiB/s with its flushes and
   launches, each stream response's head, first byte and wall, the
   recheck's wall and launches, the v2 stream's wall and launches, each
   netbench leech's MiB/s, each scenario's wall and phase 12's wall.
   Every client, server and the deployment are closed, and no task is
   left pending.
13. The command line (``tools/cli.py``, ``tools/doctor.py``, ``python -m
   torrent_tpu_torch``) on the card at phase 4's widths. 13a, each
   command once through ``tools.cli.main`` in this process, the launch
   counts 0 just before it: ``make`` of phase 4's 2 GiB file at 256 KiB
   pieces with the default ``--hasher gpu`` (its info dict equal to
   ``--hasher cpu``'s), ``make --v2`` and ``--hybrid`` of the six files
   (bytes equal to ``--hasher cpu``'s), ``info`` of each, ``verify
   --batch 4096`` of the 2 GiB torrent (``8192/8192 pieces valid``, exit
   0; with piece 5000's byte flipped, exit 2 naming exactly that piece;
   flipped back after), ``verify`` of the v2 and hybrid torrents (all
   valid). Every device command must have grown its kernels' counts
   (SHA-1; SHA-256 rows and merkle; all three for ``--hybrid``). ``python
   -m torrent_tpu_torch verify`` and ``make --v2`` in a fresh interpreter
   must print what ``main`` printed, with the same exit code and bytes.
   The 2 GiB ``verify`` is timed at ``--batch 256`` (the reference's
   default) and 4096, each beside a ``--hasher cpu`` run. 13b: ``doctor
   --json --v2 --faults --lint --skip-swarm`` in a fresh interpreter on
   the card: ``ok``, 0 FAIL, the sha1 and sha256 plane details naming the
   ``cuda`` route (their launch counters grew), the scheduler and v2
   lanes ``cuda`` with no CPU-fallback launch, the analysis plane PASS
   (the eight lint passes against the port's baseline); each check's line and the
   wall are printed. 13c, each command its own process: ``tracker`` on a
   free port, ``seed`` of a fresh seeded 64 MiB file at 256 KiB pieces
   (phase 12c's depth), authored by ``make`` on the card, ``download``
   of it with ``--hasher gpu`` and then ``--hasher cpu`` (both equal to
   the file; the walls include each interpreter's start), ``bridge
   --hasher gpu`` on a free port answering one ``/v1/digests`` request of
   16 pieces of 256 KiB with hashlib's digests, and ``top --once --url``
   against it, whose frame must show the scheduler's launches. Every
   server is stopped with SIGINT and must exit 0 or 130 with no
   traceback. Printed beside the card's name and power limit: each
   command's wall, the 2 GiB recheck's pieces/s, the doctor's checks and
   wall, both download walls and their ratio, and phase 13's wall.
14. The bench and the kernel tuners on the card, through ``tools.cli.main``
   in this process. 14a: ``bench e2e --hasher gpu --mb 1024`` three times
   (a fresh 1 GiB file of 256 KiB pieces each, rechecked through the
   scheduler's zero-copy ingest; each must grow the SHA-1 counter and
   leave no slab outstanding) and ``--hasher cpu`` once; each pieces/s,
   the gpu runs' spread and hashlib's rate are printed. 14b: ``bench
   flagship`` (8192 x 256 KiB) and ``bench v2`` through the port's device
   bench (``tools/device_bench.py``) in a child process: non-null values,
   ``platform`` ``cuda``, median-of-3 fields on the host clock and on CUDA
   events, and the child's own launch counts (SHA-1; SHA-256 rows and
   merkle). 14c: the median e2e record compared (unarmed), banked and
   compared again (armed, passing) in a trajectory under the smoke's
   temporary directory; the repo's ``BENCH_trajectory.json`` must keep its
   hash. 14d: ``tools/tune_sha1`` (grid ``4.3.2,2.2.2``, 4096 x 256 KiB)
   and ``tools/tune_sha256`` (grid ``32,64``, 32768 x 16 KiB): every
   variant is built from the checkout's source and its digests of the
   whole batch equal hashlib's before it is timed; the production
   counters and libraries must not change. Each variant's ms, share of
   the operations bound, registers and build seconds are printed, and the
   kernels record carries them under ``variants``.
15. The analysis plane (``torrent_tpu_torch/analysis``). 15a: ``python
   -m torrent_tpu_torch lint`` in a fresh interpreter exits 0 with "0
   new, 0 stale", and ``python -m torrent_tpu_torch.analysis --json
   --no-baseline`` lists exactly the baseline's keys (13b's doctor runs
   ``--lint`` too); each wall is printed. 15b: the sanitized device path.
   The parent sweeps phase 7's library torrent 1 (1 GiB, 4096 x 256 KiB,
   SHA-1 zero-copy ingest) as ``bulk`` beside the 32768 16 KiB leaves of
   phase 7's ``stream`` (SHA-256) on a default scheduler, once warm and
   once timed; then a child (``chip_smoke.py --tsan-child``) with
   ``TORRENT_TPU_TSAN=1`` in its environment before any import starts a
   bridge on the card (its scheduler has the default config), sweeps the
   same work while a client thread posts phase 9's 16 buffered
   ``/v1/verify`` requests, sweeps it again alone (timed), and reads
   ``GET /metrics`` and a flight dump. Checked: every verdict and digest
   equals hashlib's, both kernels' counters grew (reset just before the
   child's main path), no CPU-fallback launch or launch failure, staging
   drained, the locks ``named_lock`` handed out are ``SanitizedLock``s
   with both planes' ``_device_lock`` and the lanes' ``build_lock``
   acquired, the cells ``sched.staging.free_list``, ``sched.slab.refs``
   and ``sched.breaker.state`` made, zero lock-order cycles and zero
   lockset races, ``/metrics`` carrying the lock series with ``cycles
   0``, and a dump carrying ``tsan``. Printed: both sweeps' walls and
   their ratio, the device locks' acquisitions and contention, loop
   stalls and long holds (printed, never failed), and the child's wall.
16. The PR gate (``torrent_tpu_torch/tools/ci.py``) on the card, its
   stages called as the gate calls them. Stage 1: ``python -m
   torrent_tpu_torch.analysis --sarif`` exits 0, the SARIF artifact passes
   the gate's structural check and the run stays inside ``LINT_BUDGET_S``.
   Stage 4 twice: the 8 MiB smoke rung banks a record into a trajectory
   under the smoke's temporary directory
   (``TORRENT_TPU_BENCH_TRAJECTORY``), then the gate's ``--compare
   --tolerance 0.35`` run against it must exit 0 with the comparator
   armed. Stages 5-12: the eight doctor smokes in one fresh process on
   the card with the eight flags (``--skip-swarm --device-wait 5
   --json``; the gate runs a process a stage, which here would take about
   three minutes): its JSON ``exit_code`` must equal its exit code and
   each stage's named check must PASS (the smokes hash with hashlib by
   design, as the reference's). Then the examples in this process: ``batched_recheck``
   with its default ``gpu`` must print hashlib's lines (the one flipped
   piece, 14, alone false) with the SHA-1 counter grown, and
   ``v2_author_verify`` hashlib's lines with the SHA-256 row and merkle
   counters grown (reset just before each). Printed beside the card's
   name and power limit: each stage's rc and wall, the examples' walls
   and launches, and phase 16's wall. The gate's pytest stages (2-3)
   are not run here: they are ``python -m torrent_tpu_torch.tools.ci``'s.
17. The v1 hash plane on a grid of devices (``parallel/mesh.py``): every
   card when there are two or more, else ``cuda:0`` named twice (two
   entries on the one card, each with its own buffers and streams); the
   phase prints which. The launch counts are set to 0 just before each
   sub-phase and read just after. 17a: phase 4's 2 GiB recheck (8192 x
   256 KiB, batch 4096) through ``verify_pieces(hasher="gpu",
   mesh=grid)``: all True, then one flipped byte (piece 7777) flags
   exactly that piece, equal to the one-entry path's and hashlib's
   bitfields; each entry launches the SHA-1 kernel once a batch. 17b:
   ``make_torrent`` of phase 4's six files on the default grid (the
   process's cards made the grid's entries) gives hashlib's ``.torrent``
   bytes. 17c: a scheduler whose SHA-1 lanes span the grid sweeps the
   first 256 MiB of the 2 GiB file: hashlib's bitfield, no CPU-fallback
   launch, each scheduler launch one kernel launch an entry. 17d:
   ``entry.dryrun_multichip(4)`` on the card. 17e: two gloo ranks of two
   entries each on their card (a (2, 2) grid): phase 8's v1 recheck, clean
   and flipped, hashlib's bitfields on both. Printed beside the card's
   name and power limit (``time: mesh`` lines): each sub-phase's wall
   beside the one-entry path's and hashlib's, and phase 17's wall.

The line before the last is the kernels' JSON record (its ``launches``
are phases 4 and 5's; phases 7 to 17 print their own); the last line is
``{"ok": true, "device": {...}}``. The page cache holds the payload when
it is rechecked (it was just written), so the end-to-end rates measure
reads from memory, padding, copies and the kernels, not a disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
PIECE = 256 * 1024
BATCH = 4096
# single-file payload: 8192 pieces, the last one 100,000 bytes short
SINGLE_BYTES = 8192 * PIECE - 100_000
# multi-file payload: sizes chosen so files start and end inside pieces
MULTI_FILES = (
    ("a.bin", 100_000_003),
    ("b/tiny.bin", 7),
    ("b/c.bin", PIECE - 1),
    ("d.bin", 50_000_000),
    ("e.bin", 1),
    ("f/g/h.bin", 33_554_433),
)
NIST = (
    (b"", "da39a3ee5e6b4b0d3255bfef95601890afd80709"),
    (b"abc", "a9993e364706816aba3e25717850c26c9cd0d89d"),
    (
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
        "84983e441c3bd26ebaae4aa1f95129e5e54670f1",
    ),
)
RAGGED = (0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 300, 16 * 1024, PIECE - 1)
# SHA-1 batches around the kernel's 32-piece CTA: rows, longest length
CTA_BATCHES = ((33, 16 * 1024), (4097, 4096))
SWEEP_ROWS = (1, 256, 4096, 16384)  # the phase-6 batch sweep at 256 KiB
NIST256 = (
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (b"abc", "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
        "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1",
    ),
)
MILLION_A256 = "cdc76e5c9914fb9281a1c7e284d73e67f1809a48a497200e046d39ccc7112cd0"
RAGGED256 = (0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 300, 8191, 16383, 16384)
V2_PIECE = 1 << 20  # make --v2's default piece length
LEAF = 16 * 1024  # BEP 52 leaf block
LEAF_LAUNCH = 32768  # leaves per authoring launch (models/v2.py LEAF_BATCH)
VERIFY_LEAVES = 256 * (V2_PIECE // LEAF)  # leaves per v2 recheck launch
PAIRS = 65536  # one merkle level of the 2 GiB payload's leaf grid
# merkle reductions held against hashlib, (trees, leaves per tree): partial,
# full and ragged 512-node CTAs, the v2 recheck batch and authoring piece
# grid, one and two launches
MERKLE_SHAPES = ((1, 2), (5, 8), (3, 64), (256, 64), (2048, 64), (1000, 2), (1, 2048), (2, 4096), (1, 1 << 17))
MERKLE_RECORD = (2048, 64)  # the kernels record's shape: build_v2's piece grid of the 2 GiB payload
MERKLE_PATH_MAX = 58  # merkle launches the v2 phase may make (one a reduction up to the cap)
# phase 7's library: BASELINE config 5 (1000 torrents x ~1 GiB) cut in count
# only, to 2 single-file torrents of 1 GiB at 256 KiB pieces (2 GiB)
LIB_TORRENTS = 2
LIB_TORRENT_BYTES = 1 << 30
LIB_VICTIM = 1  # the library torrent whose one flipped byte must be flagged
STREAM_LEAVES = 32768  # the stream tenant's 16 KiB leaves: the first 512 MiB


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def write_random(path: str, nbytes: int, rng: np.random.Generator) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        left = nbytes
        while left:
            n = min(left, 64 << 20)
            f.write(rng.bytes(n))
            left -= n


def flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def sass_opcodes(lib) -> dict:
    """SASS opcodes per kernel of a built library, from ``cuobjdump -sass``
    (prologue, loads and stores included), as {kernel: Counter}; {}
    without cuobjdump."""
    from collections import Counter

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120).stdout
    ops: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is not None and m:
            ops[name][m.group(1)] += 1
    return ops


def sched_phase(tmp: str, single: str, multi_root: str, multi_info, rng, card: str) -> tuple:
    """Phase 7: the hash-plane scheduler on the card (see the module
    docstring). Returns its launches per kernel from the clean runs, the
    library's authored torrents, and the library sweep's seconds through
    the default scheduler and through hashlib (phase 9's baselines)."""
    import asyncio

    import torch

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.obs.attrib import attribute
    from torrent_tpu_torch.obs import profiler
    from torrent_tpu_torch.obs.ledger import pipeline_ledger
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.ops.padding import padded_len_for
    from torrent_tpu_torch.parallel.bulk import verify_library, verify_library_sched
    from torrent_tpu_torch.parallel.verify import verify_pieces_sched
    from torrent_tpu_torch.sched import (
        FaultPlan,
        HashPlaneScheduler,
        SchedLaunchError,
        SchedulerConfig,
    )
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    sha1_k, sha256_k = sha1_cuda.sha1_pieces_cuda, sha256_cuda.sha256_pieces_cuda
    lib_root = os.path.join(tmp, "library")
    paths = [os.path.join(lib_root, f"t{i:02d}.bin") for i in range(LIB_TORRENTS)]
    for p in paths:
        write_random(p, LIB_TORRENT_BYTES, rng)
    t = time.perf_counter()
    infos, torrents = [], []
    for p in paths:
        torrents.append(make_torrent(p, "http://localhost/announce", piece_length=PIECE, hasher="gpu"))
        gpu_meta = parse_metainfo(torrents[-1])
        cpu_meta = parse_metainfo(make_torrent(p, "http://localhost/announce", piece_length=PIECE, hasher="cpu"))
        check(gpu_meta.info.pieces == cpu_meta.info.pieces, f"library {p}: gpu authoring differs from hashlib")
        infos.append(gpu_meta.info)
    log(
        f"phase 7: library of {LIB_TORRENTS} x {LIB_TORRENT_BYTES >> 20} MiB torrents "
        f"({sum(i.num_pieces for i in infos)} pieces of 256 KiB) authored gpu == hashlib "
        f"in {time.perf_counter() - t:.2f} s"
    )

    def items():  # fresh FsStorages, as a new process would open them
        return [(Storage(FsStorage(lib_root), i), i) for i in infos]

    t = time.perf_counter()
    cpu_lib = verify_library(items(), hasher="cpu")
    hashlib_lib_s = time.perf_counter() - t
    check(all(bf.all() for bf in cpu_lib.bitfields), "library: hashlib sweep not all True")
    with open(single, "rb") as f:
        stream_blob = f.read(STREAM_LEAVES * LEAF)
    leaves = [stream_blob[i : i + LEAF] for i in range(0, len(stream_blob), LEAF)]
    want_leaves = [hashlib.sha256(x).digest() for x in leaves]
    del stream_blob

    async def stream(sched):
        chunk = sched.chunk_for(LEAF, "sha256")
        parts = await asyncio.gather(*(
            sched.submit("stream", leaves[s : s + chunk], algo="sha256", piece_length=LEAF, wait=True)
            for s in range(0, len(leaves), chunk)
        ))
        return [d for part in parts for d in part]

    def assert_clean(sched, label):
        snap = sched.metrics_snapshot()
        check(snap["cpu_fallback_launches"] == 0, f"{label}: {snap['cpu_fallback_launches']} cpu fallback launches")
        check(snap["launch_failures"] == 0, f"{label}: {snap['launch_failures']} launch failures")
        states = {k: b["state"] for k, b in snap["breakers"].items()}
        check(all(s == "closed" for s in states.values()), f"{label}: breakers {states}")
        check(snap["staging"]["outstanding"] == 0, f"{label}: {snap['staging']['outstanding']} ingest slabs outstanding")
        reuse = sched.staging_reuse()
        check(reuse["outstanding"] == 0 and reuse["early_checkins"] == 0, f"{label}: staging reuse {reuse}")
        return snap

    walls = {}  # each run's wall, by label
    sweeps = {}  # each run's library sweep seconds, by label

    async def traffic(cfg: SchedulerConfig, label: str, trace_dir: str | None = None) -> tuple[int, int]:
        """One run of the three tenants; under a profiler capture into
        ``trace_dir`` when given."""
        if trace_dir is not None:
            os.environ["TORRENT_TPU_PROFILE"] = trace_dir
            os.environ["TORRENT_TPU_PROFILE_BATCHES"] = str(1 << 30)  # the whole run
        sched = await HashPlaneScheduler(cfg, hasher="gpu").start()
        sched.register_tenant("bulk", weight=0.25)
        led = pipeline_ledger()
        prev = led.snapshot()
        # the main path: the counts are 0 just before it and read just after
        sha1_k.launches = sha256_k.launches = 0
        t0 = time.perf_counter()
        try:
            lib, bf_cli, got_leaves = await asyncio.gather(
                verify_library_sched(items(), sched, tenant="bulk"),
                verify_pieces_sched(Storage(FsStorage(os.path.dirname(multi_root)), multi_info), multi_info, sched, tenant="cli"),
                stream(sched),
            )
            wall = walls[label] = time.perf_counter() - t0
            sweeps[label] = lib.seconds
            launches = (sha1_k.launches, sha256_k.launches)
            rep = attribute(led.snapshot(), prev=prev)
            trace = None
            if trace_dir is not None:
                torch.cuda.synchronize()
                trace = profiler.flush_trace(trace_dir)
            if label == "default":
                # one flipped byte in a library torrent flags exactly that piece
                victim, off, vinfo = paths[LIB_VICTIM], 77 * PIECE + 4321, infos[LIB_VICTIM]
                flip_byte(victim, off)
                try:
                    bfv = await verify_pieces_sched(Storage(FsStorage(lib_root), vinfo), vinfo, sched, tenant="cli")
                finally:
                    flip_byte(victim, off)
                flagged = list(np.nonzero(~bfv)[0])
                check(flagged == [77], f"library torrent {LIB_VICTIM}: flagged {flagged}")
        finally:
            if trace_dir is not None:
                del os.environ["TORRENT_TPU_PROFILE"], os.environ["TORRENT_TPU_PROFILE_BATCHES"]
            await sched.close()
        check(all(bf.all() for bf in lib.bitfields), f"{label}: library sweep not all True")
        check(all((a == b).all() for a, b in zip(lib.bitfields, cpu_lib.bitfields)), f"{label}: library differs from hashlib")
        check(bf_cli.all(), f"{label}: the cli recheck of the 184 MB torrent not all True")
        check(got_leaves == want_leaves, f"{label}: stream leaf digests differ from hashlib")
        check(launches[0] > 0 and launches[1] > 0, f"{label}: kernels launched {launches} times")
        snap = assert_clean(sched, label)
        for stage in ("h2d", "launch", "digest"):
            st = rep["stages"].get(stage, {})
            check(st.get("bytes", 0) > 0 and st.get("busy_s", 0) > 0, f"{label}: ledger {stage} {st}")
        copied = rep["stages"].get("stage", {}).get("ops", 0)
        spans = rep["stages"]["h2d"]["busy_s"] + rep["stages"]["launch"]["busy_s"]
        reuse = sched.staging_reuse()
        bn = rep["bottleneck"] or {}
        log(
            f"phase 7: {label}: library {lib.n_pieces} pieces + cli {multi_info.num_pieces} pieces "
            f"+ stream {len(leaves)} leaves all equal hashlib; sha1_cuda launches={launches[0]} "
            f"sha256_cuda launches={launches[1]}; no cpu fallback, no launch failure, breakers closed, "
            f"ingest pools drained"
        )
        log(
            f"time: sched {label} (batch_target={cfg.batch_target}, staging_budget={cfg.staging_budget}) "
            f"wall s={wall:.3f}; library sweep s={lib.seconds:.3f} pieces/s={lib.n_pieces / lib.seconds:.1f} "
            f"GiB/s={lib.bytes_hashed / lib.seconds / 2**30:.3f}; hashlib library sweep s={hashlib_lib_s:.3f} "
            f"pieces/s={cpu_lib.n_pieces / hashlib_lib_s:.1f} {card}"
        )
        log(
            f"time: sched {label} launches={snap['launches']} mean_fill={snap['mean_fill']:.4f} "
            f"flush_reasons={snap['flush_reasons']} staged={snap['launches'] - copied} copied={copied} "
            f"lanes={ {k: (v['target'], v['launches'], round(v['mean_fill'], 4)) for k, v in snap['lane_stats'].items()} } {card}"
        )
        log(
            f"time: sched {label} ledger "
            + " ".join(
                f"{name}=({st['busy_s']:.4f} s, {st['bytes']} B, {st['ops']} ops)"
                for name, st in rep["stages"].items()
            )
            + f" wall_s={rep['wall_s']:.4f} overlap_share={rep['overlap']['share']:.4f} "
            f"bottleneck={bn.get('stage')} (utilization {bn.get('utilization')}); "
            f"h2d + launch span seconds over wall = {spans / wall:.4f} (host clock, "
            f"threads overlap: not the card's share) {card}"
        )
        log(
            f"time: sched {label} staging slots allocated={reuse['slots_allocated']} in "
            f"s={reuse['alloc_s']:.4f} (pinned), copy checks={reuse['copy_checks']} "
            f"early check-ins={reuse['early_checkins']} {card}"
        )
        if trace is not None:
            busy = profiler.device_busy(trace)
            if busy["kernels"] == 0:
                log(f"time: sched {label} card busy share: not measured (the trace holds no kernel events) {card}")
            else:
                # the capture slows the host (its start-up and host-side
                # events), not the card's work: the same work unprofiled
                # took the default run's wall
                ref = walls["default"]
                log(
                    f"time: sched {label} card busy from the torch.profiler trace: kernels s={busy['kernel_s']:.4f} "
                    f"copies s={busy['copy_s']:.4f} either s={busy['busy_s']:.4f}; share of the default run's "
                    f"wall s={ref:.3f} = {busy['busy_s'] / ref:.4f} (kernels {busy['kernel_s'] / ref:.4f}, copies "
                    f"{busy['copy_s'] / ref:.4f}); of this run's first to last device event s={busy['span_s']:.4f} "
                    f"= {busy['busy_s'] / busy['span_s']:.4f}; of this profiled run's wall s={wall:.3f} = "
                    f"{busy['busy_s'] / wall:.4f}; {busy['kernels']} kernel events {busy['kernel_names']}, "
                    f"{busy['copies']} copy events; kernel launches counted {launches} {card}"
                )
        return launches

    clean = {}
    clean["default"] = asyncio.run(traffic(SchedulerConfig(), "default"))
    batch_cfg = SchedulerConfig(
        batch_target=BATCH,
        staging_budget=BATCH * padded_len_for(PIECE),
        # room for two launches of 4096 x 256 KiB in flight and one queued
        max_queue_bytes=3 * BATCH * padded_len_for(PIECE),
        max_tenant_bytes=3 * BATCH * padded_len_for(PIECE),
    )
    clean["batch4096"] = asyncio.run(traffic(batch_cfg, "batch4096"))
    asyncio.run(traffic(SchedulerConfig(), "profiled", trace_dir=os.path.join(tmp, "profile")))

    # a poisoned ticket fails alone, on the CUDA plane
    pieces = [rng.bytes(16384) for _ in range(64)]
    poison = 37
    plan = FaultPlan(payload_prefix=pieces[poison][:16])

    async def poisoned():
        sched = await HashPlaneScheduler(
            SchedulerConfig(batch_target=64, flush_deadline=0.05, plane_factory=plan.plane_factory(hasher="gpu")),
            hasher="gpu",
        ).start()
        before = sha1_k.launches
        try:
            got = await asyncio.gather(
                *(sched.submit(f"t{i % 4}", [p], piece_length=16384) for i, p in enumerate(pieces)),
                return_exceptions=True,
            )
        finally:
            await sched.close()
        return got, sha1_k.launches - before, sched.metrics_snapshot()

    got, k_launches, snap = asyncio.run(poisoned())
    for i, (p, g) in enumerate(zip(pieces, got)):
        if i == poison:
            check(isinstance(g, SchedLaunchError) and g.kind == "deterministic", f"poisoned ticket got {g!r}")
        else:
            check(g == [hashlib.sha1(p).digest()], f"ticket {i} beside the poisoned one got {g!r}")
    check(snap["cpu_fallback_launches"] == 0 and snap["failed_pieces"] == 1, f"poisoned run: {snap}")
    check(k_launches > 0, "poisoned run: the SHA-1 kernel launched no time")
    log(
        f"phase 7: poisoned prefix: ticket {poison} failed alone (SchedLaunchError, deterministic) after "
        f"{snap['bisections']} bisections, the other 63 got hashlib's digests from {k_launches} "
        f"sha1_cuda launches, no cpu fallback"
    )
    torch.cuda.synchronize()
    return clean, torrents, {
        "sched_s": sweeps["default"], "hashlib_s": hashlib_lib_s, "pieces": cpu_lib.n_pieces,
        "bytes": sum(i.length for i in infos),
    }


DIST_RANKS = 2  # phase 8's rank processes, all on cuda:0 (one card: gloo, not NCCL)
DIST_TIMEOUT_S = 300  # every collective's timeout in the ranks
DIST_WAIT_S = 900  # the parent's wait for the ranks


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def false_rows(bf) -> list:
    return [int(i) for i in np.nonzero(~np.asarray(bf))[0]]


def rank_main(argv) -> None:
    """One rank of phase 8 (``chip_smoke.py --dist-rank R ...``): joins
    the gloo group on the card, runs the four sub-phases on the payloads
    the parent names in ``spec.json``, and writes ``result_<R>.json``."""
    import argparse
    import asyncio

    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for flag in ("--dist-rank", "--dist-world"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--dist-init", "--dist-dir"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--dist-mode", choices=("dist", "mesh"), default="dist")
    a = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.codec.metainfo_v2 import parse_metainfo_v2
    from torrent_tpu_torch.native import build as native_build
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.parallel import distributed as D
    from torrent_tpu_torch.parallel.bulk import verify_library_fabric
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
    from torrent_tpu_torch.session.v2 import v2_session_meta
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    # a rank only loads what phase 2 built: two ranks that both found a
    # library stale would run two nvccs at once
    for mod in (sha1_cuda, sha256_cuda):
        check(not native_build.is_stale(mod.SOURCE, mod.LIBRARY), f"rank {a.dist_rank}: {mod.LIBRARY.name} is stale")
    check(not native_build.is_stale(native_build._SRC, native_build._LIB), f"rank {a.dist_rank}: the pread pool is stale")
    with open(os.path.join(a.dist_dir, "spec.json")) as f:
        spec = json.load(f)
    rank = a.dist_rank
    D.initialize(a.dist_init, a.dist_world, rank, backend="gloo", timeout=DIST_TIMEOUT_S)
    kernels = {
        "sha1_cuda": sha1_cuda.sha1_pieces_cuda,
        "sha256_cuda": sha256_cuda.sha256_pieces_cuda,
        "sha256_merkle_cuda": sha256_cuda.sha256_merkle_cuda,
    }
    out = {"rank": rank, "device": str(torch.device("cuda", torch.cuda.current_device())), "sub": {}}
    tmp = spec["tmp"]

    def timed(name, fn, **record):
        """Run ``fn`` with every launch count at 0 just before it and
        read just after; both ranks start together."""
        dist.barrier()
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        value = fn()
        wall = time.perf_counter() - t
        out["sub"][name] = dict(record, wall_s=wall, launches={n: k.launches for n, k in kernels.items()})
        return value

    def flipped(path: str, off: int, fn):
        """``fn()`` while one byte of ``path`` is flipped (by rank 0)."""
        dist.barrier()
        if rank == 0:
            flip_byte(path, off)
        dist.barrier()
        try:
            return fn()
        finally:
            dist.barrier()
            if rank == 0:
                flip_byte(path, off)
            dist.barrier()

    try:
        with open(spec["v1_torrent"], "rb") as f:
            info = parse_metainfo(f.read()).info
        victim, off = spec["victim"], spec["victim_offset"]
        if a.dist_mode == "mesh":
            # phase 17e: this rank's MESH_RANK_ENTRIES entries on its card,
            # a (ranks, entries) grid over the group
            from torrent_tpu_torch.parallel.mesh import spanning_grid

            entries = [torch.device("cuda", torch.cuda.current_device())] * MESH_RANK_ENTRIES
            out["grid"] = spanning_grid(devices=entries).shape

            def grid_v1():
                return verify_pieces(Storage(FsStorage(tmp), info), info, hasher="gpu", batch_size=BATCH, devices=entries)

            def grid_direct():
                return D.verify_storage_distributed(Storage(FsStorage(tmp), info), info, batch_size=BATCH, devices=entries)

            bf = timed("grid clean", grid_v1)
            out["sub"]["grid clean"]["false"] = false_rows(bf)
            bf, n_valid = flipped(victim, off, lambda: timed("grid flipped", grid_direct))
            out["sub"]["grid flipped"].update(false=false_rows(bf), n_valid=int(n_valid))
            write_result(a.dist_dir, rank, out)
            return

        def v1():
            return verify_pieces(Storage(FsStorage(tmp), info), info, hasher="gpu", batch_size=BATCH)

        def v1_direct():
            return D.verify_storage_distributed(Storage(FsStorage(tmp), info), info, batch_size=BATCH)

        bf = timed("v1 clean", v1)
        out["sub"]["v1 clean"]["false"] = false_rows(bf)
        bf = flipped(victim, off, lambda: timed("v1 flipped", v1))
        out["sub"]["v1 flipped"]["false"] = false_rows(bf)
        bf, n_valid = flipped(victim, off, lambda: timed("v1 flipped direct", v1_direct))
        out["sub"]["v1 flipped direct"].update(false=false_rows(bf), n_valid=int(n_valid))

        with open(spec["v2_torrent"], "rb") as f:
            v2info = v2_session_meta(parse_metainfo_v2(f.read())).info

        def v2():
            return verify_pieces(Storage(FsStorage(tmp), v2info), v2info, hasher="gpu")

        bf = timed("v2 clean", v2)
        out["sub"]["v2 clean"]["false"] = false_rows(bf)
        bf = flipped(victim, off, lambda: timed("v2 flipped", v2))
        out["sub"]["v2 flipped"]["false"] = false_rows(bf)

        lib_infos = []
        for path in spec["lib_torrents"]:
            with open(path, "rb") as f:
                lib_infos.append(parse_metainfo(f.read()).info)

        def items():
            return [(Storage(FsStorage(spec["lib_root"]), i), i) for i in lib_infos]

        bitfields, n_valid = timed("library", lambda: D.verify_library_distributed(items(), batch_size=BATCH))
        out["sub"]["library"].update(false=[false_rows(bf) for bf in bitfields], n_valid=int(n_valid))

        async def fabric():
            sched = await HashPlaneScheduler(SchedulerConfig(), hasher="gpu").start()
            executors: list = []
            try:
                res = await verify_library_fabric(items(), sched, executor_out=executors)
            finally:
                await sched.close()
            ex = executors[0]
            return res, ex.metrics_snapshot(), type(ex.transport).__name__, sched.metrics_snapshot()

        res, fab, transport, snap = timed("fabric", lambda: asyncio.run(fabric()))
        out["sub"]["fabric"].update(
            false=[false_rows(bf) for bf in res.bitfields],
            transport=transport,
            pieces_verified=fab["pieces_verified"],
            units_done=fab["units_done"],
            units_adopted=fab["units_adopted"],
            cpu_fallback_launches=snap["cpu_fallback_launches"],
            launch_failures=snap["launch_failures"],
            staging_outstanding=snap["staging"]["outstanding"],
        )
        leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "torrent_tpu"))
        check(not leaked, f"rank {rank} imported {leaked}")
    finally:
        D.shutdown()
    write_result(a.dist_dir, rank, out)


def write_result(d: str, rank: int, out: dict) -> None:
    """A rank's ``result_<rank>.json``, written whole or not at all."""
    path = os.path.join(d, f"result_{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def run_ranks(d: str, mode: str = "dist") -> list:
    """Start phase 8's ranks (or with ``mode="mesh"`` phase 17e's) as
    fresh interpreters (never a fork of this CUDA process), wait for all,
    and kill every rank if one fails: its peers would wait in a
    collective until the timeout."""
    init = f"tcp://127.0.0.1:{free_port()}"
    procs, logs = [], []
    for r in range(DIST_RANKS):
        logs.append(open(os.path.join(d, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r), "--dist-world", str(DIST_RANKS),
             "--dist-init", init, "--dist-dir", d, "--dist-mode", mode],
            stdout=logs[-1], stderr=subprocess.STDOUT,
        ))
    try:
        deadline = time.monotonic() + DIST_WAIT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * DIST_RANKS:
        for r in range(DIST_RANKS):
            with open(os.path.join(d, f"rank{r}.log")) as f:
                log(f"  rank {r} (rc {rcs[r]}) log tail:\n{f.read()[-4000:]}")
        raise SmokeFailure(f"{'phase 17e' if mode == 'mesh' else 'phase 8'}: ranks exited {rcs}")
    results = []
    for r in range(DIST_RANKS):
        with open(os.path.join(d, f"result_{r}.json")) as f:
            results.append(json.load(f))
    return results


def dist_phase(tmp: str, torrents: dict, lib_torrents: list, single: dict, card: str) -> dict:
    """Phase 8: two ranks sharing the card over gloo, and NCCL at world
    size 1 (see the module docstring). Returns each rank's launches."""
    import asyncio

    import torch

    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.fabric import AllgatherHeartbeat
    from torrent_tpu_torch.parallel import distributed as D
    from torrent_tpu_torch.parallel.bulk import verify_library, verify_library_fabric
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    d = os.path.join(tmp, "dist")
    os.makedirs(d)
    spec = {"tmp": tmp, "lib_root": os.path.join(tmp, "library"), "victim": os.path.join(tmp, "single.bin"),
            "victim_offset": 5000 * PIECE + 777, "lib_torrents": []}
    for key, raw in (("v1_torrent", torrents["single"]), ("v2_torrent", torrents["v2 single"])):
        spec[key] = os.path.join(d, key + ".torrent")
        with open(spec[key], "wb") as f:
            f.write(raw)
    for i, raw in enumerate(lib_torrents):
        spec["lib_torrents"].append(os.path.join(d, f"lib{i}.torrent"))
        with open(spec["lib_torrents"][-1], "wb") as f:
            f.write(raw)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    lib_infos = [parse_metainfo(raw).info for raw in lib_torrents]
    lib_pieces = sum(i.num_pieces for i in lib_infos)

    def items():
        return [(Storage(FsStorage(spec["lib_root"]), i), i) for i in lib_infos]

    # the single-process walls of the library routes, for comparison
    t = time.perf_counter()
    lib = verify_library(items(), hasher="gpu", batch_size=BATCH)
    single["library"] = time.perf_counter() - t
    check(all(bf.all() for bf in lib.bitfields), "phase 8: single-process verify_library not all True")

    async def fabric_solo():
        sched = await HashPlaneScheduler(SchedulerConfig(), hasher="gpu").start()
        try:
            return await verify_library_fabric(items(), sched, nproc=1, pid=0)
        finally:
            await sched.close()

    t = time.perf_counter()
    res = asyncio.run(fabric_solo())
    single["fabric"] = time.perf_counter() - t
    check(all(bf.all() for bf in res.bitfields), "phase 8: single-process verify_library_fabric not all True")
    del lib, res
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    ranks = run_ranks(d)
    log(f"phase 8: {DIST_RANKS} gloo ranks on {[r['device'] for r in ranks]} ran in s={time.perf_counter() - t:.2f} (start-up included)")
    n_batches = -(-parse_metainfo(torrents["single"]).info.num_pieces // BATCH)
    want = {
        "v1 clean": [], "v1 flipped": [5000], "v1 flipped direct": [5000],
        "v2 clean": [], "v2 flipped": [(5000 * PIECE + 777) // V2_PIECE],
        "library": [[]] * len(lib_infos), "fabric": [[]] * len(lib_infos),
    }
    for r in ranks:
        sub = r["sub"]
        for name, rows in want.items():
            check(sub[name]["false"] == rows, f"phase 8 rank {r['rank']} {name}: False rows {sub[name]['false']}, hashlib's {rows}")
        for name in ("v1 clean", "v1 flipped", "v1 flipped direct"):
            # every rank hashes its 2048 rows of each global batch on the card
            check(sub[name]["launches"]["sha1_cuda"] == n_batches, f"phase 8 rank {r['rank']} {name}: {sub[name]['launches']}")
        check(sub["v1 flipped direct"]["n_valid"] == 8191, f"phase 8 rank {r['rank']}: n_valid {sub['v1 flipped direct']['n_valid']}")
        for name in ("v2 clean", "v2 flipped"):
            got = sub[name]["launches"]
            check(got["sha256_cuda"] > 0 and got["sha256_merkle_cuda"] > 0, f"phase 8 rank {r['rank']} {name}: {got}")
        check(sub["library"]["n_valid"] == lib_pieces, f"phase 8 rank {r['rank']} library n_valid {sub['library']['n_valid']}")
        fab = sub["fabric"]
        for name in ("library", "fabric"):
            check(sub[name]["launches"]["sha1_cuda"] > 0, f"phase 8 rank {r['rank']} {name}: {sub[name]['launches']}")
        check(fab["transport"] == "AllgatherHeartbeat", f"phase 8 rank {r['rank']} fabric transport {fab['transport']}")
        check(fab["pieces_verified"] > 0 and fab["units_adopted"] == 0, f"phase 8 rank {r['rank']} fabric {fab}")
        check(fab["cpu_fallback_launches"] == 0 and fab["launch_failures"] == 0, f"phase 8 rank {r['rank']} fabric {fab}")
        check(fab["staging_outstanding"] == 0, f"phase 8 rank {r['rank']} fabric {fab}")
    check(sum(r["sub"]["fabric"]["pieces_verified"] for r in ranks) == lib_pieces, "phase 8: fabric pieces verified")
    log(
        f"phase 8: each rank's bitfields equal hashlib's on v1 (clean, flipped piece 5000), v2 (clean, flipped piece "
        f"{want['v2 flipped'][0]}), verify_library_distributed and verify_library_fabric (AllgatherHeartbeat, "
        f"pieces verified {[r['sub']['fabric']['pieces_verified'] for r in ranks]}, no adoption, no cpu fallback, "
        f"no launch failure); v1 n_valid 8191 == popcount"
    )
    singles = {
        "v1 clean": single["v1"], "v1 flipped": single["v1 again"], "v1 flipped direct": single["v1 again"],
        "v2 clean": single["v2"], "v2 flipped": single["v2 again"],
        "library": single["library"], "fabric": single["fabric"],
    }
    for name in want:
        walls = " ".join(f"rank {r['rank']} s={r['sub'][name]['wall_s']:.3f}" for r in ranks)
        launches = " ".join(f"rank {r['rank']} {r['sub'][name]['launches']}" for r in ranks)
        log(
            f"time: dist {name}: two ranks sharing one H100 over gloo (not multi-card scaling) {walls}; "
            f"single process s={singles[name]:.3f}; launches {launches} {card}"
        )

    # NCCL at the one world size a single card allows
    backend = D.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl", timeout=DIST_TIMEOUT_S)
    try:
        check(backend == "nccl", f"phase 8: backend {backend}")
        count = D.psum_valid_count(torch.tensor([True, False, True, True], device="cuda"))
        check(count.is_cuda and int(count.item()) == 3, f"phase 8: nccl count {count}")
        gathered = D.allgather_bitfield(np.array([1, 0, 0, 1], dtype=bool))
        check(list(gathered) == [True, False, False, True], f"phase 8: nccl allgather {gathered}")
        peers = AllgatherHeartbeat(1, 0, max_bytes=4096).exchange({"pid": 0, "seq": 1, "t": 0.0})
        check(peers == {}, f"phase 8: nccl heartbeat peers {peers}")
        info = parse_metainfo(torrents["single"]).info
        t = time.perf_counter()
        bf, n_valid = D.verify_storage_distributed(Storage(FsStorage(tmp), info), info, batch_size=BATCH)
        nccl_s = time.perf_counter() - t
        check(bf.all() and n_valid == info.num_pieces, f"phase 8: nccl recheck n_valid {n_valid}")
    finally:
        D.shutdown()
    log(
        f"phase 8: nccl at world size 1: count all_reduce on the card (3), allgather_bitfield, one "
        f"AllgatherHeartbeat.exchange and a 2 GiB verify_storage_distributed (n_valid {n_valid}, "
        f"s={nccl_s:.3f}) {card}"
    )
    return {r["rank"]: {name: r["sub"][name]["launches"] for name in want} for r in ranks}


# ---------------------------------------------------------------- phase 9

BRIDGE_TENANTS = 4  # run 3's concurrent X-Tenant clients
BRIDGE_WAVES = 4  # requests each tenant posts, one after the other
BRIDGE_PIECES = 64  # 256 KiB pieces a /v1/verify body
BRIDGE_FLIP = 5000  # the piece whose byte run 1 flips, as phase 4 does
BRIDGE_CLIENT_S = 300  # the parent's wait for one client run
# chunked transfer-encoding chunk sizes, cycled: odd, and smaller and
# larger than a frame, so frames straddle chunk edges
CHUNK_SIZES = (1_000_003, 65_537, 7, 262_147, 4_093)


_CONNECTS: list = []  # every connect's seconds in this client process


class _Http:
    """A bare HTTP/1.1 client on one socket (phase 9's foreign client:
    what a Deno ``fetch`` puts on the wire, built here byte by byte)."""

    def __init__(self, port: int):
        import socket

        t0 = time.perf_counter()
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=BRIDGE_CLIENT_S)
        # the TCP handshake alone, apart from the request: a connect the
        # host's stack stalls is not bridge time
        self.connect_s = time.perf_counter() - t0
        _CONNECTS.append(self.connect_s)
        self._sizes = 0

    def head(self, method: str, path: str, headers: dict, length: int | None) -> None:
        lines = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        lines.append("Transfer-Encoding: chunked" if length is None else f"Content-Length: {length}")
        self.sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    def chunked(self, data) -> None:
        """Send ``data`` as chunks of the cycled odd sizes."""
        mv = memoryview(data)
        pos = 0
        while pos < len(mv):
            n = min(CHUNK_SIZES[self._sizes % len(CHUNK_SIZES)], len(mv) - pos)
            self._sizes += 1
            self.sock.sendall(b"%x\r\n" % n)
            self.sock.sendall(mv[pos : pos + n])
            self.sock.sendall(b"\r\n")
            pos += n

    def end_chunks(self) -> None:
        self.sock.sendall(b"0\r\n\r\n")

    def response(self) -> tuple:
        """``(status, lower-cased headers, body)``; closes the socket."""
        f = self.sock.makefile("rb")
        try:
            status = int(f.readline().split()[1])
            hdrs = {}
            while True:
                line = f.readline()
                if line in (b"\r\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                hdrs[k.strip().lower()] = v.strip()
            body = f.read(int(hdrs.get("content-length", 0)))
        finally:
            f.close()
            self.sock.close()
        return status, hdrs, body


def _request(port: int, method: str, path: str, headers=None, body: bytes = b"") -> tuple:
    c = _Http(port)
    c.head(method, path, headers or {}, len(body))
    if body:
        c.sock.sendall(body)
    return c.response()


def bridge_client_main(argv) -> None:
    """Phase 9's client (``chip_smoke.py --bridge-client RUN ...``): a
    fresh interpreter that speaks HTTP over a socket to the bridge and
    hashes with hashlib. It imports no torch: only this script's own
    module (numpy at its top) and the port's device-free bencode codec.
    Writes its result as JSON; any check that fails raises."""
    import argparse
    import threading

    ap = argparse.ArgumentParser()
    ap.add_argument("--bridge-client", dest="run", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from torrent_tpu_torch.codec.bencode import bdecode, bencode

    with open(a.spec) as f:
        spec = json.load(f)
    with open(spec["torrent"], "rb") as f:
        info = bdecode(f.read())[b"info"]
    plen = info[b"piece length"]
    pieces_blob = info[b"pieces"]
    expected = [pieces_blob[i : i + 20] for i in range(0, len(pieces_blob), 20)]
    out: dict = {"run": a.run}

    def read_pieces(first: int, count: int, size: int) -> list:
        with open(spec["single"], "rb") as f:
            f.seek(first * size)
            blob = f.read(count * size)
        return [blob[i : i + size] for i in range(0, len(blob), size)]

    def stream(path: str, headers: dict, frames) -> tuple:
        """POST ``frames`` (an iterator of frame blocks) chunked; returns
        the wall from the first byte sent to the last byte read."""
        c = _Http(a.port)
        t0 = time.perf_counter()
        c.head("POST", path, headers, None)
        for block in frames:
            c.chunked(block)
        c.end_chunks()
        status, hdrs, body = c.response()
        return time.perf_counter() - t0, status, hdrs, body

    if a.run == "stream_verify":
        n = len(expected)

        def frames():
            for first in range(0, n, 64):
                block = bytearray()
                for i, piece in enumerate(read_pieces(first, min(64, n - first), plen)):
                    block += len(piece).to_bytes(4, "big") + piece + expected[first + i]
                yield block

        wall, status, hdrs, body = stream(
            "/v1/stream/verify", {"X-Piece-Length": plen, "X-Trace-Id": "smoke-run1", "X-Tenant": "stream"}, frames()
        )
        check(status == 200, f"run 1: status {status}: {body[:200]!r}")
        rec = bdecode(body)
        t = time.perf_counter()
        want = bytearray()
        for first in range(0, n, 256):
            for i, piece in enumerate(read_pieces(first, min(256, n - first), plen)):
                want.append(int(hashlib.sha1(piece).digest() == expected[first + i]))
        out.update(
            wall_s=wall, frames=n, bytes=spec["single_bytes"], valid=rec[b"valid"], failed=rec[b"failed"],
            ok_is_hashlib=rec[b"ok"] == bytes(want), false=[i for i, v in enumerate(want) if not v],
            trace_id=hdrs.get("x-trace-id"), hashlib_check_s=time.perf_counter() - t,
        )
        check(out["ok_is_hashlib"], "run 1: ok differs from hashlib's bitfield")
        check(rec[b"valid"] == n - 1 and rec[b"failed"] == 0, f"run 1: valid {rec[b'valid']} failed {rec[b'failed']}")
    elif a.run == "stream_sha256":
        leaf, n = spec["leaf"], spec["leaves"]

        def frames():
            for first in range(0, n, 1024):
                block = bytearray()
                for x in read_pieces(first, min(1024, n - first), leaf):
                    block += len(x).to_bytes(4, "big") + x
                yield block

        wall, status, _, body = stream(
            "/v1/stream/digests", {"X-Piece-Length": leaf, "X-Hash-Algo": "sha256", "X-Tenant": "stream"}, frames()
        )
        check(status == 200, f"run 2: status {status}: {body[:200]!r}")
        rec = bdecode(body)
        t = time.perf_counter()
        want = [hashlib.sha256(x).digest() for x in read_pieces(0, n, leaf)]
        out.update(
            wall_s=wall, frames=n, bytes=n * leaf, failed=rec[b"failed"],
            digests_are_hashlib=rec[b"digests"] == want, hashlib_s=time.perf_counter() - t,
        )
        check(out["digests_are_hashlib"] and rec[b"failed"] == 0, "run 2: digests differ from hashlib's")
    elif a.run == "tenants":
        bodies, verdicts = {}, {}
        for k in range(BRIDGE_TENANTS):
            for w in range(BRIDGE_WAVES):
                first = (k * BRIDGE_WAVES + w) * BRIDGE_PIECES
                pieces = read_pieces(first, BRIDGE_PIECES, plen)
                exp = list(expected[first : first + BRIDGE_PIECES])
                bad = (k + w) % BRIDGE_PIECES
                exp[bad] = bytes(b ^ 0xFF for b in exp[bad])
                bodies[k, w] = bencode({b"pieces": pieces, b"expected": exp})
                verdicts[k, w] = bytes(int(hashlib.sha1(p).digest() == e) for p, e in zip(pieces, exp))
        lat, errors = [], []

        def tenant(k):
            try:
                for w in range(BRIDGE_WAVES):
                    t0 = time.perf_counter()
                    status, _, body = _request(a.port, "POST", "/v1/verify", {"X-Tenant": f"tenant{k}"}, bodies[k, w])
                    lat.append(time.perf_counter() - t0)
                    check(status == 200, f"run 3 tenant {k} wave {w}: status {status}: {body[:200]!r}")
                    check(bdecode(body)[b"ok"] == verdicts[k, w], f"run 3 tenant {k} wave {w}: verdicts differ from hashlib's")
            except Exception as e:  # reported by the main thread
                errors.append(repr(e))

        threads = [threading.Thread(target=tenant, args=(k,)) for k in range(BRIDGE_TENANTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        check(not errors, f"run 3: {errors}")
        lat.sort()
        out.update(
            wall_s=wall, requests=len(bodies), pieces=len(bodies) * BRIDGE_PIECES,
            client_p50_s=lat[len(lat) // 2], client_p99_s=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        )
    elif a.run == "fabric":
        items = [{b"torrent": t.encode(), b"root": spec["lib_root"].encode()} for t in spec["lib_torrents"]]
        t0 = time.perf_counter()
        status, _, body = _request(a.port, "POST", "/v1/fabric/verify", {}, bencode({b"items": items}))
        check(status == 202, f"run 4: status {status}: {body[:200]!r}")
        pieces = bdecode(body)[b"pieces"]
        polls = 0
        while True:
            status, _, body = _request(a.port, "GET", "/v1/fabric/status")
            polls += 1
            d = bdecode(body)
            if d[b"state"] != b"running":
                break
            check(time.perf_counter() - t0 < BRIDGE_CLIENT_S, "run 4: the fabric job did not finish")
            time.sleep(0.02)
        wall = time.perf_counter() - t0
        check(d[b"state"] == b"done", f"run 4: state {d}")
        res = d[b"result"]
        check(res[b"valid"] == res[b"pieces"] == pieces, f"run 4: valid {res[b'valid']} of {res[b'pieces']}")
        out.update(wall_s=wall, pieces=pieces, valid=res[b"valid"], polls=polls,
                   units_done=d[b"fabric"][b"units_done"], server_ms=res[b"millis"])
    elif a.run == "routes":
        st, _, body = _request(a.port, "GET", "/v1/info")
        info_rec = bdecode(body)
        check(st == 200 and info_rec[b"backend"] == b"gpu" and info_rec[b"devices"] >= 1
              and info_rec[b"sha256_backend"] == b"cuda", f"/v1/info {st} {info_rec}")
        st, hdrs, body = _request(a.port, "GET", "/metrics")
        text = body.decode()
        check(st == 200 and hdrs["content-type"].startswith("text/plain"), f"/metrics {st}")
        for family in ("torrent_tpu_sched_launches_total", "torrent_tpu_sched_batch_fill_ratio",
                       "torrent_tpu_fabric_state", "torrent_tpu_fleet_reporting",
                       "torrent_tpu_bridge_request_seconds", "torrent_tpu_slo_breach",
                       "torrent_tpu_timeline_samples_total"):
            check(f"# TYPE {family} " in text, f"/metrics lacks {family}")
        routes = {}
        for path in ("/v1/pipeline", "/v1/fleet", "/v1/control", "/v1/health", "/v1/slo", "/v1/timeline",
                     "/v1/swarm", f"/v1/trace?id={spec['trace_id']}"):
            st, hdrs, body = _request(a.port, "GET", path)
            check(st == 200 and hdrs["content-type"] == "application/json", f"{path}: {st} {body[:200]!r}")
            routes[path.split("?")[0]] = json.loads(body)
        bn = routes["/v1/pipeline"]["attribution"]["bottleneck"] or {}
        slo = routes["/v1/slo"]
        check(slo["attached"] and not slo["report"]["breach_any"], f"/v1/slo {slo}")
        check(routes["/v1/health"]["ready"], f"/v1/health {routes['/v1/health']}")
        check(len(routes["/v1/timeline"]["samples"]) >= 1, "/v1/timeline holds no sample")
        check(routes["/v1/control"]["attached"] is False, "/v1/control: an autopilot is attached")
        # a 2 GiB stream's trace outgrows the tracer's per-trace span cap:
        # the tree holds the first spans (the root closes last) and counts
        # the rest as dropped
        tree = routes["/v1/trace"]
        names = set()
        todo = list(tree["spans"])
        while todo:
            node = todo.pop()
            names.add(node["name"])
            todo += node["children"]
        check(tree["trace_id"] == spec["trace_id"] and {"sched.enqueue", "sched.launch"} <= names,
              f"/v1/trace: {str(tree)[:300]}")
        out.update(
            bottleneck=bn.get("stage"), utilization=bn.get("utilization"),
            fleet_state=routes["/v1/fleet"].get("state"), timeline_samples=len(routes["/v1/timeline"]["samples"]),
            trace_spans=tree["span_count"], trace_dropped=tree["dropped_spans"], trace_names=sorted(names),
            health=routes["/v1/health"]["status"],
            metric_families=len([l for l in text.splitlines() if l.startswith("# TYPE ")]),
        )
    else:
        raise SystemExit(f"unknown bridge client run {a.run!r}")
    out["connects"] = len(_CONNECTS)
    out["connect_max_s"] = max(_CONNECTS, default=0.0)
    out["torch_imported"] = "torch" in sys.modules
    check(not out["torch_imported"], "the bridge client imported torch")
    with open(a.out + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(a.out + ".tmp", a.out)


def _bucket_quantile(counts: list, q: float) -> float | None:
    """The upper bound of the log2 bucket holding quantile ``q`` of a
    ``LogHistogram`` snapshot's counts (None past the top bound)."""
    from torrent_tpu_torch.obs.hist import BUCKET_BOUNDS

    total = sum(counts)
    if not total:
        return None
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= q * total:
            return BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else None
    return None


def bridge_phase(tmp: str, single: str, torrent: bytes, lib_torrents: list, baselines: dict, card: str) -> dict:
    """Phase 9: the bridge on the card, driven by a separate client
    process (see the module docstring). Returns its launches per kernel."""
    import asyncio

    import torch

    from torrent_tpu_torch.bridge.service import _H_REQUEST, BridgeServer
    from torrent_tpu_torch.obs import histograms
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.sched import HashPlaneScheduler

    sha1_k, sha256_k = sha1_cuda.sha1_pieces_cuda, sha256_cuda.sha256_pieces_cuda
    d = os.path.join(tmp, "bridge")
    os.makedirs(d, exist_ok=True)
    spec = {
        "single": single, "single_bytes": os.path.getsize(single), "torrent": os.path.join(d, "single.torrent"),
        "leaf": LEAF, "leaves": STREAM_LEAVES, "lib_root": os.path.join(tmp, "library"), "lib_torrents": [],
        "trace_id": "smoke-run1",
    }
    with open(spec["torrent"], "wb") as f:
        f.write(torrent)
    for i, raw in enumerate(lib_torrents):
        spec["lib_torrents"].append(os.path.join(d, f"lib{i}.torrent"))
        with open(spec["lib_torrents"][-1], "wb") as f:
            f.write(raw)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    launches: dict = {}
    results: dict = {}

    async def client(run: str, port: int) -> dict:
        out = os.path.join(d, f"{run}.json")
        with open(os.path.join(d, f"{run}.log"), "w") as logf:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, os.path.abspath(__file__), "--bridge-client", run, "--port", str(port),
                "--spec", os.path.join(d, "spec.json"), "--out", out, stdout=logf, stderr=subprocess.STDOUT,
            )
            try:
                rc = await asyncio.wait_for(proc.wait(), BRIDGE_CLIENT_S)
            except asyncio.TimeoutError:
                proc.kill()
                await proc.wait()
                rc = "timeout"
        if rc != 0:
            with open(os.path.join(d, f"{run}.log")) as f:
                log(f"  bridge client {run} (rc {rc}) log tail:\n{f.read()[-4000:]}")
            raise SmokeFailure(f"phase 9: bridge client {run} exited {rc}")
        with open(out) as f:
            return json.load(f)

    async def go():
        t = time.perf_counter()
        svc = await BridgeServer(hasher="gpu", slo=True, timeline_interval_s=0.25).start()
        start_s = time.perf_counter() - t
        try:
            # the bridge path: counts 0 just before it, read just after
            sha1_k.launches = sha256_k.launches = 0
            for run in ("stream_verify", "stream_sha256", "tenants", "fabric"):
                before = (sha1_k.launches, sha256_k.launches)
                if run == "stream_verify":
                    flip_byte(single, BRIDGE_FLIP * PIECE + 777)
                try:
                    results[run] = await client(run, svc.port)
                finally:
                    if run == "stream_verify":
                        flip_byte(single, BRIDGE_FLIP * PIECE + 777)
                launches[run] = (sha1_k.launches - before[0], sha256_k.launches - before[1])
            path_launches = (sha1_k.launches, sha256_k.launches)
            results["routes"] = await client("routes", svc.port)
            hist = histograms().get(*_H_REQUEST, route="/v1/verify").snapshot()
        finally:
            svc.close()
            await svc.wait_closed()
        return svc, start_s, path_launches, hist

    svc, start_s, path_launches, hist = asyncio.run(go())
    snap = svc.sched.metrics_snapshot()
    reuse = svc.sched.staging_reuse()
    check(results["stream_verify"]["false"] == [BRIDGE_FLIP], f"run 1: hashlib flags {results['stream_verify']['false']}")
    check(results["stream_verify"]["trace_id"] == "smoke-run1", "run 1: the X-Trace-Id was not echoed")
    check(launches["stream_verify"][0] > 0 and launches["stream_sha256"][1] > 0, f"phase 9: launches {launches}")
    check(0 < launches["tenants"][0] < results["tenants"]["requests"],
          f"run 3: {launches['tenants'][0]} sha1 launches for {results['tenants']['requests']} requests (no coalescing)")
    check(launches["fabric"][0] > 0, f"run 4: launches {launches['fabric']}")
    check(path_launches[0] > 0 and path_launches[1] > 0, f"phase 9: kernels launched {path_launches} times")
    check(snap["cpu_fallback_launches"] == 0, f"phase 9: {snap['cpu_fallback_launches']} cpu fallback launches")
    check(snap["launch_failures"] == 0, f"phase 9: {snap['launch_failures']} launch failures")
    states = {k: b["state"] for k, b in snap["breakers"].items()}
    check(all(st == "closed" for st in states.values()), f"phase 9: breakers {states}")
    check(snap["staging"]["outstanding"] == 0, f"phase 9: {snap['staging']['outstanding']} ingest slabs outstanding")
    check(reuse["outstanding"] == 0 and reuse["early_checkins"] == 0, f"phase 9: staging reuse {reuse}")

    # the direct call of run 2's work: the same leaves through a scheduler
    # of this process, warmed as the bridge's was
    with open(single, "rb") as f:
        blob = f.read(STREAM_LEAVES * LEAF)
    leaves = [blob[i : i + LEAF] for i in range(0, len(blob), LEAF)]
    del blob

    async def direct():
        sched = await HashPlaneScheduler(hasher="gpu").start()
        await sched.prewarm("sha256", LEAF)
        chunk = sched.chunk_for(LEAF, "sha256")
        try:
            t0 = time.perf_counter()
            parts = await asyncio.gather(*(
                sched.submit("direct", leaves[s : s + chunk], algo="sha256", piece_length=LEAF, wait=True)
                for s in range(0, len(leaves), chunk)
            ))
            return time.perf_counter() - t0, [x for part in parts for x in part]
        finally:
            await sched.close()

    direct_s, got = asyncio.run(direct())
    check(got == [hashlib.sha256(x).digest() for x in leaves], "phase 9: the direct sha256 call differs from hashlib")
    del leaves, got
    torch.cuda.synchronize()

    r1, r2, r3, r4, r5 = (results[k] for k in ("stream_verify", "stream_sha256", "tenants", "fabric", "routes"))
    log(
        f"phase 9: bridge on the card (slo armed, timeline every 0.25 s) served a separate client process "
        f"(no torch imported): run 1 stream/verify ok == hashlib (piece {BRIDGE_FLIP} flagged, valid "
        f"{r1['valid']}, failed {r1['failed']}); run 2 stream/digests sha256 == hashlib; run 3 "
        f"{r3['requests']} /v1/verify requests from {BRIDGE_TENANTS} tenants == hashlib in "
        f"{launches['tenants'][0]} sha1 launches; run 4 fabric valid {r4['valid']} of {r4['pieces']}; "
        f"routes: health {r5['health']}, slo no breach, timeline {r5['timeline_samples']} samples, run 1's trace "
        f"{r5['trace_spans']} spans kept ({r5['trace_dropped']} dropped past the cap) {r5['trace_names']}, "
        f"{r5['metric_families']} metric families; no cpu fallback, no launch "
        f"failure, breakers closed, staging drained"
    )
    log(f"phase 9: bridge path launches sha1_cuda {path_launches[0]} sha256_cuda {path_launches[1]}; per run {launches}")
    b = baselines
    log(
        f"time: bridge start s={start_s:.3f} (scheduler, prewarmed sha1/256 KiB and sha256/16 KiB lanes, "
        f"timeline sampler) {card}"
    )
    log(
        f"time: bridge run 1 stream/verify 2 GiB ({r1['frames']} x 256 KiB frames, chunked) wall s={r1['wall_s']:.3f} "
        f"pieces/s={r1['frames'] / r1['wall_s']:.1f} GiB/s={r1['bytes'] / r1['wall_s'] / 2**30:.3f} "
        f"sha1_cuda launches={launches['stream_verify'][0]}; direct verify_pieces (phase 4, warm) s={b['v1_s']:.3f} "
        f"pieces/s={r1['frames'] / b['v1_s']:.1f}; hashlib (phase 4) s={b['v1_hashlib_s']:.3f} "
        f"pieces/s={r1['frames'] / b['v1_hashlib_s']:.1f} {card}"
    )
    log(
        f"time: bridge run 2 stream/digests sha256 512 MiB ({r2['frames']} x 16 KiB frames, chunked) wall "
        f"s={r2['wall_s']:.3f} leaves/s={r2['frames'] / r2['wall_s']:.1f} GiB/s={r2['bytes'] / r2['wall_s'] / 2**30:.3f} "
        f"sha256_cuda launches={launches['stream_sha256'][1]}; direct sched.submit s={direct_s:.3f} "
        f"leaves/s={r2['frames'] / direct_s:.1f}; hashlib (client) s={r2['hashlib_s']:.3f} "
        f"leaves/s={r2['frames'] / r2['hashlib_s']:.1f} {card}"
    )
    log(
        f"time: bridge run 3 {BRIDGE_TENANTS} tenants x {BRIDGE_WAVES} waves of /v1/verify ({BRIDGE_PIECES} x 256 KiB) "
        f"wall s={r3['wall_s']:.3f} requests/s={r3['requests'] / r3['wall_s']:.2f} pieces/s={r3['pieces'] / r3['wall_s']:.1f}; "
        f"torrent_tpu_bridge_request_seconds route=/v1/verify n={hist[1]} p50<={_bucket_quantile(hist[0], 0.5)} "
        f"p99<={_bucket_quantile(hist[0], 0.99)} s (log2 bucket bounds) mean s={hist[2] / max(1, hist[1]):.4f}; "
        f"client p50 s={r3['client_p50_s']:.4f} p99 s={r3['client_p99_s']:.4f} (the slowest TCP connect of its "
        f"{r3['connects']} s={r3['connect_max_s']:.4f}); sha1_cuda launches="
        f"{launches['tenants'][0]} for {r3['requests']} requests {card}"
    )
    log(
        f"time: bridge run 4 fabric/verify 2 x 1 GiB ({r4['pieces']} pieces) wall s={r4['wall_s']:.3f} "
        f"(server s={r4['server_ms'] / 1e3:.3f}, {r4['polls']} polls, slowest connect s={r4['connect_max_s']:.4f}) pieces/s={r4['pieces'] / r4['wall_s']:.1f} "
        f"GiB/s={b['lib_bytes'] / r4['wall_s'] / 2**30:.3f} sha1_cuda launches={launches['fabric'][0]}; direct "
        f"verify_library_sched (phase 7) s={b['lib_s']:.3f} pieces/s={r4['pieces'] / b['lib_s']:.1f}; hashlib "
        f"(phase 7) s={b['lib_hashlib_s']:.3f} pieces/s={r4['pieces'] / b['lib_hashlib_s']:.1f} {card}"
    )
    log(
        f"time: bridge sched launches={snap['launches']} mean_fill={snap['mean_fill']:.4f} "
        f"flush_reasons={snap['flush_reasons']} lanes="
        f"{ {k: (v['target'], v['launches'], round(v['mean_fill'], 4)) for k, v in snap['lane_stats'].items()} } "
        f"staging slots allocated={reuse['slots_allocated']} in s={reuse['alloc_s']:.4f}; /v1/pipeline "
        f"bottleneck={r5['bottleneck']} (utilization {r5['utilization']}) {card}"
    )
    return {"sha1_cuda": path_launches[0], "sha256_cuda": path_launches[1]}


SESSION_WAIT_S = 600  # the longest a phase-10 transfer may take
SESSION_LIB = 1  # phase 7's library torrent whose first SESSION_BYTES the swarm moves
SESSION_BYTES = 512 << 20  # 2048 pieces of 256 KiB: the 1 GiB torrent cut in depth to make room for phase 16
SESSION_FLIP = 77  # the piece of the flipped-byte ingest batch
SESSION_BATCH = 256  # TorrentConfig.verify_batch_size's default: one ingest batch
PIECE_SIZED = 16 * 1024  # a hashlib input this long or longer is a piece, not a key


class CountingHashlib:
    """Stands in for a session module's ``hashlib``: counts piece-sized
    SHA-1 inputs (phases 10 and 11 require none on the card's path)."""

    def __init__(self):
        self.piece_sized = 0

    def sha1(self, data=b"", *args, **kwargs):
        if len(data) >= PIECE_SIZED:
            self.piece_sized += 1
        return hashlib.sha1(data, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(hashlib, name)


def counting(ingest: dict, real):
    """Wraps a ``Torrent`` ingest verify: flushes, pieces and seconds per
    torrent in ``ingest[id(torrent)]`` (the smoke's instrument around the
    package, never inside it)."""

    def wrapper(self, pieces, expected):
        c = ingest.setdefault(id(self), [0, 0, 0.0])
        c[0] += 1
        c[1] += len(pieces)
        t0 = time.perf_counter()
        try:
            return real(self, pieces, expected)
        finally:
            c[2] += time.perf_counter() - t0

    return wrapper


class KernelCounts:
    """The launch counts of a path: each kernel wrapper's ``launches``,
    and the calls of the plain versions the wrappers run on a CPU tensor
    (CPU-fallback launches), counted by wrappers ``install`` puts in the
    ops modules and ``uninstall`` removes (phases 11 and 12)."""

    PLAIN = (("sha1_cuda", "sha1_pieces_torch"), ("sha256_cuda", "sha256_pieces_torch"),
             ("sha256_cuda", "sha256_merkle_torch"), ("sha256_cuda", "sha256_pairs_torch"))

    def install(self) -> "KernelCounts":
        from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda

        mods = {"sha1_cuda": sha1_cuda, "sha256_cuda": sha256_cuda}
        self.kernels = {
            "sha1_cuda": sha1_cuda.sha1_pieces_cuda,
            "sha256_cuda": sha256_cuda.sha256_pieces_cuda,
            "sha256_merkle_cuda": sha256_cuda.sha256_merkle_cuda,
        }
        self.fallbacks = 0
        self.originals = [(mods[m], name, getattr(mods[m], name)) for m, name in self.PLAIN]
        for mod, name, real in self.originals:
            setattr(mod, name, self._counting(real))
        return self

    def _counting(self, real):
        def wrapper(*args, **kwargs):
            self.fallbacks += 1
            return real(*args, **kwargs)

        return wrapper

    def uninstall(self) -> None:
        for mod, name, real in self.originals:
            setattr(mod, name, real)

    def reset(self) -> None:
        for k in self.kernels.values():
            k.launches = 0
        self.fallbacks = 0

    def counts(self) -> dict:
        return {**{name: k.launches for name, k in self.kernels.items()}, "cpu_fallback": self.fallbacks}


def session_phase(tmp: str, lib_torrents: list, v2_meta, card: str) -> dict:
    """Phase 10: the BitTorrent session on the card (see the module
    docstring). Returns each sub-path's launches per kernel."""
    import asyncio
    import filecmp

    from torrent_tpu_torch.codec.bencode import bdecode, bencode
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2, parse_metainfo_v2
    from torrent_tpu_torch.models import merkle
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
    from torrent_tpu_torch.server.in_memory import run_tracker
    from torrent_tpu_torch.server.tracker import ServeOptions
    from torrent_tpu_torch.session import torrent as torrent_mod
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig, TorrentState
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    kernels = {
        "sha1_cuda": sha1_cuda.sha1_pieces_cuda,
        "sha256_cuda": sha256_cuda.sha256_pieces_cuda,
        "sha256_merkle_cuda": sha256_cuda.sha256_merkle_cuda,
    }

    def reset() -> None:
        for k in kernels.values():
            k.launches = 0

    def counts() -> dict:
        return {name: k.launches for name, k in kernels.items()}

    lib_root = os.path.join(tmp, "library")
    d = os.path.join(tmp, "session")
    dirs = {name: os.path.join(d, name) for name in ("seed", "gpu", "cpu", "v2")}
    for p in dirs.values():
        os.makedirs(p)

    # the smoke's own instruments around the package (never inside it):
    # pieces and flushes through each ingest verify, per torrent; host
    # folds of v2 tail pieces; piece-sized hashlib inputs in the session
    ingest: dict = {}
    host_folds = [0]
    real_v1, real_v2 = Torrent._verify_batch_device, Torrent._verify_batch_device_v2
    real_fold = merkle.piece_root_cpu

    def counting_fold(data, pad):
        host_folds[0] += 1
        return real_fold(data, pad)

    # the transfers wait on loopback TCP, not a timer: only the choke
    # round and the announce retry are shortened, as the session tests do
    def config(**kw) -> ClientConfig:
        return ClientConfig(
            host="127.0.0.1", torrent=TorrentConfig(choke_interval=0.15, announce_retry=1.0), **kw
        )

    out: dict = {"launches": {}}

    async def go():
        server, pump = await run_tracker(
            ServeOptions(http_port=0, udp_port=None, host="127.0.0.1", interval=2)
        )
        url = f"http://127.0.0.1:{server.http_port}/announce"
        # the library torrent's first SESSION_BYTES: its pieces are whole,
        # so the first digests are this file's
        raw = bdecode(lib_torrents[SESSION_LIB])
        raw[b"announce"] = url.encode()
        raw[b"info"][b"length"] = SESSION_BYTES
        raw[b"info"][b"pieces"] = raw[b"info"][b"pieces"][: 20 * (SESSION_BYTES // PIECE)]
        meta = parse_metainfo(bencode(raw))
        n = meta.info.num_pieces
        check(n == SESSION_BYTES // PIECE, f"the session torrent has {n} pieces")
        name = meta.info.name
        with open(os.path.join(lib_root, name), "rb") as src, open(os.path.join(dirs["seed"], name), "wb") as dst:
            left = SESSION_BYTES
            while left:
                chunk = src.read(min(left, 64 << 20))
                dst.write(chunk)
                left -= len(chunk)
        clients = []

        async def started(cfg) -> Client:
            c = Client(cfg)
            clients.append(c)
            await c.start()
            return c

        async def download(client, metainfo, where) -> tuple:
            t0 = time.perf_counter()
            torrent = await client.add(metainfo, where)
            await asyncio.wait_for(torrent.on_complete.wait(), SESSION_WAIT_S)
            return torrent, time.perf_counter() - t0

        try:
            # -- seed: a recheck on the card through GPUVerifier.verify_storage
            seed = await started(config(hasher="gpu"))
            reset()
            t0 = time.perf_counter()
            ts = await seed.add(meta, dirs["seed"])
            out["seed_recheck_s"] = time.perf_counter() - t0
            out["launches"]["seed recheck"] = counts()
            check(ts.state == TorrentState.SEEDING and ts.bitfield.count() == n,
                  f"seed: {ts.state} with {ts.bitfield.count()}/{n} pieces")
            check(ts.verifier is not None and ts.verifier.last_result is not None
                  and ts.verifier.last_result.n_valid == n, "seed: the recheck did not run GPUVerifier.verify_storage")
            check(out["launches"]["seed recheck"]["sha1_cuda"] > 0, "seed: the recheck launched no SHA-1 kernel")

            # -- leech on the card: every finished piece through the SHA-1 kernel
            leech = await started(config(hasher="gpu"))
            proxy = CountingHashlib()
            Torrent._verify_batch_device = counting(ingest, real_v1)
            torrent_mod.hashlib = proxy
            reset()
            try:
                tl, out["gpu_wall_s"] = await download(leech, meta, dirs["gpu"])
            finally:
                Torrent._verify_batch_device = real_v1
                torrent_mod.hashlib = hashlib
            out["launches"]["gpu download"] = counts()
            flushes, pieces, out["gpu_flush_s"] = ingest.get(id(tl), [0, 0, 0.0])
            out["gpu_flushes"], out["gpu_pieces"] = flushes, pieces
            check(pieces >= n, f"leech: {pieces} pieces went through _verify_batch_device, fewer than {n}")
            check(proxy.piece_sized == 0, f"leech: {proxy.piece_sized} piece-sized hashlib inputs in the session")
            check(out["launches"]["gpu download"]["sha1_cuda"] > 0, "leech: ingest launched no SHA-1 kernel")
            batch = [tl.storage.read_piece(i) for i in range(SESSION_BATCH)]
            bad = bytearray(batch[SESSION_FLIP])
            bad[12_345] ^= 0x10
            batch[SESSION_FLIP] = bytes(bad)
            ok = await asyncio.to_thread(tl._verify_batch_device, batch, list(meta.info.pieces[:SESSION_BATCH]))
            check(list(np.nonzero(~np.asarray(ok))[0]) == [SESSION_FLIP],
                  f"flipped batch: _verify_batch_device flags {list(np.nonzero(~np.asarray(ok))[0])}")
            await leech.close()
            fresh = await asyncio.to_thread(
                verify_pieces, Storage(FsStorage(dirs["gpu"]), meta.info), meta.info, "cpu"
            )
            check(fresh.all(), f"leech: a fresh hashlib recheck fails {int((~fresh).sum())} pieces")

            # -- the same download with hashlib, in the same call
            cpu_leech = await started(config(hasher="cpu"))
            tc, out["cpu_wall_s"] = await download(cpu_leech, meta, dirs["cpu"])
            check(tc.bitfield.complete, "hashlib leech: incomplete")
            await cpu_leech.close()
            check(filecmp.cmp(os.path.join(dirs["cpu"], name), os.path.join(dirs["seed"], name), shallow=False),
                  "hashlib leech: bytes differ from the seed's")

            # -- restart on the leech's files: a recheck through the scheduler
            sched = await HashPlaneScheduler(SchedulerConfig(), hasher="gpu").start()
            try:
                restart = await started(config(hasher="gpu", scheduler=sched, resume=False))
                reset()
                t0 = time.perf_counter()
                tr = await restart.add(meta, dirs["gpu"])
                out["restart_recheck_s"] = time.perf_counter() - t0
                out["launches"]["restart recheck"] = counts()
                check(tr.state == TorrentState.SEEDING and tr.bitfield.complete and tr.downloaded == 0,
                      f"restart: {tr.state}, {tr.bitfield.count()}/{n} pieces, {tr.downloaded} bytes downloaded")
                snap = sched.metrics_snapshot()
                out["restart_sched_launches"] = snap["launches"]
                check(snap["tenants"]["selfheal"]["served_pieces"] == n,
                      f"restart: the selfheal tenant served {snap['tenants']['selfheal']['served_pieces']} pieces")
                check(snap["cpu_fallback_launches"] == 0 and snap["launch_failures"] == 0,
                      f"restart: {snap['cpu_fallback_launches']} cpu fallback launches, {snap['launch_failures']} failures")
                check(out["launches"]["restart recheck"]["sha1_cuda"] > 0, "restart: no SHA-1 launch")
                await restart.close()
            finally:
                await sched.close()
            staging = sched.metrics_snapshot()["staging"]["outstanding"]
            check(staging == 0, f"restart: {staging} staging slabs outstanding after close")

            # -- v2: a BEP 52 seed and leech of phase 5's 6 files at 1 MiB pieces
            m2 = parse_metainfo_v2(encode_metainfo_v2(v2_meta.info, v2_meta.piece_layers, url))
            v2_seed = await started(config(hasher="gpu"))
            t2s = await v2_seed.add(m2, tmp)
            check(t2s.state == TorrentState.SEEDING, f"v2 seed: {t2s.state}")
            v2_leech = await started(config(hasher="gpu"))
            Torrent._verify_batch_device_v2 = counting(ingest, real_v2)
            merkle.piece_root_cpu = counting_fold
            reset()
            try:
                t2l, out["v2_wall_s"] = await download(v2_leech, m2, dirs["v2"])
            finally:
                Torrent._verify_batch_device_v2 = real_v2
                merkle.piece_root_cpu = real_fold
            out["launches"]["v2 download"] = counts()
            out["v2_flushes"], out["v2_device_pieces"], out["v2_flush_s"] = ingest.get(id(t2l), [0, 0, 0.0])
            out["v2_host_pieces"] = host_folds[0]
            out["v2_pieces"] = t2l.info.num_pieces
            for rel, _ in MULTI_FILES:
                check(filecmp.cmp(os.path.join(dirs["v2"], v2_meta.info.name, rel),
                                  os.path.join(tmp, v2_meta.info.name, rel), shallow=False),
                      f"v2 leech: {rel} differs from the seed's")
            check(out["launches"]["v2 download"]["sha256_cuda"] > 0 and out["launches"]["v2 download"]["sha256_merkle_cuda"] > 0,
                  f"v2 leech: launches {out['launches']['v2 download']}")
            check(out["v2_device_pieces"] + out["v2_host_pieces"] >= out["v2_pieces"],
                  f"v2 leech: {out['v2_device_pieces']} + {out['v2_host_pieces']} pieces verified of {out['v2_pieces']}")
        finally:
            for c in clients:
                await c.close()
            server.close()
            await asyncio.wait_for(pump, 10)
        pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task() and not t.done()]
        check(not pending, f"tasks left pending: {[t.get_name() for t in pending]}")

    asyncio.run(go())
    mib = SESSION_BYTES / 2**20
    size = f"{mib:.0f} MiB ({SESSION_BYTES // PIECE} x {PIECE >> 10} KiB)"
    log(
        f"time: session seed recheck of {size} (GPUVerifier.verify_storage) "
        f"s={out['seed_recheck_s']:.3f} sha1_cuda launches={out['launches']['seed recheck']['sha1_cuda']} {card}"
    )
    log(
        f"time: session download {size} over loopback TCP gpu wall s={out['gpu_wall_s']:.3f} "
        f"MiB/s={mib / out['gpu_wall_s']:.1f}; hashlib wall s={out['cpu_wall_s']:.3f} "
        f"MiB/s={mib / out['cpu_wall_s']:.1f}; gpu/hashlib wall ratio={out['gpu_wall_s'] / out['cpu_wall_s']:.3f}; "
        f"ingest flushes={out['gpu_flushes']} pieces={out['gpu_pieces']} "
        f"mean pieces a flush={out['gpu_pieces'] / max(1, out['gpu_flushes']):.2f} "
        f"seconds in _verify_batch_device={out['gpu_flush_s']:.3f} "
        f"(ms a flush={1e3 * out['gpu_flush_s'] / max(1, out['gpu_flushes']):.2f}) "
        f"sha1_cuda launches={out['launches']['gpu download']['sha1_cuda']} {card}"
    )
    log(
        f"time: session restart recheck through the scheduler (selfheal) s={out['restart_recheck_s']:.3f} "
        f"scheduler launches={out['restart_sched_launches']} "
        f"sha1_cuda launches={out['launches']['restart recheck']['sha1_cuda']} {card}"
    )
    log(
        f"time: session v2 transfer of {sum(s for _, s in MULTI_FILES)} bytes at 1 MiB pieces wall s={out['v2_wall_s']:.3f} "
        f"MiB/s={sum(s for _, s in MULTI_FILES) / 2**20 / out['v2_wall_s']:.1f}; {out['v2_pieces']} pieces: "
        f"{out['v2_device_pieces']} through _verify_batch_device_v2 in {out['v2_flushes']} flushes "
        f"(ms a flush={1e3 * out['v2_flush_s'] / max(1, out['v2_flushes']):.2f}), "
        f"{out['v2_host_pieces']} tail pieces folded on the host; launches {out['launches']['v2 download']} {card}"
    )
    log(
        f"phase 10: session seed rechecked {SESSION_BYTES // PIECE} pieces on the card, the leech ingested "
        f"{out['gpu_pieces']} pieces through the SHA-1 kernel (hashlib recheck all True, no piece-sized hashlib "
        f"input), the flipped batch flagged piece {SESSION_FLIP} alone, the restart rechecked through the "
        f"scheduler, the v2 leech's files equal the seed's"
    )
    return out["launches"]


# ---------------------------------------------------------------- phase 11

MAGNET_BYTES = 256 << 20  # 11a's file: 1024 pieces of 256 KiB (phase 10's 1 GiB cut in depth)
MAGNET_WAIT_S = 600  # the longest a phase-11 transfer may take
MAGNET_TRIES = 120  # add_magnet attempts, 0.25 s apart, while the seed's DHT announce propagates
MAGNET_SEED_KEY = 46  # the generator seed of 11c's ed25519 key


def magnet_phase(tmp: str, v2_meta, rng, card: str) -> dict:
    """Phase 11: joining a swarm from a magnet on the card, found through
    a loopback DHT and carried over uTP (see the module docstring).
    Returns each sub-path's launches per kernel."""
    import asyncio
    import filecmp

    from torrent_tpu_torch.codec.magnet import Magnet, mutable_magnet_uri
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2, parse_metainfo_v2
    from torrent_tpu_torch.models import merkle
    from torrent_tpu_torch.net import extension as ext
    from torrent_tpu_torch.net.dht import DHTNode
    from torrent_tpu_torch.net.utp import _UtpWriter
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.session import torrent as torrent_mod
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.session.metadata import MetadataError
    from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig, TorrentState
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent
    from torrent_tpu_torch.utils import ed25519

    launch_counts = KernelCounts().install()
    reset, counts = launch_counts.reset, launch_counts.counts

    d = os.path.join(tmp, "magnet")
    src = os.path.join(d, "src")
    dirs = {name: os.path.join(d, name) for name in ("gpu", "cpu", "v2")}
    for p in (src, *dirs.values()):
        os.makedirs(p)
    payload = os.path.join(src, "magnet.bin")
    write_random(payload, MAGNET_BYTES, rng)
    t0 = time.perf_counter()
    meta = parse_metainfo(make_torrent(payload, "", piece_length=PIECE, hasher="gpu"))
    author_s = time.perf_counter() - t0
    n = meta.info.num_pieces
    check(n == MAGNET_BYTES // PIECE and meta.announce == "", f"11a torrent: {n} pieces, announce {meta.announce!r}")

    # the smoke's own instruments around the package, as phase 10's
    ingest: dict = {}
    host_folds = [0]
    first_meta = [None]
    real_v1, real_v2 = Torrent._verify_batch_device, Torrent._verify_batch_device_v2
    real_fold = merkle.piece_root_cpu
    real_add = ext.MetadataAssembler.add

    def counting_fold(data, pad):
        host_folds[0] += 1
        return real_fold(data, pad)

    def first_byte(self, msg):
        if first_meta[0] is None:
            first_meta[0] = time.perf_counter()
        return real_add(self, msg)

    out: dict = {"launches": {}, "author_s": author_s}

    async def go():
        boot = await DHTNode(host="127.0.0.1").start()
        clients = []

        # phase 10's TorrentConfig (0.15 s choke round, 1 s announce
        # retry) with the DHT re-announced every 0.5 s, uTP on
        def config(**kw) -> ClientConfig:
            return ClientConfig(
                host="127.0.0.1", enable_dht=True, dht_bootstrap=(("127.0.0.1", boot.port),), enable_utp=True,
                torrent=TorrentConfig(choke_interval=0.15, announce_retry=1.0, dht_interval=0.5), **kw,
            )

        async def started(cfg) -> Client:
            c = Client(cfg)
            clients.append(c)
            await c.start()
            return c

        async def join(client, magnet, where) -> tuple:
            """add_magnet, retried while the DHT has no peer for the hash;
            returns the torrent, the seconds to the first metadata byte and
            to the registration, the download wall from the first call, the
            MetadataErrors seen and the peers' writer types seen."""
            first_meta[0] = None
            tries = 0
            ext.MetadataAssembler.add = first_byte
            t1 = time.perf_counter()
            try:
                while True:
                    tries += 1
                    try:
                        torrent = await client.add_magnet(magnet, where)
                        break
                    except MetadataError:
                        check(tries < MAGNET_TRIES, f"add_magnet found no peer in {tries} tries")
                        await asyncio.sleep(0.25)
            finally:
                ext.MetadataAssembler.add = real_add
            registered = time.perf_counter() - t1
            check(first_meta[0] is not None, "add_magnet returned with no metadata byte read")
            writers: set = set()
            deadline = time.perf_counter() + MAGNET_WAIT_S
            while not torrent.bitfield.complete:
                check(time.perf_counter() < deadline, f"download incomplete after {MAGNET_WAIT_S} s: {torrent.status()}")
                writers.update(type(p.writer) for p in torrent.peers.values())
                await asyncio.sleep(0.05)
            wall = time.perf_counter() - t1
            writers.update(type(p.writer) for p in torrent.peers.values())
            return torrent, first_meta[0] - t1, registered, wall, tries - 1, writers

        try:
            # -- 11a: a hash-only v1 magnet, found through the DHT, over uTP
            seed = await started(config(hasher="gpu"))
            reset()
            t1 = time.perf_counter()
            ts = await seed.add(meta, src)
            out["seed_recheck_s"] = time.perf_counter() - t1
            out["launches"]["seed recheck"] = counts()
            check(ts.state == TorrentState.SEEDING and ts.bitfield.count() == n,
                  f"11a seed: {ts.state} with {ts.bitfield.count()}/{n} pieces")
            check(ts.verifier is not None and ts.verifier.last_result is not None
                  and ts.verifier.last_result.n_valid == n, "11a seed: the recheck did not run GPUVerifier.verify_storage")
            check(out["launches"]["seed recheck"]["sha1_cuda"] > 0, "11a seed: the recheck launched no SHA-1 kernel")
            magnet = Magnet(info_hash=meta.info_hash)
            check(not magnet.trackers and not magnet.peer_addrs, "11a: the magnet is not hash-only")

            leech = await started(config(hasher="gpu"))
            proxy = CountingHashlib()
            Torrent._verify_batch_device = counting(ingest, real_v1)
            torrent_mod.hashlib = proxy
            reset()
            try:
                tl, out["meta_s"], out["registered_s"], out["gpu_wall_s"], out["meta_retries"], writers = await join(
                    leech, magnet, dirs["gpu"]
                )
            finally:
                Torrent._verify_batch_device = real_v1
                torrent_mod.hashlib = hashlib
            out["launches"]["gpu download"] = counts()
            out["gpu_writers"] = sorted(w.__name__ for w in writers)
            check(writers and all(w is _UtpWriter for w in writers),
                  f"11a leech: peer writers {out['gpu_writers']}, not all _UtpWriter")
            flushes, pieces, out["gpu_flush_s"] = ingest.get(id(tl), [0, 0, 0.0])
            out["gpu_flushes"], out["gpu_pieces"] = flushes, pieces
            check(pieces >= n, f"11a leech: {pieces} pieces went through _verify_batch_device, fewer than {n}")
            check(proxy.piece_sized == 0, f"11a leech: {proxy.piece_sized} piece-sized hashlib inputs in the session")
            got = out["launches"]["gpu download"]
            check(got["sha1_cuda"] > 0 and got["cpu_fallback"] == 0, f"11a leech: launches {got}")
            await leech.close()
            fresh = await asyncio.to_thread(
                verify_pieces, Storage(FsStorage(dirs["gpu"]), meta.info), meta.info, "cpu"
            )
            check(fresh.all(), f"11a leech: a fresh hashlib recheck fails {int((~fresh).sum())} pieces")

            cpu_leech = await started(config(hasher="cpu"))
            tc, out["cpu_meta_s"], _, out["cpu_wall_s"], _, cpu_writers = await join(cpu_leech, magnet, dirs["cpu"])
            out["cpu_writers"] = sorted(w.__name__ for w in cpu_writers)
            await cpu_leech.close()
            check(filecmp.cmp(os.path.join(dirs["cpu"], meta.info.name), payload, shallow=False),
                  "11a hashlib leech: bytes differ from the seed's")

            # -- 11b: a pure-v2 (btmh) magnet, the seed in x.pe
            m2 = parse_metainfo_v2(encode_metainfo_v2(v2_meta.info, v2_meta.piece_layers, ""))
            v2_seed = await started(config(hasher="gpu"))
            t2s = await v2_seed.add(m2, tmp)
            check(t2s.state == TorrentState.SEEDING, f"11b v2 seed: {t2s.state}")
            v2_leech = await started(config(hasher="gpu"))
            Torrent._verify_batch_device_v2 = counting(ingest, real_v2)
            merkle.piece_root_cpu = counting_fold
            host_folds[0] = 0
            reset()
            try:
                t2l, out["v2_meta_s"], _, out["v2_wall_s"], _, v2_writers = await join(
                    v2_leech, Magnet(info_hash_v2=m2.info_hash_v2, peer_addrs=(("127.0.0.1", v2_seed.port),)), dirs["v2"]
                )
            finally:
                Torrent._verify_batch_device_v2 = real_v2
                merkle.piece_root_cpu = real_fold
            out["launches"]["v2 download"] = counts()
            out["v2_writers"] = sorted(w.__name__ for w in v2_writers)
            out["v2_flushes"], out["v2_device_pieces"], out["v2_flush_s"] = ingest.get(id(t2l), [0, 0, 0.0])
            out["v2_host_pieces"] = host_folds[0]
            out["v2_pieces"] = t2l.info.num_pieces
            for rel, _ in MULTI_FILES:
                check(filecmp.cmp(os.path.join(dirs["v2"], v2_meta.info.name, rel),
                                  os.path.join(tmp, v2_meta.info.name, rel), shallow=False),
                      f"11b v2 leech: {rel} differs from the seed's")
            got = out["launches"]["v2 download"]
            check(got["sha256_cuda"] > 0 and got["sha256_merkle_cuda"] > 0 and got["cpu_fallback"] == 0,
                  f"11b v2 leech: launches {got}")
            check(out["v2_device_pieces"] + out["v2_host_pieces"] >= out["v2_pieces"],
                  f"11b v2 leech: {out['v2_device_pieces']} + {out['v2_host_pieces']} pieces verified of {out['v2_pieces']}")

            # -- 11c: BEP 46, the 11a hash behind a mutable item
            secret = np.random.default_rng(MAGNET_SEED_KEY).bytes(32)
            _, stored = await seed.publish_mutable(secret, meta.info_hash, seq=1)
            check(stored > 0, "11c: the mutable item was stored on no node")
            resolved = await v2_leech.resolve_mutable(mutable_magnet_uri(ed25519.publickey(secret)))
            check(resolved == meta.info_hash, f"11c: resolved {resolved.hex()}, published {meta.info_hash.hex()}")
            out["bep46_stored"] = stored
        finally:
            for c in clients:
                await c.close()
            boot.close()
        await asyncio.sleep(0)
        pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task() and not t.done()]
        check(not pending, f"tasks left pending: {[t.get_name() for t in pending]}")

    t0 = time.perf_counter()
    try:
        asyncio.run(go())
    finally:
        launch_counts.uninstall()
    out["phase_s"] = time.perf_counter() - t0
    mib = MAGNET_BYTES / 2**20
    size = f"{mib:.0f} MiB ({n} x {PIECE >> 10} KiB)"
    v2_mib = sum(s for _, s in MULTI_FILES) / 2**20
    log(
        f"time: magnet 11a authoring of {size} (make_torrent, hasher gpu) s={out['author_s']:.3f}; "
        f"seed recheck (GPUVerifier.verify_storage) s={out['seed_recheck_s']:.3f} "
        f"sha1_cuda launches={out['launches']['seed recheck']['sha1_cuda']} {card}"
    )
    log(
        f"time: magnet 11a hash-only magnet via the DHT: add_magnet to the first metadata byte s={out['meta_s']:.3f}, "
        f"to the registration s={out['registered_s']:.3f} ({out['meta_retries']} MetadataError retries); "
        f"hashlib leech: to the first metadata byte s={out['cpu_meta_s']:.3f} {card}"
    )
    log(
        f"time: magnet 11a download {size} over uTP gpu wall s={out['gpu_wall_s']:.3f} "
        f"MiB/s={mib / out['gpu_wall_s']:.1f}; hashlib wall s={out['cpu_wall_s']:.3f} "
        f"MiB/s={mib / out['cpu_wall_s']:.1f}; gpu/hashlib wall ratio={out['gpu_wall_s'] / out['cpu_wall_s']:.3f}; "
        f"ingest flushes={out['gpu_flushes']} pieces={out['gpu_pieces']} "
        f"mean pieces a flush={out['gpu_pieces'] / max(1, out['gpu_flushes']):.2f} "
        f"seconds in _verify_batch_device={out['gpu_flush_s']:.3f} "
        f"(ms a flush={1e3 * out['gpu_flush_s'] / max(1, out['gpu_flushes']):.2f}) "
        f"sha1_cuda launches={out['launches']['gpu download']['sha1_cuda']} "
        f"cpu fallback launches={out['launches']['gpu download']['cpu_fallback']}; "
        f"writers gpu {out['gpu_writers']} hashlib {out['cpu_writers']} {card}"
    )
    log(
        f"time: magnet 11b btmh magnet of {sum(s for _, s in MULTI_FILES)} bytes at 1 MiB pieces "
        f"to the first metadata byte s={out['v2_meta_s']:.3f}, wall s={out['v2_wall_s']:.3f} "
        f"MiB/s={v2_mib / out['v2_wall_s']:.1f}; {out['v2_pieces']} pieces: "
        f"{out['v2_device_pieces']} through _verify_batch_device_v2 in {out['v2_flushes']} flushes "
        f"(ms a flush={1e3 * out['v2_flush_s'] / max(1, out['v2_flushes']):.2f}), "
        f"{out['v2_host_pieces']} tail pieces folded on the host; launches {out['launches']['v2 download']}; "
        f"writers {out['v2_writers']} {card}"
    )
    log(f"time: magnet phase 11 wall s={out['phase_s']:.3f} {card}")
    log(
        f"phase 11: a hash-only magnet resolved through the DHT and downloaded over uTP (every writer "
        f"_UtpWriter), {out['gpu_pieces']} pieces through the SHA-1 kernel with no CPU-fallback launch "
        f"(hashlib recheck all True); the btmh magnet's files equal the seed's (SHA-256 and merkle launches); "
        f"BEP 46 resolved the published hash ({out['bep46_stored']} nodes stored it)"
    )
    return out["launches"]


SERVE_BYTES = 256 << 20  # 12a's file: 1024 pieces of 256 KiB, phase 11's width and depth
SERVE_SHARDS = 8  # the sharded store's shards (start_service's default)
SERVE_WAIT_S = 600  # the longest a phase-12 transfer or stream may take
SERVE_RANGE_FROM = 128 << 20  # 12a's first stream request: bytes=128 MiB- (mid-file seek)
NETBENCH_BYTES = 64 << 20  # 12c's payload: 256 pieces of 256 KiB a leech
NETBENCH_LEECHES = 4  # 12c's fanout


def _http_get(port: int, path: str, timeout: float = 30) -> tuple:
    """(status, body) of one GET over loopback (the smoke's own client)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stream_get(port: int, path: str, lo: int, expect) -> dict:
    """One streamed GET from byte ``lo`` (a Range request when lo > 0),
    read as it arrives and compared with ``expect[lo:]``; returns the
    status, the seconds to the response head and to the first body
    byte, the wall, the bytes read and whether they all matched."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_WAIT_S)
    t0 = time.perf_counter()
    try:
        conn.request("GET", path, headers={"Range": f"bytes={lo}-"} if lo else {})
        resp = conn.getresponse()
        head_s = time.perf_counter() - t0
        first_s, got, equal = None, 0, True
        while True:
            chunk = resp.read1(1 << 20)
            if not chunk:
                break
            if first_s is None:
                first_s = time.perf_counter() - t0
            equal = equal and chunk == expect[lo + got : lo + got + len(chunk)]
            got += len(chunk)
        return {"status": resp.status, "head_s": head_s, "first_s": first_s,
                "wall_s": time.perf_counter() - t0, "bytes": got, "equal": equal}
    finally:
        conn.close()


def serving_phase(tmp: str, v2_meta, rng, card: str) -> dict:
    """Phase 12: the tracker deployment and the serving tools on the card
    (see the module docstring). Returns each sub-path's launches."""
    import asyncio

    from torrent_tpu_torch.codec.magnet import Magnet
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2, parse_metainfo_v2
    from torrent_tpu_torch.models import merkle
    from torrent_tpu_torch.net import extension as ext
    from torrent_tpu_torch.parallel.bulk import verify_library_sched
    from torrent_tpu_torch.scenario import canonical_bytes, run_scenario
    from torrent_tpu_torch.scenario.library import SCENARIOS, get
    from torrent_tpu_torch.sched import HashPlaneScheduler
    from torrent_tpu_torch.session import torrent as torrent_mod
    from torrent_tpu_torch.session.client import Client, ClientConfig
    from torrent_tpu_torch.session.torrent import Torrent, TorrentConfig, TorrentState
    from torrent_tpu_torch.tools import netbench
    from torrent_tpu_torch.tools.make_torrent import make_torrent
    from torrent_tpu_torch.tools.serve import start_service
    from torrent_tpu_torch.tools.stream import BoxStreamServer, content_files
    from torrent_tpu_torch.utils.metrics import MetricsServer

    launch_counts = KernelCounts().install()
    reset, counts = launch_counts.reset, launch_counts.counts

    d = os.path.join(tmp, "serving")
    src = os.path.join(d, "src")
    dirs = {name: os.path.join(d, name) for name in ("gpu", "v2")}
    for p in (src, *dirs.values()):
        os.makedirs(p)
    payload_path = os.path.join(src, "serve.bin")
    write_random(payload_path, SERVE_BYTES, rng)
    with open(payload_path, "rb") as f:
        payload = f.read()
    t0 = time.perf_counter()
    meta = parse_metainfo(make_torrent(payload_path, "", piece_length=PIECE, hasher="gpu"))
    out: dict = {"launches": {}, "author_s": time.perf_counter() - t0}
    n = meta.info.num_pieces
    ih = meta.info_hash.hex()
    check(n == SERVE_BYTES // PIECE and meta.announce == "", f"12a torrent: {n} pieces, announce {meta.announce!r}")
    piece_of = {digest: i for i, digest in enumerate(meta.info.pieces)}
    per = NETBENCH_BYTES // PIECE  # 12c's pieces a leech

    # the smoke's own instruments around the package: the ingest flushes
    # and which pieces passed them, the session's hashlib, the first
    # metadata byte, and every read of the leech's storage
    ingest: dict = {}
    verified: set = set()
    served = {"reads": 0, "bytes": 0, "unverified": []}
    host_folds = [0]
    first_meta = [None]
    real_v1, real_v2 = Torrent._verify_batch_device, Torrent._verify_batch_device_v2
    real_fold = merkle.piece_root_cpu
    real_add = ext.MetadataAssembler.add
    counted_v1 = counting(ingest, real_v1)

    def verifying(self, pieces, expected):
        ok = counted_v1(self, pieces, expected)
        verified.update(piece_of[e] for e, good in zip(expected, ok) if good)
        return ok

    def counting_fold(data, pad):
        host_folds[0] += 1
        return real_fold(data, pad)

    def first_byte(self, msg):
        if first_meta[0] is None:
            first_meta[0] = time.perf_counter()
        return real_add(self, msg)

    def checked_reads(storage):
        """Wraps one torrent's ``storage.get``: every range read must lie
        in pieces that already passed ``_verify_batch_device``."""
        real_get = storage.get

        def get(offset, length):
            pieces = range(offset // PIECE, (offset + max(length, 1) - 1) // PIECE + 1)
            missing = [i for i in pieces if i not in verified]
            if missing:
                served["unverified"].append((offset, length, missing[:4]))
            served["reads"] += 1
            served["bytes"] += length
            return real_get(offset, length)

        storage.get = get

    cfg = TorrentConfig(choke_interval=0.15, announce_retry=1.0, dht_interval=0.5)

    async def go():
        handle = await start_service(host="127.0.0.1", http_port=0, udp_port=0, dht_port=0,
                                     shards=SERVE_SHARDS, slo=True, interval=1)
        url = f"http://127.0.0.1:{handle.http_port}/announce"
        clients, servers = [], []

        async def started(**kw) -> Client:
            c = Client(ClientConfig(host="127.0.0.1", torrent=cfg, **kw))
            clients.append(c)
            await c.start()
            return c

        try:
            # -- 12a: a magnet joining through the indexer-fed sharded tracker
            seed = await started(hasher="gpu", enable_dht=True, dht_bootstrap=(("127.0.0.1", handle.dht.port),))
            reset()
            t1 = time.perf_counter()
            ts = await seed.add(meta, src)
            out["seed_recheck_s"] = time.perf_counter() - t1
            out["launches"]["seed recheck"] = counts()
            check(ts.state == TorrentState.SEEDING and ts.bitfield.count() == n,
                  f"12a seed: {ts.state} with {ts.bitfield.count()}/{n} pieces")
            check("announce" not in {task.get_name() for task in ts._tasks}, "12a seed: runs a tracker announce task")
            check(out["launches"]["seed recheck"]["sha1_cuda"] > 0, "12a seed: the recheck launched no SHA-1 kernel")
            t1 = time.perf_counter()
            while handle.store.metrics_snapshot()["indexed"] < 1:
                check(time.perf_counter() - t1 < 60, f"12a: the indexer fed no peer in 60 s: {handle.indexer.snapshot()}")
                await asyncio.sleep(0.1)
            out["indexed_s"] = time.perf_counter() - t1
            scraped = handle.store.scrape([meta.info_hash])[0]
            check(scraped[1] + scraped[3] >= 1, f"12a: the store's scrape shows no peer: {scraped}")

            leech = await started(hasher="gpu")
            metrics = await MetricsServer(leech).start()
            box = await BoxStreamServer(leech).start()
            servers.extend((metrics, box))
            proxy = CountingHashlib()
            Torrent._verify_batch_device = verifying
            torrent_mod.hashlib = proxy
            ext.MetadataAssembler.add = first_byte
            reset()
            try:
                t1 = time.perf_counter()
                tl = await leech.add_magnet(Magnet(info_hash=meta.info_hash, trackers=(url,)), dirs["gpu"])
                out["registered_s"] = time.perf_counter() - t1
                ext.MetadataAssembler.add = real_add
                check(first_meta[0] is not None, "12a: add_magnet returned with no metadata byte read")
                out["meta_s"] = first_meta[0] - t1
                checked_reads(tl.storage)
                done = asyncio.ensure_future(tl.on_complete.wait())
                path = f"/{ih}/0"
                out["range"] = await asyncio.to_thread(_stream_get, box.port, path, SERVE_RANGE_FROM, payload)
                out["whole"] = await asyncio.to_thread(_stream_get, box.port, path, 0, payload)
                await asyncio.wait_for(done, SERVE_WAIT_S)
                out["gpu_wall_s"] = time.perf_counter() - t1
            finally:
                Torrent._verify_batch_device = real_v1
                torrent_mod.hashlib = hashlib
                ext.MetadataAssembler.add = real_add
            out["launches"]["gpu download"] = counts()
            for key, lo in (("range", SERVE_RANGE_FROM), ("whole", 0)):
                r = out[key]
                check(r["status"] == (206 if lo else 200) and r["bytes"] == SERVE_BYTES - lo and r["equal"],
                      f"12a stream {key}: {r}")
            check(not served["unverified"], f"12a: reads of unverified pieces {served['unverified'][:4]}")
            check(served["bytes"] >= 2 * SERVE_BYTES - SERVE_RANGE_FROM, f"12a: the stream read {served['bytes']} bytes")
            flushes, pieces, out["gpu_flush_s"] = ingest.get(id(tl), [0, 0, 0.0])
            out["gpu_flushes"], out["gpu_pieces"] = flushes, pieces
            check(pieces >= n and len(verified) == n,
                  f"12a leech: {pieces} pieces through _verify_batch_device, {len(verified)} of {n} verified")
            check(proxy.piece_sized == 0, f"12a leech: {proxy.piece_sized} piece-sized hashlib inputs in the session")
            got = out["launches"]["gpu download"]
            check(got["sha1_cuda"] >= n and got["cpu_fallback"] == 0, f"12a leech: launches {got}")

            status, body = await asyncio.to_thread(_http_get, metrics.port, "/metrics")
            check(status == 200 and re.search(
                rf'torrent_tpu_torrent_pieces_have{{info_hash="{ih}",[^}}]*}} {n}\n', body.decode()),
                "12a leech /metrics: pieces_have is not the piece count")
            status, body = await asyncio.to_thread(_http_get, metrics.port, "/v1/swarm")
            check(status == 200 and "counts" in json.loads(body), "12a leech /v1/swarm does not parse")
            status, body = await asyncio.to_thread(_http_get, handle.http_port, "/metrics")
            text = body.decode()
            announces = int(re.search(r"^torrent_tpu_tracker_announces_total (\d+)$", text, re.M).group(1))
            indexed = int(re.search(r"^torrent_tpu_tracker_indexed_total (\d+)$", text, re.M).group(1))
            check(status == 200 and announces >= 1 and indexed >= 1
                  and "torrent_tpu_tracker_announce_seconds_bucket" in text,
                  f"12a tracker /metrics: announces {announces}, indexed {indexed}")
            out["tracker_announces"], out["tracker_indexed"] = announces, indexed
            status, body = await asyncio.to_thread(_http_get, handle.http_port, "/v1/health")
            health = json.loads(body)
            check(status == 200 and health["ready"], f"12a tracker /v1/health: {status} {health}")

            sched = HashPlaneScheduler(hasher="gpu")
            await sched.start()
            try:
                reset()
                t1 = time.perf_counter()
                res = await verify_library_sched([(tl.storage, tl.metainfo.info)], sched, tenant="recheck")
                out["recheck_s"] = time.perf_counter() - t1
                out["launches"]["recheck"] = counts()
            finally:
                await sched.close()
            check(bool(res.bitfields[0].all()), "12a: the scheduler recheck of the leech's storage is not all True")
            got = out["launches"]["recheck"]
            check(got["sha1_cuda"] > 0 and got["cpu_fallback"] == 0, f"12a recheck: launches {got}")

            # -- 12b: a pure-v2 torrent through the same tracker, streamed while it downloads
            m2 = parse_metainfo_v2(encode_metainfo_v2(v2_meta.info, v2_meta.piece_layers, url))
            v2_seed = await started(hasher="gpu")
            check((await v2_seed.add(m2, tmp)).state == TorrentState.SEEDING, "12b v2 seed is not seeding")
            v2_leech = await started(hasher="gpu")
            box2 = await BoxStreamServer(v2_leech).start()
            servers.append(box2)
            Torrent._verify_batch_device_v2 = counting(ingest, real_v2)
            merkle.piece_root_cpu = counting_fold
            reset()
            try:
                t1 = time.perf_counter()
                t2 = await v2_leech.add(m2, dirs["v2"])
                out["v2_files"] = []
                for i, name, _, length in content_files(t2):
                    with open(os.path.join(tmp, v2_meta.info.name, name), "rb") as f:
                        expect = f.read()
                    r = await asyncio.to_thread(_stream_get, box2.port, f"/{t2.metainfo.info_hash.hex()}/{i}", 0, expect)
                    check(r["status"] == 200 and r["bytes"] == length == len(expect) and r["equal"],
                          f"12b stream of {name}: {r}")
                    out["v2_files"].append(r)
                await asyncio.wait_for(t2.on_complete.wait(), SERVE_WAIT_S)
                out["v2_wall_s"] = time.perf_counter() - t1
            finally:
                Torrent._verify_batch_device_v2 = real_v2
                merkle.piece_root_cpu = real_fold
            out["launches"]["v2 stream"] = counts()
            out["v2_flushes"], out["v2_device_pieces"], _ = ingest.get(id(t2), [0, 0, 0.0])
            out["v2_host_pieces"], out["v2_pieces"] = host_folds[0], t2.info.num_pieces
            got = out["launches"]["v2 stream"]
            check(got["sha256_cuda"] > 0 and got["sha256_merkle_cuda"] > 0 and got["cpu_fallback"] == 0,
                  f"12b v2 stream: launches {got}")
            check(out["v2_device_pieces"] + out["v2_host_pieces"] >= out["v2_pieces"],
                  f"12b: {out['v2_device_pieces']} + {out['v2_host_pieces']} pieces verified of {out['v2_pieces']}")
        finally:
            for s in servers:
                s.close()
            for c in clients:
                await c.close()
            await handle.close()

        # -- 12c: netbench's fanout on the card (its own tracker and clients)
        added, finished, nb_ingest = {}, {}, {}
        counted_nb = counting(nb_ingest, real_v1)
        real_client_add = Client.add

        async def timed_add(self, *args, **kwargs):
            t = await real_client_add(self, *args, **kwargs)
            added[id(t)] = time.perf_counter()
            return t

        def finishing(self, pieces, expected):
            ok = counted_nb(self, pieces, expected)
            finished[id(self)] = time.perf_counter()
            return ok

        Client.add = timed_add
        Torrent._verify_batch_device = finishing
        reset()
        try:
            out["netbench"] = await netbench._swarm(NETBENCH_BYTES, PIECE, NETBENCH_LEECHES, utp=False)
        finally:
            Client.add = real_client_add
            Torrent._verify_batch_device = real_v1
        out["launches"]["netbench"] = counts()
        out["netbench_leech_s"] = sorted(finished[k] - added[k] for k in finished)
        leech_pieces = sorted(v[1] for v in nb_ingest.values())
        out["netbench_flushes"] = sum(v[0] for v in nb_ingest.values())
        out["netbench_pieces"] = sum(leech_pieces)
        check(len(leech_pieces) == NETBENCH_LEECHES and all(p >= per for p in leech_pieces),
              f"12c: pieces through _verify_batch_device per leech {leech_pieces}")
        # a flush is one launch; with several peers a leech's flush can
        # carry more than one piece, so launches may be fewer than pieces
        got = out["launches"]["netbench"]
        check(got["sha1_cuda"] >= out["netbench_flushes"] and got["cpu_fallback"] == 0,
              f"12c netbench: launches {got} for {out['netbench_flushes']} flushes")

        await asyncio.sleep(0)
        pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task() and not t.done()]
        check(not pending, f"tasks left pending: {[t.get_name() for t in pending]}")

    t0 = time.perf_counter()
    try:
        asyncio.run(go())
    finally:
        launch_counts.uninstall()

    # -- 12d: the scenario library, twice a scenario (device-free)
    out["scenarios"] = {}
    for name in sorted(SCENARIOS):
        t1 = time.perf_counter()
        runs = [run_scenario(get(name)) for _ in range(2)]
        wall = (time.perf_counter() - t1) / 2
        canon = [canonical_bytes(r["verdict"], r["timeline"]) for r in runs]
        check(canon[0] == canon[1], f"12d {name}: the two runs' canonical bytes differ")
        check(all(r["verdict"]["pass"] for r in runs), f"12d {name}: {runs[0]['verdict']['reasons']}")
        out["scenarios"][name] = wall
    out["phase_s"] = time.perf_counter() - t0

    mib = SERVE_BYTES / 2**20
    size = f"{mib:.0f} MiB ({n} x {PIECE >> 10} KiB)"
    log(
        f"time: serve 12a authoring of {size} s={out['author_s']:.3f}; seed recheck s={out['seed_recheck_s']:.3f} "
        f"sha1_cuda launches={out['launches']['seed recheck']['sha1_cuda']}; the indexer fed the store "
        f"in s={out['indexed_s']:.3f} {card}"
    )
    log(
        f"time: serve 12a magnet via the sharded tracker: add_magnet to the first metadata byte "
        f"s={out['meta_s']:.3f}, to the registration s={out['registered_s']:.3f} {card}"
    )
    log(
        f"time: serve 12a download {size} gpu wall s={out['gpu_wall_s']:.3f} MiB/s={mib / out['gpu_wall_s']:.1f}; "
        f"ingest flushes={out['gpu_flushes']} pieces={out['gpu_pieces']} "
        f"(ms a flush={1e3 * out['gpu_flush_s'] / max(1, out['gpu_flushes']):.2f}) "
        f"sha1_cuda launches={out['launches']['gpu download']['sha1_cuda']} "
        f"cpu fallback launches={out['launches']['gpu download']['cpu_fallback']} {card}"
    )
    for key, label in (("range", f"bytes={SERVE_RANGE_FROM}-"), ("whole", "from 0")):
        r = out[key]
        log(
            f"time: serve 12a stream GET {label}: head s={r['head_s']:.3f} first byte s={r['first_s']:.3f} "
            f"wall s={r['wall_s']:.3f} MiB/s={r['bytes'] / 2**20 / r['wall_s']:.1f} {card}"
        )
    log(
        f"time: serve 12a scheduler recheck of the leech's storage s={out['recheck_s']:.3f} "
        f"launches {out['launches']['recheck']}; tracker announces={out['tracker_announces']} "
        f"indexed={out['tracker_indexed']} {card}"
    )
    v2_bytes = sum(s for _, s in MULTI_FILES)
    log(
        f"time: serve 12b pure-v2 stream of {v2_bytes} bytes at 1 MiB pieces wall s={out['v2_wall_s']:.3f} "
        f"MiB/s={v2_bytes / 2**20 / out['v2_wall_s']:.1f}; first bytes s="
        f"{[round(r['first_s'], 3) for r in out['v2_files']]}; {out['v2_pieces']} pieces: "
        f"{out['v2_device_pieces']} through _verify_batch_device_v2 in {out['v2_flushes']} flushes, "
        f"{out['v2_host_pieces']} folded on the host; launches {out['launches']['v2 stream']} {card}"
    )
    nb = out["netbench"]
    log(
        f"time: serve 12c netbench fanout {NETBENCH_LEECHES} leeches x {NETBENCH_BYTES >> 20} MiB "
        f"({per} x {PIECE >> 10} KiB) s={nb['seconds']} aggregate MiB/s={nb['value']}; each leech MiB/s="
        f"{[round(NETBENCH_BYTES / 2**20 / s, 1) for s in out['netbench_leech_s']]}; "
        f"ingest flushes={out['netbench_flushes']} pieces={out['netbench_pieces']}; "
        f"launches {out['launches']['netbench']} {card}"
    )
    log(
        "time: serve 12d scenarios (device-free) s a run="
        f"{ {k: round(v, 3) for k, v in out['scenarios'].items()} } {card}"
    )
    log(f"time: serve phase 12 wall s={out['phase_s']:.3f} {card}")
    log(
        f"phase 12: a magnet joined through the indexer-fed sharded tracker ({out['gpu_pieces']} pieces through "
        f"the SHA-1 kernel, no CPU-fallback launch), streamed bytes equal the payload and came from verified pieces "
        f"only, the scheduler recheck is all True; the v2 stream's files are equal (SHA-256 and merkle launches); "
        f"netbench's {NETBENCH_LEECHES} leeches completed; {len(SCENARIOS)} scenarios replayed bit-identically"
    )
    return out["launches"]


# ---------------------------------------------------------------- phase 13

CLI_FLIP = 5000  # 13a's flipped piece of the 2 GiB file (phase 4's)
CLI_SWARM_BYTES = 64 << 20  # 13c's file: 256 pieces of 256 KiB (phase 12c's depth)
CLI_WAIT_S = 300  # the longest one phase-13 command may take
CLI_BRIDGE_PIECES = 16  # 13c's /v1/digests body: pieces of 256 KiB
CLI_ENV = dict(os.environ, PYTHONUNBUFFERED="1")  # a server's ready line must not sit in a buffer


def cli_in_process(argv: list) -> tuple:
    """``tools.cli.main(argv)`` in this process: (rc, stdout, stderr, s)."""
    import contextlib
    import io

    from torrent_tpu_torch.tools.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t


def cli_command(argv: list) -> tuple:
    """``python -m torrent_tpu_torch argv`` in a fresh interpreter:
    (rc, stdout, stderr, s), the interpreter's start included."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torrent_tpu_torch", *argv],
        cwd=REPO, env=CLI_ENV, capture_output=True, text=True, timeout=CLI_WAIT_S,
    )
    return proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t


class CliServer:
    """A long-running ``python -m torrent_tpu_torch`` command (tracker,
    seed, bridge): started, waited on until a line of its output matches
    ``ready``, drained meanwhile, and stopped with SIGINT, after which it
    must exit 0 (or 130, Python's exit for an interrupt) with no
    traceback."""

    def __init__(self, argv: list, ready: str):
        import threading

        self.argv = argv
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torrent_tpu_torch", *argv], cwd=REPO, env=CLI_ENV,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self.lines: list = []
        self.match = None
        self._seen = threading.Event()

        def drain():
            for line in self.proc.stdout:
                self.lines.append(line)
                if self.match is None:
                    m = re.search(ready, line)
                    if m:
                        self.match = m
                        self._seen.set()
            self._seen.set()

        self._drain = threading.Thread(target=drain, daemon=True)
        self._drain.start()

    def wait_ready(self) -> "re.Match":
        self._seen.wait(CLI_WAIT_S)
        check(self.match is not None, f"{self.argv[0]} never got ready: {''.join(self.lines)[-2000:]}")
        return self.match

    def stop(self) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
            raise SmokeFailure(f"{self.argv[0]} did not exit on SIGINT")
        self._drain.join(10)
        text = "".join(self.lines)
        check(rc in (0, 130) and "Traceback" not in text, f"{self.argv[0]} exited {rc}: {text[-2000:]}")
        return rc


def cli_phase(tmp: str, single: str, multi_root: str, rng, card: str) -> dict:
    """Phase 13: the command line (``tools/cli.py``, ``tools/doctor.py``,
    ``python -m torrent_tpu_torch``) on the card at phase 4's widths."""
    import hashlib as _hashlib
    import http.client

    from torrent_tpu_torch.codec.bencode import bdecode, bencode
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda

    kernels = {
        "sha1_cuda": sha1_cuda.sha1_pieces_cuda,
        "sha256_cuda": sha256_cuda.sha256_pieces_cuda,
        "sha256_merkle_cuda": sha256_cuda.sha256_merkle_cuda,
    }
    t_phase = time.perf_counter()
    d = os.path.join(tmp, "cli")
    os.makedirs(d)
    url = "http://localhost/announce"
    launches: dict = {}
    walls: dict = {}

    def device_command(label: str, argv: list, grows: tuple, rc_want: int = 0) -> str:
        """One command in this process with the counts at 0 just before
        it; every kernel in ``grows`` must have launched in it."""
        for fn in kernels.values():
            fn.launches = 0
        rc, out, err, s = cli_in_process(argv)
        counts = {k: fn.launches for k, fn in kernels.items()}
        check(rc == rc_want, f"13a {label}: exit {rc}, not {rc_want}: {err[-2000:]}")
        for name in grows:
            check(counts[name] > 0, f"13a {label}: {name} launched no time ({counts})")
        launches[label] = counts
        walls[label] = s
        return out

    # ------------------------------------------------------------ 13a
    t1, t1c = os.path.join(d, "single.torrent"), os.path.join(d, "single_cpu.torrent")
    v1 = ["make", single, url, "--piece-length", str(PIECE)]
    device_command("make", v1 + ["-o", t1], ("sha1_cuda",))
    rc, _, err, walls["make hashlib"] = cli_in_process(v1 + ["-o", t1c, "--hasher", "cpu"])
    check(rc == 0, f"13a make --hasher cpu: {err[-2000:]}")
    with open(t1, "rb") as f, open(t1c, "rb") as g:
        check(bdecode(f.read())[b"info"] == bdecode(g.read())[b"info"], "13a make: info differs from hashlib's")
    v2_out = {}
    for kind, grows in (
        ("--v2", ("sha256_cuda", "sha256_merkle_cuda")),
        ("--hybrid", ("sha1_cuda", "sha256_cuda", "sha256_merkle_cuda")),
    ):
        gpu, cpu = os.path.join(d, f"multi{kind}.torrent"), os.path.join(d, f"multi{kind}_cpu.torrent")
        argv = ["make", multi_root, url, kind]
        v2_out[kind] = device_command(f"make {kind}", argv + ["-o", gpu], grows)
        rc, _, err, walls[f"make {kind} hashlib"] = cli_in_process(argv + ["-o", cpu, "--hasher", "cpu"])
        check(rc == 0, f"13a make {kind} --hasher cpu: {err[-2000:]}")
        with open(gpu, "rb") as f, open(cpu, "rb") as g:
            check(f.read() == g.read(), f"13a make {kind}: bytes differ from hashlib's")
    for path in (t1, os.path.join(d, "multi--v2.torrent"), os.path.join(d, "multi--hybrid.torrent")):
        rc, out, err, _ = cli_in_process(["info", path])
        check(rc == 0 and out.startswith("name:"), f"13a info {path}: {rc} {err[-500:]}")
        log(f"phase 13: info {os.path.basename(path)}: {out.splitlines()[0]} / {out.splitlines()[1]}")
    n = -(-SINGLE_BYTES // PIECE)
    verify = ["verify", t1, tmp, "--batch", str(BATCH)]
    out = device_command("verify", verify, ("sha1_cuda",))
    check(out == f"{n}/{n} pieces valid\n", f"13a verify: {out!r}")
    verify_out = out
    flip_byte(single, CLI_FLIP * PIECE + 777)
    try:
        out = device_command("verify flipped", verify, ("sha1_cuda",), rc_want=2)
        check(
            out == f"{n - 1}/{n} pieces valid\nfirst invalid pieces: [{CLI_FLIP}]\n",
            f"13a verify of the flipped byte: {out!r}",
        )
    finally:
        flip_byte(single, CLI_FLIP * PIECE + 777)
    for kind in ("--v2", "--hybrid"):
        out = device_command(
            f"verify {kind}", ["verify", os.path.join(d, f"multi{kind}.torrent"), tmp],
            ("sha256_cuda", "sha256_merkle_cuda"),
        )
        m = re.fullmatch(r"(\d+)/(\d+) pieces valid \(v2\)\n", out)
        check(m is not None and m.group(1) == m.group(2), f"13a verify {kind}: {out!r}")
    # a fresh interpreter prints what this process printed
    rc, out, err, walls["verify fresh process"] = cli_command(verify)
    check((rc, out) == (0, verify_out), f"13a python -m verify: {rc} {out!r} {err[-2000:]}")
    gpu_v2 = os.path.join(d, "multi--v2.torrent")
    with open(gpu_v2, "rb") as f:
        v2_bytes = f.read()
    rc, out, err, walls["make --v2 fresh process"] = cli_command(["make", multi_root, url, "--v2", "-o", gpu_v2])
    check((rc, out) == (0, v2_out["--v2"]), f"13a python -m make --v2: {rc} {out!r} {err[-2000:]}")
    with open(gpu_v2, "rb") as f:
        check(f.read() == v2_bytes, "13a python -m make --v2: bytes differ")
    # the 2 GiB recheck at the reference's default batch and at 4096, each beside hashlib
    for run, batch in enumerate((256, BATCH), 1):
        for label, argv in (
            (f"verify gpu batch {batch}", ["--batch", str(batch)]),
            (f"verify hashlib run {run}", ["--hasher", "cpu"]),
        ):
            rc, out, err, walls[label] = cli_in_process(["verify", t1, tmp, *argv])
            check((rc, out) == (0, verify_out), f"13a {label}: {rc} {out!r} {err[-500:]}")
    log(
        f"phase 13: 13a make (gpu == hashlib info), make --v2 and --hybrid (gpu == hashlib bytes), info, "
        f"verify {n}/{n} and exactly piece {CLI_FLIP} after a flip, v2 and hybrid verify all valid; "
        f"python -m verify and make --v2 print what main printed"
    )
    for label, s in walls.items():
        log(f"time: cli {label} s={s:.3f} {card}")
    for label in ("make", "verify", "verify gpu batch 256", f"verify gpu batch {BATCH}"):
        log(f"time: cli {label} pieces/s={n / walls[label]:.1f} {card}")

    # ------------------------------------------------------------ 13b
    rc, out, err, doctor_s = cli_command(["doctor", "--json", "--v2", "--faults", "--lint", "--skip-swarm"])
    check(rc == 0, f"13b doctor exited {rc}: {err[-3000:]}")
    summary = json.loads(out)
    for c in summary["checks"]:
        log(f"phase 13: doctor [{c['status']}] {c['name']} — {c['detail']}")
    checks_ = {c["name"]: c for c in summary["checks"]}
    check(summary["ok"] and summary["fails"] == 0, f"13b doctor: {summary['fails']} FAIL")
    for name in ("sha1 plane", "sha256 plane"):
        check(checks_[name]["detail"].startswith("route=cuda, "), f"13b doctor {name}: {checks_[name]}")
    check(checks_["device probe"]["status"] == "PASS", f"13b doctor: {checks_['device probe']}")
    check("cuda lane" in checks_["verify scheduler"]["detail"], f"13b doctor: {checks_['verify scheduler']}")
    check("(cuda," in checks_["v2 hash plane"]["detail"], f"13b doctor: {checks_['v2 hash plane']}")
    check(checks_["analysis plane"]["status"] == "PASS", f"13b doctor: {checks_['analysis plane']}")
    log(f"time: cli doctor --json --v2 --faults --lint --skip-swarm wall s={doctor_s:.3f} {card}")

    # ------------------------------------------------------------ 13c
    sd, td = os.path.join(d, "seed"), os.path.join(d, "torrents")
    os.makedirs(td)
    payload = os.path.join(sd, "cli64.bin")
    write_random(payload, CLI_SWARM_BYTES, rng)
    with open(payload, "rb") as f:
        want = _hashlib.sha256(f.read()).hexdigest()
    servers = []
    try:
        tracker = CliServer(["tracker", "--http-port", str(free_port()), "--udp-port", "-1"],
                            r"tracker listening: http=(\d+)")
        servers.append(tracker)
        bridge = CliServer(["bridge", "--hasher", "gpu", "--port", str(free_port())],
                           r"bridge listening on 127\.0\.0\.1:(\d+)")
        servers.append(bridge)
        announce = f"http://127.0.0.1:{tracker.wait_ready().group(1)}/announce"
        tfile = os.path.join(td, "cli64.torrent")
        device_command("make swarm", ["make", payload, announce, "-o", tfile, "--piece-length", str(PIECE)],
                       ("sha1_cuda",))
        seed = CliServer(["seed", td, sd], r"seeding 1 torrent\(s\) on port (\d+)")
        servers.append(seed)
        seed.wait_ready()
        check(any(f"{CLI_SWARM_BYTES // PIECE}/{CLI_SWARM_BYTES // PIECE} pieces" in x for x in seed.lines),
              f"13c seed did not recheck every piece: {''.join(seed.lines)[-1000:]}")
        dl_walls = {}
        for hasher in ("gpu", "cpu"):
            dest = os.path.join(d, f"dl_{hasher}")
            os.makedirs(dest)
            rc, out, err, dl_walls[hasher] = cli_command(
                ["download", tfile, dest, "--no-resume", "--hasher", hasher])
            check(rc == 0 and "download complete" in err, f"13c download --hasher {hasher}: {rc} {err[-2000:]}")
            with open(os.path.join(dest, "cli64.bin"), "rb") as f:
                check(_hashlib.sha256(f.read()).hexdigest() == want, f"13c download --hasher {hasher}: bytes differ")
        bport = int(bridge.wait_ready().group(1))
        pieces = [rng.bytes(PIECE) for _ in range(CLI_BRIDGE_PIECES)]
        conn = http.client.HTTPConnection("127.0.0.1", bport, timeout=60)
        try:
            conn.request("POST", "/v1/digests", body=bencode({b"pieces": pieces}))
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        check(resp.status == 200, f"13c bridge /v1/digests: {resp.status} {body[:200]!r}")
        check(bdecode(body)[b"digests"] == [_hashlib.sha1(p).digest() for p in pieces],
              "13c bridge digests differ from hashlib's")
        rc, frame, err, top_s = cli_command(["top", "--once", "--url", f"http://127.0.0.1:{bport}"])
        m = re.search(r"sched: .* (\d+) launches", frame)
        check(rc == 0 and m is not None and int(m.group(1)) > 0, f"13c top --once: {rc} {frame!r} {err[-500:]}")
        log(f"phase 13: top --once against the CLI bridge: {m.group(0)}")
    finally:
        codes = [s.stop() for s in reversed(servers)]
    log(
        f"phase 13: 13c tracker, seed and bridge from the command line, downloads --hasher gpu and cpu equal to "
        f"the file, bridge digests equal to hashlib's; servers exited {codes}"
    )
    log(
        f"time: cli 13c download of {CLI_SWARM_BYTES >> 20} MiB (fresh process, start included) gpu s="
        f"{dl_walls['gpu']:.3f} hashlib s={dl_walls['cpu']:.3f} ratio={dl_walls['gpu'] / dl_walls['cpu']:.3f}; "
        f"top --once s={top_s:.3f} {card}"
    )
    phase_s = time.perf_counter() - t_phase
    log(f"time: cli phase 13 wall s={phase_s:.3f} {card}")
    return launches


# ---------------------------------------------------------------- phase 14

BENCH_E2E_MB = 1024  # 14a's e2e recheck: 4096 pieces of 256 KiB (the rung's default shape)
BENCH_E2E_RUNS = 3  # 14a's --hasher gpu runs (the spread), beside one hashlib run
BENCH_RUNG_TIMEOUT_S = 600  # a device-bench child's limit
TUNE_SHA1_GRID = "4.3.2,2.2.2"  # the production knobs (wk.raw.sched) and one variant
TUNE_SHA256_GRID = "32,64"  # the production rows block and one variant
TUNE_ITERS = 8


def bench_phase(tmp: str, card: str) -> dict:
    """Phase 14: the bench (``tools/bench_cli.py`` through ``tools.cli.main``,
    its device rungs the port's ``tools/device_bench.py`` in a child
    process) and the kernel tuners (``tools/tune_sha1.py``,
    ``tools/tune_sha256.py``) on the card."""
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.tools import tune_sha1, tune_sha256

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "bench")
    os.makedirs(d)
    traj = os.path.join(d, "BENCH_trajectory_cuda.json")
    repo_traj = os.path.join(REPO, "BENCH_trajectory.json")

    def file_hash(path):
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    repo_traj_hash = file_hash(repo_traj)
    out: dict = {"launches": {}}

    def bench(argv: list, label: str) -> dict:
        path = os.path.join(d, f"{label}.json")
        rc, stdout, err, s = cli_in_process(["bench", *argv, "--out", path])
        check(rc == 0, f"bench {label}: exit {rc}: {err[-2000:]}")
        with open(path) as f:
            rec = json.load(f)
        check(json.loads(stdout.strip().splitlines()[-1]) == rec, f"bench {label}: stdout differs from --out")
        return rec, s

    # 14a: the e2e rung, scheduler-fed, in this process
    e2e = []
    for i in range(BENCH_E2E_RUNS):
        sha1_cuda.sha1_pieces_cuda.launches = 0
        rec, s = bench(["e2e", "--hasher", "gpu", "--mb", str(BENCH_E2E_MB)], f"e2e_gpu_{i}")
        n = sha1_cuda.sha1_pieces_cuda.launches
        check(rec["value"] is not None and rec["platform"] == "cuda" and rec["valid"] == rec["pieces"],
              f"14a e2e gpu run {i}: {rec}")
        check(n > 0, f"14a e2e gpu run {i} launched the SHA-1 kernel no time")
        check(rec["staging_outstanding"] == 0, f"14a e2e gpu run {i}: {rec['staging_outstanding']} slabs outstanding")
        out["launches"][f"e2e gpu {i}"] = n
        e2e.append((rec, s))
    cpu_rec, cpu_s = bench(["e2e", "--hasher", "cpu", "--mb", str(BENCH_E2E_MB)], "e2e_cpu")
    check(cpu_rec["value"] is not None and cpu_rec["platform"] == "cpu", f"14a e2e cpu: {cpu_rec}")
    values = sorted(r["value"] for r, _ in e2e)
    median = values[len(values) // 2]
    spread = (values[-1] - values[0]) / median
    for i, (rec, s) in enumerate(e2e):
        log(
            f"time: bench e2e gpu run {i} {rec['pieces']} x {rec['piece_kb']} KiB pieces/s={rec['value']} "
            f"GiB/s={rec['gib_per_sec']} recheck s={rec['seconds']} (command s={s:.3f}) sha1 launches="
            f"{out['launches'][f'e2e gpu {i}']} bottleneck={(rec['ledger']['bottleneck'] or {}).get('stage')} {card}"
        )
    log(
        f"time: bench e2e gpu median pieces/s={median} spread={spread:.3f} (max-min over median of "
        f"{BENCH_E2E_RUNS}); hashlib pieces/s={cpu_rec['value']} recheck s={cpu_rec['seconds']} {card}"
    )
    out["e2e"] = {"values": [r["value"] for r, _ in e2e], "spread": spread, "cpu": cpu_rec["value"]}

    # 14b: the device rungs, each a child process of the port's device bench
    for rung, kernels in (("flagship", ("sha1_cuda",)), ("v2", ("sha256_cuda", "sha256_merkle_cuda"))):
        rec, s = bench([rung, "--timeout", str(BENCH_RUNG_TIMEOUT_S)], rung)
        check(rec["value"] is not None and rec["platform"] == "cuda" and rec["backend"] == "cuda",
              f"14b {rung}: {rec}")
        check(rec["n_runs"] == 3 and len(rec["runs_pps"]) == 3 and rec["spread"] is not None,
              f"14b {rung}: no median-of-3 fields {rec}")
        check(rec["device_runs_pps"] and len(rec["device_runs_pps"]) == 3, f"14b {rung}: no CUDA-event runs {rec}")
        for k in kernels:
            check(rec["launches"][k] > 0, f"14b {rung}: the child launched {k} no time: {rec['launches']}")
        log(
            f"time: bench {rung} ({rec['metric']}, batch {rec['batch']}) hash plane pieces/s={rec['value']} "
            f"runs={rec['runs_pps']} spread={rec['spread']} CUDA-event pieces/s={rec['device_value']} "
            f"runs={rec['device_runs_pps']}; end to end pieces/s={rec['end_to_end_pps']}; vs hashlib "
            f"{rec['vs_baseline']}x plane, {rec['end_to_end_vs_baseline']}x end to end; h2d MiB/s="
            f"{rec.get('h2d_mib_s')}; child launches {rec['launches']}; command s={s:.3f} {card}"
        )
        out[rung] = rec
        out["launches"][rung] = rec["launches"]

    # 14c: bank, then compare, into the smoke's own trajectory
    e2e_median = os.path.join(d, f"e2e_gpu_{[r['value'] for r, _ in e2e].index(median)}.json")
    rc, _, err, _ = cli_in_process(["bench", "--record", e2e_median, "--compare", "--trajectory", traj])
    check(rc == 0 and "unarmed" in err, f"14c compare before banking: {rc} {err[-1000:]}")
    rc, _, err, _ = cli_in_process(["bench", "--record", e2e_median, "--bank", "--trajectory", traj])
    check(rc == 0 and os.path.exists(traj), f"14c bank: {rc} {err[-1000:]}")
    rc, _, err, _ = cli_in_process(["bench", "--record", e2e_median, "--compare", "--trajectory", traj])
    check(rc == 0 and "comparator ok" in err, f"14c compare after banking (armed): {rc} {err[-1000:]}")
    check(file_hash(repo_traj) == repo_traj_hash, "14c the repo's BENCH_trajectory.json changed")
    log(f"phase 14: 14c banked the median e2e record; the compare before banking was unarmed, after it armed: "
        f"{err.strip().splitlines()[-1]}; the repo's BENCH_trajectory.json unchanged")

    # 14d: the tuners, each variant bit-exact against hashlib before it is timed
    before = (sha1_cuda.sha1_pieces_cuda.launches, sha256_cuda.sha256_pieces_cuda.launches)
    prod_mtime = (sha1_cuda.LIBRARY.stat().st_mtime, sha256_cuda.LIBRARY.stat().st_mtime)
    sweeps = {
        "sha1_cuda": tune_sha1.run_sweep(256, BATCH, tune_sha1.parse_grid(TUNE_SHA1_GRID), TUNE_ITERS),
        "sha256_cuda": tune_sha256.run_sweep(16, LEAF_LAUNCH, tune_sha256.parse_grid(TUNE_SHA256_GRID), TUNE_ITERS),
    }
    after = (sha1_cuda.sha1_pieces_cuda.launches, sha256_cuda.sha256_pieces_cuda.launches)
    check(after == before, f"14d the tuners grew the production counters {before} -> {after}")
    check((sha1_cuda.LIBRARY.stat().st_mtime, sha256_cuda.LIBRARY.stat().st_mtime) == prod_mtime,
          "14d the tuners rebuilt a production library")
    for name, records in sweeps.items():
        check(len(records) == 2 and sum(r["default"] for r in records) == 1, f"14d {name}: {records}")
        for r in records:
            log(
                f"time: tune {name} {r['knobs']}{' (production knobs)' if r['default'] else ''} rank {r['rank']} "
                f"ms={r['ms']} pieces/s={r['pieces_per_sec']} GB/s={r['gb_per_sec']} bound_ms={r['bound_ms']} "
                f"({r['bound_by']}) share of the operations bound={r['ops_bound_share']} registers={r['registers']} "
                f"spills={r['spill_stores']} smem={r.get('dynamic_smem_bytes', r['static_smem_bytes'])} "
                f"build s={r['build_s']}; {r['rows_checked']} rows equal to hashlib {card}"
            )
    out["variants"] = {
        name: [{k: r[k] for k in ("knobs", "default", "ms", "ops_bound_share", "build_s")} for r in records]
        for name, records in sweeps.items()
    }
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"time: bench phase 14 wall s={out['phase_s']:.3f} {card}")
    return out


# ---------------------------------------------------------------- phase 15

TSAN_LIB = 1  # phase 7's library torrent the sanitized sweep rechecks as bulk (1 GiB, 4096 pieces)
TSAN_CHILD_S = 600  # the parent's wait for the sanitized child
TSAN_CELLS = ("sched.staging.free_list", "sched.slab.refs", "sched.breaker.state")
TSAN_LOCKS = ("sched.sha1_plane._device_lock", "sched.sha256_cuda_plane._device_lock", "sched.lane.build_lock")


async def tsan_sweep(sched, lib_root: str, info, leaves: list) -> tuple:
    """Phase 15's sweep on ``sched``: library torrent ``TSAN_LIB`` as
    ``bulk`` (zero-copy SHA-1 ingest) beside ``leaves`` as ``stream``
    (SHA-256, phase 7's chunking). Returns (bitfield, leaf digests, s)."""
    import asyncio

    from torrent_tpu_torch.parallel.verify import verify_pieces_sched
    from torrent_tpu_torch.storage.storage import FsStorage, Storage

    async def stream():
        chunk = sched.chunk_for(LEAF, "sha256")
        parts = await asyncio.gather(*(
            sched.submit("stream", leaves[s : s + chunk], algo="sha256", piece_length=LEAF, wait=True)
            for s in range(0, len(leaves), chunk)
        ))
        return [d for part in parts for d in part]

    t0 = time.perf_counter()
    bf, got = await asyncio.gather(
        verify_pieces_sched(Storage(FsStorage(lib_root), info), info, sched, tenant="bulk"), stream()
    )
    return bf, got, time.perf_counter() - t0


def tsan_inputs(spec: dict) -> tuple:
    """The library torrent's info and the stream's leaves (the first
    ``STREAM_LEAVES`` 16 KiB leaves of phase 4's single file)."""
    from torrent_tpu_torch.codec.metainfo import parse_metainfo

    with open(spec["torrent"], "rb") as f:
        info = parse_metainfo(f.read()).info
    with open(spec["single"], "rb") as f:
        blob = f.read(STREAM_LEAVES * LEAF)
    return info, [blob[i : i + LEAF] for i in range(0, len(blob), LEAF)]


def tsan_child_main(argv) -> None:
    """Phase 15b's child (``chip_smoke.py --tsan-child --spec F --out F``):
    a fresh interpreter whose environment sets ``TORRENT_TPU_TSAN=1``
    before any import, so every ``named_lock`` of the port is a
    ``SanitizedLock`` and every guarded cell runs Eraser. A bridge on the
    card (its scheduler has the default config) rechecks library torrent
    ``TSAN_LIB`` beside the stream's leaves while a client thread posts
    phase 9's 16 buffered ``/v1/verify`` requests, then sweeps the same
    work alone (timed); ``GET /metrics`` and a flight dump last. Writes
    its result as JSON; any check that fails raises."""
    import argparse
    import asyncio
    import threading

    t_child = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--tsan-child", action="store_true")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    check(os.environ.get("TORRENT_TPU_TSAN") == "1", "the child's environment does not set TORRENT_TPU_TSAN=1")
    sys.path.insert(0, REPO)
    from torrent_tpu_torch.analysis import sanitizer
    from torrent_tpu_torch.bridge.service import BridgeServer
    from torrent_tpu_torch.codec.bencode import bdecode, bencode
    from torrent_tpu_torch.obs.recorder import flight_recorder
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.utils.locks import named_lock

    check(type(named_lock("chip_smoke.probe._lock")) is sanitizer.SanitizedLock, "named_lock handed out a plain lock")
    with open(a.spec) as f:
        spec = json.load(f)
    info, leaves = tsan_inputs(spec)
    want_leaves = [hashlib.sha256(x).digest() for x in leaves]
    with open(spec["lib_file"], "rb") as f:
        lib_blob = f.read(BRIDGE_TENANTS * BRIDGE_WAVES * BRIDGE_PIECES * PIECE)
    expected = list(info.pieces)
    bodies, verdicts = {}, {}
    for k in range(BRIDGE_TENANTS):
        for w in range(BRIDGE_WAVES):
            first = (k * BRIDGE_WAVES + w) * BRIDGE_PIECES
            pieces = [lib_blob[(first + i) * PIECE : (first + i + 1) * PIECE] for i in range(BRIDGE_PIECES)]
            exp = list(expected[first : first + BRIDGE_PIECES])
            bad = (k + w) % BRIDGE_PIECES
            exp[bad] = bytes(b ^ 0xFF for b in exp[bad])
            bodies[k, w] = bencode({b"pieces": pieces, b"expected": exp})
            verdicts[k, w] = bytes(int(hashlib.sha1(p).digest() == e) for p, e in zip(pieces, exp))
    del lib_blob
    out: dict = {}
    errors: list = []

    def client(port: int) -> None:
        def tenant(k):
            try:
                for w in range(BRIDGE_WAVES):
                    status, _, body = _request(port, "POST", "/v1/verify", {"X-Tenant": f"tenant{k}"}, bodies[k, w])
                    check(status == 200, f"15b tenant {k} wave {w}: status {status}: {body[:200]!r}")
                    check(bdecode(body)[b"ok"] == verdicts[k, w], f"15b tenant {k} wave {w}: verdicts differ from hashlib's")
            except Exception as e:  # reported by the main thread
                errors.append(repr(e))

        threads = [threading.Thread(target=tenant, args=(k,)) for k in range(BRIDGE_TENANTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    async def run() -> None:
        svc = await BridgeServer(port=0, hasher="gpu").start()
        sched = svc.sched
        try:
            # the main path: the counts are 0 just before it and read just after
            sha1_cuda.sha1_pieces_cuda.launches = sha256_cuda.sha256_pieces_cuda.launches = 0
            t0 = time.perf_counter()
            (bf, got, _), _ = await asyncio.gather(
                tsan_sweep(sched, spec["lib_root"], info, leaves), asyncio.to_thread(client, svc.port)
            )
            out["with_requests_s"] = time.perf_counter() - t0
            check(not errors, f"15b: {errors}")
            check(bool(bf.all()) and got == want_leaves, "15b: the sweep beside the requests differs from hashlib")
            bf, got, out["sweep_s"] = await tsan_sweep(sched, spec["lib_root"], info, leaves)
            check(bool(bf.all()) and got == want_leaves, "15b: the timed sweep differs from hashlib")
            out["launches"] = {
                "sha1_cuda": sha1_cuda.sha1_pieces_cuda.launches,
                "sha256_cuda": sha256_cuda.sha256_pieces_cuda.launches,
            }
            status, _, body = await asyncio.to_thread(_request, svc.port, "GET", "/metrics")
            check(status == 200, f"15b /metrics: status {status}")
            out["metrics"] = [
                line for line in body.decode().splitlines()
                if line.startswith(("torrent_tpu_lock_acquisitions_total", "torrent_tpu_lock_order_cycles_total",
                                    "torrent_tpu_lockset_races_total"))
            ]
            snap = sched.metrics_snapshot()
            out["sched"] = {
                "cpu_fallback_launches": snap["cpu_fallback_launches"],
                "launch_failures": snap["launch_failures"],
                "staging_outstanding": snap["staging"]["outstanding"],
                "reuse": sched.staging_reuse(),
            }
        finally:
            svc.close()
            await svc.wait_closed()

    asyncio.run(run())
    out["dump_has_tsan"] = "tsan" in flight_recorder().trigger("chip_smoke_tsan", detail={})
    out["tsan"] = sanitizer.snapshot()
    out["child_s"] = time.perf_counter() - t_child
    with open(a.out, "w") as f:
        json.dump(out, f)


def analysis_phase(tmp: str, single: str, lib_torrents: list, card: str) -> dict:
    """Phase 15: the analysis plane on the card's host (15a) and the
    sanitized device path in a child interpreter (15b). Returns the
    child's launches per kernel."""
    import asyncio

    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig

    t_phase = time.perf_counter()
    # ------------------------------------------------------------ 15a
    rc, out, err, lint_s = cli_command(["lint"])
    check(rc == 0 and "0 new, 0 stale" in out, f"15a lint exited {rc}: {out[-2000:]} {err[-2000:]}")
    log(f"phase 15: python -m torrent_tpu_torch lint: {out.strip().splitlines()[-1]}")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torrent_tpu_torch.analysis", "--json", "--no-baseline"],
        cwd=REPO, env=CLI_ENV, capture_output=True, text=True, timeout=CLI_WAIT_S,
    )
    raw_s = time.perf_counter() - t
    with open(os.path.join(REPO, "torrent_tpu_torch", "analysis_baseline.json")) as f:
        baseline = {f"{e['pass']}::{e['path']}::{e['symbol']}::{e['message']}" for e in json.load(f)["findings"]}
    found = {f"{x['pass_name']}::{x['path']}::{x['symbol']}::{x['message']}" for x in json.loads(proc.stdout)["new"]}
    check(proc.returncode == 1 and found == baseline, f"15a raw findings {sorted(found ^ baseline)} differ from the baseline")
    log(f"phase 15: the raw findings are exactly the baseline's {len(baseline)} keys")
    log(f"time: analysis lint wall s={lint_s:.3f}; --json --no-baseline wall s={raw_s:.3f} (each a fresh interpreter) {card}")

    # ------------------------------------------------------------ 15b
    d = os.path.join(tmp, "tsan")
    os.makedirs(d)
    spec = {
        "torrent": os.path.join(d, "lib.torrent"), "single": single, "lib_root": os.path.join(tmp, "library"),
        "lib_file": os.path.join(tmp, "library", f"t{TSAN_LIB:02d}.bin"),
    }
    with open(spec["torrent"], "wb") as f:
        f.write(lib_torrents[TSAN_LIB])
    spec_path, out_path = os.path.join(d, "spec.json"), os.path.join(d, "out.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    info, leaves = tsan_inputs(spec)

    async def unsanitized() -> float:
        sched = await HashPlaneScheduler(SchedulerConfig(), hasher="gpu").start()
        try:
            await tsan_sweep(sched, spec["lib_root"], info, leaves)  # warm
            bf, got, s = await tsan_sweep(sched, spec["lib_root"], info, leaves)
        finally:
            await sched.close()
        check(bool(bf.all()) and len(got) == len(leaves), "15b: the unsanitized sweep is not all True")
        return s

    plain_s = asyncio.run(unsanitized())
    del leaves
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--tsan-child", "--spec", spec_path, "--out", out_path],
        cwd=REPO, env=dict(os.environ, TORRENT_TPU_TSAN="1"), capture_output=True, text=True, timeout=TSAN_CHILD_S,
    )
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SmokeFailure(f"phase 15: the sanitized child exited {proc.returncode}")
    with open(out_path) as f:
        res = json.load(f)
    tsan, sched = res["tsan"], res["sched"]
    launches = res["launches"]
    check(launches["sha1_cuda"] > 0 and launches["sha256_cuda"] > 0, f"15b: kernels launched {launches} times")
    check(sched["cpu_fallback_launches"] == 0 and sched["launch_failures"] == 0, f"15b: {sched}")
    check(sched["staging_outstanding"] == 0 and sched["reuse"]["early_checkins"] == 0, f"15b: staging {sched}")
    for name in TSAN_LOCKS:
        check(tsan["locks"].get(name, {}).get("acquisitions", 0) > 0, f"15b: lock {name} never acquired: {sorted(tsan['locks'])}")
    for cell in TSAN_CELLS:
        check(tsan["cells"].get(cell, {}).get("instances", 0) > 0, f"15b: cell {cell} never made: {sorted(tsan['cells'])}")
    for cyc in tsan["cycles"]:
        log(f"phase 15: LOCK-ORDER CYCLE {' -> '.join(cyc + cyc[:1])}")
    for race in tsan["lockset_races"]:
        log(f"phase 15: LOCKSET RACE {race}")
    check(not tsan["cycles"] and tsan["lockset_race_count"] == 0, "15b: the sanitizer saw a cycle or a race")
    check(any(m.startswith("torrent_tpu_lock_acquisitions_total{") for m in res["metrics"]), f"15b /metrics: {res['metrics']}")
    check("torrent_tpu_lock_order_cycles_total 0" in res["metrics"], f"15b /metrics: {res['metrics']}")
    check(res["dump_has_tsan"], "15b: a flight dump has no tsan key")
    log(
        f"phase 15: sanitized child (TORRENT_TPU_TSAN=1): bridge + scheduler on the card rechecked library torrent "
        f"{TSAN_LIB} ({info.num_pieces} x {PIECE >> 10} KiB) beside {STREAM_LEAVES} x {LEAF >> 10} KiB leaves and answered "
        f"{BRIDGE_TENANTS * BRIDGE_WAVES} /v1/verify requests, all equal hashlib; sha1_cuda launches={launches['sha1_cuda']} "
        f"sha256_cuda launches={launches['sha256_cuda']}; {len(tsan['locks'])} sanitized locks, {tsan['edges']} order "
        f"edges, 0 cycles, {len(tsan['cells'])} guarded cells, 0 lockset races; /metrics and a flight dump carry the sanitizer"
    )
    for name in TSAN_LOCKS:
        st = tsan["locks"][name]
        log(
            f"phase 15: lock {name} acquisitions={st['acquisitions']} contended={st['contended']} "
            f"wait_total_s={st['wait_total_s']:.4f} hold_max_s={st['hold_max_s']:.4f}"
        )
    log(
        f"phase 15: loop_stalls={tsan['loop_stalls']} loop_stall_max_s={tsan['loop_stall_max_s']:.4f} "
        f"long_holds={tsan['long_holds']} same_name_nesting={tsan['same_name_nesting']} (printed, not failed)"
    )
    log(
        f"time: tsan sweep ({info.num_pieces} bulk pieces + {STREAM_LEAVES} stream leaves, warm) sanitized s={res['sweep_s']:.3f} "
        f"unsanitized (parent, just before) s={plain_s:.3f} ratio={res['sweep_s'] / plain_s:.3f}; sanitized sweep "
        f"beside the {BRIDGE_TENANTS * BRIDGE_WAVES} requests s={res['with_requests_s']:.3f}; child s={res['child_s']:.3f} (wall seen by the "
        f"parent s={wall:.3f}); phase 15 s={time.perf_counter() - t_phase:.3f} {card}"
    )
    return launches


# ---------------------------------------------------------------- phase 16

def example(mod, argv: list) -> tuple:
    """An example's ``main(argv)`` in this process: (exit code, stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def ci_phase(tmp: str, card: str) -> dict:
    """Phase 16: the PR gate's stages 1 and 4-12 on the card, and the
    examples (see the module docstring). Returns the examples' launches."""
    from torrent_tpu_torch.examples import batched_recheck, v2_author_verify
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.tools import bench_cli, ci

    kernels = {
        "sha1_cuda": sha1_cuda.sha1_pieces_cuda,
        "sha256_cuda": sha256_cuda.sha256_pieces_cuda,
        "sha256_merkle_cuda": sha256_cuda.sha256_merkle_cuda,
    }
    t_phase = time.perf_counter()
    launches: dict = {}

    # -- stage 1: the lint, its SARIF artifact checked, inside its budget
    t0 = time.perf_counter()
    rc = ci.lint_stage(os.path.join(tmp, "lint.sarif"))
    log(f"time: ci stage 1 lint rc={rc} s={time.perf_counter() - t0:.3f} (budget {os.environ.get('LINT_BUDGET_S') or 90} s) {card}")
    check(rc == 0, f"phase 16: stage 1 (lint, SARIF check, budget) exited {rc}")

    # -- stage 4, twice: bank a record into a trajectory of this run, then
    # the gate's armed compare against it
    env = {"TORRENT_TPU_BENCH_TRAJECTORY": os.path.join(tmp, "ci_trajectory.json")}
    t0 = time.perf_counter()
    rc, _ = ci.run_command(ci.bench_command("--bank"), env=env, capture=True)
    bank_s = time.perf_counter() - t0
    check(rc == 0 and len(bench_cli.load_trajectory(env["TORRENT_TPU_BENCH_TRAJECTORY"])) == 1,
          f"phase 16: stage 4's banking run exited {rc}")
    t0 = time.perf_counter()
    rc, stdout = ci.run_command(ci.bench_command("--compare", "--tolerance", "0.35"), env=env, capture=True)
    compare_s = time.perf_counter() - t0
    record = json.loads(stdout.strip().splitlines()[-1])
    code, verdict = bench_cli.compare_record(record, bench_cli.load_trajectory(env["TORRENT_TPU_BENCH_TRAJECTORY"]), 0.35)
    log(f"phase 16: stage 4 {verdict}")
    log(f"time: ci stage 4 bench --smoke bank s={bank_s:.3f} compare rc={rc} s={compare_s:.3f} {card}")
    check(rc == 0 and code == 0 and verdict.startswith("comparator ok"), f"phase 16: the armed compare exited {rc}: {verdict}")

    # -- stages 5-12: the eight doctor smokes in ONE fresh process on the
    # card, each named check judged as the gate judges its stage (--json
    # exit_code parity, the check at PASS). The gate runs a process a
    # stage: eight of them (each a torch import, a device probe and the
    # kernel checks) take about three minutes on an H100 host (PERF.md
    # §5), beyond this phase's room. Never
    # concurrently: the smokes' verdicts lean on timing (with four at once
    # on this host's cores the SLO smoke's poisoned burst can split across
    # launches and miss its fast burn)
    t0 = time.perf_counter()
    rc, stdout = ci.run_command(ci.doctor_command([flag for flag, _ in ci.DOCTOR_STAGES], None), capture=True)
    doctor_s = time.perf_counter() - t0
    verdicts = {name: ci.judge_doctor(rc, stdout, name) for _, name in ci.DOCTOR_STAGES}
    log(f"time: ci stages 5-12 doctor (one process, {len(verdicts)} smokes) rc={rc} s={doctor_s:.3f} {card}")
    failed = [name for name, v in verdicts.items() if v]
    check(not failed, f"phase 16: stages 5-12: doctor exited {rc}; not PASS with exit_code parity: {failed}")

    # -- the examples on the card, against hashlib's lines
    def reset() -> None:
        for k in kernels.values():
            k.launches = 0

    t0 = time.perf_counter()
    reset()
    rc, gpu_lines = example(batched_recheck, [])
    launches["batched_recheck gpu"] = {n: k.launches for n, k in kernels.items()}
    gpu_s = time.perf_counter() - t0
    check(rc == 0, f"phase 16: batched_recheck gpu exited {rc}")
    t0 = time.perf_counter()
    rc, cpu_lines = example(batched_recheck, ["cpu"])
    cpu_s = time.perf_counter() - t0
    check(rc == 0 and gpu_lines.replace("(gpu)", "(cpu)") == cpu_lines,
          f"phase 16: batched_recheck gpu printed {gpu_lines!r}, hashlib {cpu_lines!r}")
    check(gpu_lines.splitlines()[-1].endswith("bad pieces [14]"), f"phase 16: {gpu_lines.splitlines()[-1]}")
    check(launches["batched_recheck gpu"]["sha1_cuda"] > 0, f"phase 16: batched_recheck launched {launches['batched_recheck gpu']}")
    log(f"phase 16: batched_recheck gpu: {' / '.join(gpu_lines.splitlines())}")
    log(f"time: ci example batched_recheck gpu s={gpu_s:.3f} hashlib s={cpu_s:.3f} launches {launches['batched_recheck gpu']} {card}")

    t0 = time.perf_counter()
    reset()
    rc, gpu_lines = example(v2_author_verify, [])
    launches["v2_author_verify gpu"] = {n: k.launches for n, k in kernels.items()}
    gpu_s = time.perf_counter() - t0
    check(rc == 0, f"phase 16: v2_author_verify gpu exited {rc}")
    t0 = time.perf_counter()
    rc, cpu_lines = example(v2_author_verify, ["cpu"])
    cpu_s = time.perf_counter() - t0
    check(rc == 0 and gpu_lines == cpu_lines, f"phase 16: v2_author_verify gpu printed {gpu_lines!r}, hashlib {cpu_lines!r}")
    got = launches["v2_author_verify gpu"]
    check(got["sha256_cuda"] > 0 and got["sha256_merkle_cuda"] > 0, f"phase 16: v2_author_verify launched {got}")
    log(f"phase 16: v2_author_verify gpu: {' / '.join(gpu_lines.splitlines())}")
    log(f"time: ci example v2_author_verify gpu s={gpu_s:.3f} hashlib s={cpu_s:.3f} launches {got} {card}")
    log(
        f"phase 16: the gate on the card: lint and its SARIF artifact held, the armed bench compare passed, "
        f"the eight doctor smokes PASS with --json parity in one process ({doctor_s:.3f} s), the examples' "
        f"lines equal hashlib's with the kernels launched"
    )
    log(f"time: ci phase 16 wall s={time.perf_counter() - t_phase:.3f} {card}")
    return launches


# ---------------------------------------------------------------- phase 17

MESH_FLIP_PIECE = 7777  # 17a's flipped piece of phase 4's 2 GiB file
MESH_FLIP_OFF = MESH_FLIP_PIECE * PIECE + 4_321
MESH_SCHED_PIECES = 1024  # 17c: the first 256 MiB of phase 4's 2 GiB file
MESH_RANK_ENTRIES = 2  # 17e: grid entries a rank, all on its card


def mesh_entries() -> tuple:
    """Phase 17's grid entries: every card when there are two or more,
    else the one card named twice (two entries, each with its own
    buffers and streams); and which of the two it is."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)], f"every card ({n})"
    return [torch.device("cuda", 0)] * 2, "cuda:0 named twice (one card)"


def mesh_phase(tmp: str, single: str, info, multi_root: str, multi_info, card: str) -> dict:
    """Phase 17: the v1 hash plane on a grid (see the module docstring).
    Returns each sub-phase's launches (17e: each rank's)."""
    import asyncio
    import contextlib

    from torrent_tpu_torch.codec.metainfo import InfoDict
    from torrent_tpu_torch.entry import dryrun_multichip
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.parallel import distributed as D
    from torrent_tpu_torch.parallel.mesh import make_mesh
    from torrent_tpu_torch.parallel.verify import verify_pieces, verify_pieces_sched
    from torrent_tpu_torch.sched import HashPlaneScheduler, SchedulerConfig
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent

    kernels = {
        "sha1_cuda": sha1_cuda.sha1_pieces_cuda,
        "sha256_cuda": sha256_cuda.sha256_pieces_cuda,
        "sha256_merkle_cuda": sha256_cuda.sha256_merkle_cuda,
    }
    t_phase = time.perf_counter()
    entries, which = mesh_entries()
    grid = make_mesh(entries, n_hosts=1)
    n_entries = grid.size
    log(f"phase 17: grid {grid.shape}: {[str(d) for d in grid.entries]}, {which}")
    launches: dict = {}

    def run(name, fn):
        """``fn()`` with every count at 0 just before it, read just after."""
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        value = fn()
        wall = time.perf_counter() - t
        launches[name] = {n: k.launches for n, k in kernels.items()}
        return value, wall

    @contextlib.contextmanager
    def process_cards(devs):
        """The process's cards are ``devs``: every construction site's
        default grid (no device, devices or mesh) is then the smoke's."""
        real = D.local_devices
        D.local_devices = lambda: list(devs)
        try:
            yield
        finally:
            D.local_devices = real

    def storage(i):
        return Storage(FsStorage(tmp), i)

    # -- 17a: phase 4's 2 GiB recheck through verify_pieces(mesh=grid)
    n_batches = -(-info.num_pieces // BATCH)
    bf, grid_s = run("17a clean", lambda: verify_pieces(storage(info), info, hasher="gpu", batch_size=BATCH, mesh=grid))
    check(bf.all(), f"phase 17a: clean grid recheck flags {false_rows(bf)}")
    flip_byte(single, MESH_FLIP_OFF)
    try:
        bf, grid_again_s = run(
            "17a flipped", lambda: verify_pieces(storage(info), info, hasher="gpu", batch_size=BATCH, mesh=grid)
        )
        one, one_s = run("17a one entry", lambda: verify_pieces(storage(info), info, hasher="gpu", batch_size=BATCH, device=entries[0]))
        t = time.perf_counter()
        hashed = verify_pieces(storage(info), info, hasher="cpu")
        hashlib_s = time.perf_counter() - t
    finally:
        flip_byte(single, MESH_FLIP_OFF)
    check(false_rows(bf) == [MESH_FLIP_PIECE], f"phase 17a: flipped grid recheck flags {false_rows(bf)}")
    check((bf == one).all() and (bf == hashed).all(), "phase 17a: the grid's bitfield differs from one entry's or hashlib's")
    for name in ("17a clean", "17a flipped"):
        got = launches[name]["sha1_cuda"]
        check(got == n_entries * n_batches, f"phase 17a: {name}: {got} SHA-1 launches, not {n_entries} entries x {n_batches} batches")
    check(launches["17a one entry"]["sha1_cuda"] == n_batches, f"phase 17a: one entry launched {launches['17a one entry']}")
    log(
        f"phase 17a: {info.num_pieces} x 256 KiB at batch {BATCH} on the grid: all True, the flipped byte flags "
        f"exactly piece {MESH_FLIP_PIECE}, equal to one entry's and hashlib's bitfields; "
        f"{launches['17a flipped']['sha1_cuda']} SHA-1 launches ({n_entries} entries x {n_batches} batches)"
    )
    log(
        f"time: mesh 17a recheck 2 GiB grid of {n_entries} s={grid_s:.3f} (flipped s={grid_again_s:.3f}) "
        f"one entry s={one_s:.3f} hashlib s={hashlib_s:.3f} {card}"
    )

    # -- 17b: make_torrent of phase 4's six files on the default grid
    clock = time.time
    try:
        time.time = lambda: 1_760_000_000.0  # "creation date": one clock for both
        with process_cards(entries):
            gpu_bytes, author_s = run(
                "17b make_torrent", lambda: make_torrent(multi_root, "http://localhost/announce", piece_length=PIECE, hasher="gpu")
            )
        t = time.perf_counter()
        cpu_bytes = make_torrent(multi_root, "http://localhost/announce", piece_length=PIECE, hasher="cpu")
        author_cpu_s = time.perf_counter() - t
    finally:
        time.time = clock
    check(gpu_bytes == cpu_bytes, "phase 17b: make_torrent on the grid differs from hashlib's .torrent bytes")
    author_batches = -(-multi_info.num_pieces // 256)
    got = launches["17b make_torrent"]["sha1_cuda"]
    check(got == n_entries * author_batches, f"phase 17b: {got} SHA-1 launches, not {n_entries} x {author_batches}")
    log(f"phase 17b: make_torrent of the six files ({multi_info.num_pieces} pieces) on the default grid == hashlib's bytes, {got} SHA-1 launches")
    log(f"time: mesh 17b make_torrent 184 MB grid s={author_s:.3f} hashlib s={author_cpu_s:.3f} {card}")

    # -- 17c: a scheduler whose SHA-1 lanes span the grid, 256 MiB
    head = InfoDict(
        name=info.name, piece_length=PIECE, pieces=info.pieces[:MESH_SCHED_PIECES],
        length=MESH_SCHED_PIECES * PIECE,
    )

    async def sweep():
        sched = await HashPlaneScheduler(SchedulerConfig(batch_target=1024), hasher="gpu", mesh=grid).start()
        try:
            return await verify_pieces_sched(storage(head), head, sched), sched.metrics_snapshot()
        finally:
            await sched.close()

    (bf, snap), sched_s = run("17c scheduler", lambda: asyncio.run(sweep()))
    t = time.perf_counter()
    hashed = verify_pieces(storage(head), head, hasher="cpu")
    sched_hashlib_s = time.perf_counter() - t
    check((bf == hashed).all() and bf.all(), f"phase 17c: the grid scheduler flags {false_rows(bf)}")
    check(snap["cpu_fallback_launches"] == 0 and snap["launch_failures"] == 0, f"phase 17c: {snap['cpu_fallback_launches']} cpu fallback, {snap['launch_failures']} failed launches")
    check(snap["staging"]["outstanding"] == 0, "phase 17c: ingest slabs outstanding")
    got = launches["17c scheduler"]["sha1_cuda"]
    check(got == n_entries * snap["launches"], f"phase 17c: {got} SHA-1 launches for {snap['launches']} scheduler launches")
    log(f"phase 17c: scheduler on the grid, {MESH_SCHED_PIECES} pieces: hashlib's bitfield, {snap['launches']} launches of {n_entries} entries")
    log(f"time: mesh 17c scheduler 256 MiB grid s={sched_s:.3f} hashlib s={sched_hashlib_s:.3f} {card}")

    # -- 17d: the grid dry run on the card
    out, dry_s = run("17d dryrun_multichip", lambda: dryrun_multichip(4))
    got = launches["17d dryrun_multichip"]
    check(out["valid"] == 7 and out["mesh"] == {"hosts": 2, "dp": 2}, f"phase 17d: dry run {out['mesh']} valid {out['valid']}")
    check(got == {"sha1_cuda": 8, "sha256_cuda": 4, "sha256_merkle_cuda": 5}, f"phase 17d: dry run launched {got}")
    log(f"time: mesh 17d dryrun_multichip(4) s={dry_s:.3f} {card}")

    # -- 17e: two gloo ranks of MESH_RANK_ENTRIES entries each, (2, 2)
    d = os.path.join(tmp, "dist_mesh")
    os.makedirs(d)
    shutil.copy(os.path.join(tmp, "dist", "spec.json"), os.path.join(d, "spec.json"))
    t = time.perf_counter()
    ranks = run_ranks(d, mode="mesh")
    ranks_s = time.perf_counter() - t
    for r in ranks:
        sub = r["sub"]
        check(r["grid"] == {"hosts": DIST_RANKS, "dp": MESH_RANK_ENTRIES}, f"phase 17e rank {r['rank']}: grid {r['grid']}")
        check(sub["grid clean"]["false"] == [], f"phase 17e rank {r['rank']}: clean flags {sub['grid clean']['false']}")
        check(sub["grid flipped"]["false"] == [5000], f"phase 17e rank {r['rank']}: flipped flags {sub['grid flipped']['false']}")
        check(sub["grid flipped"]["n_valid"] == info.num_pieces - 1, f"phase 17e rank {r['rank']}: n_valid {sub['grid flipped']['n_valid']}")
        for name in ("grid clean", "grid flipped"):
            got = sub[name]["launches"]["sha1_cuda"]
            check(got == MESH_RANK_ENTRIES * n_batches, f"phase 17e rank {r['rank']} {name}: {got} SHA-1 launches")
        launches[f"17e rank {r['rank']}"] = {n: sub[n]["launches"] for n in ("grid clean", "grid flipped")}
    log(
        f"phase 17e: {DIST_RANKS} gloo ranks x {MESH_RANK_ENTRIES} entries on {[r['device'] for r in ranks]}: "
        f"hashlib's bitfields, n_valid {info.num_pieces - 1} after the flip"
    )
    log(
        f"time: mesh 17e ranks s={ranks_s:.3f} (start-up included); per rank clean / flipped "
        f"{[(round(r['sub']['grid clean']['wall_s'], 3), round(r['sub']['grid flipped']['wall_s'], 3)) for r in ranks]} {card}"
    )
    log(f"time: mesh phase 17 wall s={time.perf_counter() - t_phase:.3f} {card}")
    return launches


def main() -> dict:
    import torch

    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this script needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "torrent_tpu_torch")):
        raise SmokeFailure(f"no torrent_tpu_torch/ beside {__file__}: run it from a checkout")
    sys.path.insert(0, REPO)

    from concurrent.futures import ThreadPoolExecutor

    from torrent_tpu_torch.codec.bencode import bencode
    from torrent_tpu_torch.codec.metainfo import parse_metainfo
    from torrent_tpu_torch.codec.metainfo_v2 import encode_metainfo_v2
    from torrent_tpu_torch.models.v2 import build_hybrid, build_v2, verify_v2
    from torrent_tpu_torch.native import build as native_build
    from torrent_tpu_torch.ops import sha1_cuda, sha256_cuda
    from torrent_tpu_torch.ops.padding import (
        alloc_padded,
        digests_to_words,
        num_blocks_for,
        pad_in_place,
        pad_pieces,
        padded_len_for,
        words_to_digests,
    )
    from torrent_tpu_torch.ops.sha1_torch import sha1_pieces_torch, words_to_numpy
    from torrent_tpu_torch.ops.sha256_torch import IV as IV256
    from torrent_tpu_torch.ops.sha256_torch import sha256_merkle_torch, sha256_pairs_torch, sha256_pieces_torch
    from torrent_tpu_torch.parallel.verify import verify_pieces
    from torrent_tpu_torch.session.v2 import v2_session_info
    from torrent_tpu_torch.storage.storage import FsStorage, Storage
    from torrent_tpu_torch.tools.make_torrent import make_torrent
    from torrent_tpu_torch.ops.work import SHA1_BLOCK_OPS, SHA256_BLOCK_OPS
    from torrent_tpu_torch.tools.time_merkle import bound_ms, hashlib_roots, smi, time_shapes

    sha256_rows = sha256_cuda.sha256_pieces_cuda
    sha256_pairs = sha256_cuda.sha256_pairs_cuda
    sha256_merkle = sha256_cuda.sha256_merkle_cuda

    # ---------------------------------------------------------------- 1
    name_and_limit = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    card = f"[{name_and_limit}]"
    log(name_and_limit)
    log(f"phase 1: device {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------------- 2
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = {
            mod.LIBRARY.name: pool.submit(mod.build, force=True) for mod in (sha1_cuda, sha256_cuda)
        }
        pread_pool = pool.submit(native_build.build, force=True)
        reports = {name: fut.result() for name, fut in builds.items()}
        check(pread_pool.result() is not None, "the host pread pool did not build")
    log(f"phase 2: built {', '.join(reports)} and the host pread pool in {time.perf_counter() - t:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
                log(f"  ptxas ({name}): {line.strip()}")
    log(
        f"  shared memory (sha1): {sha1_cuda.smem_bytes()} bytes of dynamic shared memory per CTA "
        f"of 32 pieces, {sha1_cuda.ctas_per_sm()} CTAs per SM"
    )
    for mod in (sha1_cuda, sha256_cuda):
        for fn, ops in sass_opcodes(mod.LIBRARY).items():
            log(f"  sass ({mod.LIBRARY.name}): {fn} {sum(ops.values())} instructions")
            if mod is sha1_cuda:
                log(f"  sass mix ({mod.LIBRARY.name}): {' '.join(f'{k}={v}' for k, v in ops.most_common())}")

    def mismatches(a, b) -> int:
        return int((a != b).any(dim=1).sum())

    def abs_err(a, b) -> int:
        return int(((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)).abs().max())

    def digests(words):
        return words_to_digests(words_to_numpy(words))

    def plain_timed(fn, *args):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    # ---------------------------------------------------------------- 3
    def kernel_and_plain(kernel, plain, pieces, sentinel_rows=()):
        padded, nblocks = pad_pieces(pieces)
        nblocks[list(sentinel_rows)] = 0
        d = torch.from_numpy(padded).to(dev)
        n = torch.from_numpy(nblocks).to(dev)
        k_u8 = kernel(d, n)
        k_u32 = kernel(d.view(torch.int32), n)
        p = plain(d, n)
        torch.cuda.synchronize()
        return k_u8, k_u32, p

    rng = np.random.default_rng(SEED)
    clock_phase3 = smi("clocks.sm")
    total_mismatch = 0
    # NIST vectors
    k, k32, p = kernel_and_plain(sha1_cuda.sha1_pieces_cuda, sha1_pieces_torch, [m for m, _ in NIST])
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    check([d.hex() for d in digests(k)] == [h for _, h in NIST], "NIST vectors wrong")
    # ragged lengths, then the same rows with sentinels
    ragged = [rng.bytes(n) for n in RAGGED]
    k, k32, p = kernel_and_plain(sha1_cuda.sha1_pieces_cuda, sha1_pieces_torch, ragged)
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    check(digests(k) == [hashlib.sha1(x).digest() for x in ragged], "ragged batch wrong")
    sentinels = (0, 3, 13)
    k, k32, p = kernel_and_plain(sha1_cuda.sha1_pieces_cuda, sha1_pieces_torch, ragged, sentinels)
    total_mismatch += mismatches(k, p) + mismatches(k32, p)
    iv = bytes.fromhex("67452301efcdab8998badcfe10325476c3d2e1f0")
    got = digests(k)
    for i, x in enumerate(ragged):
        check(got[i] == (iv if i in sentinels else hashlib.sha1(x).digest()), f"sentinel batch row {i}")
    # batches that end in a partial CTA of the kernel's 32 pieces
    for rows, longest in CTA_BATCHES:
        pieces = [rng.bytes(int(n)) for n in rng.integers(0, longest, size=rows)]
        k, k32, p = kernel_and_plain(sha1_cuda.sha1_pieces_cuda, sha1_pieces_torch, pieces, (1, rows - 1))
        total_mismatch += mismatches(k, p) + mismatches(k32, p)
        got = digests(k)
        for i, x in enumerate(pieces):
            check(got[i] == (iv if i in (1, rows - 1) else hashlib.sha1(x).digest()), f"{rows}-row batch row {i}")
    # one full recheck batch: 4096 pieces of 256 KiB
    full = [rng.bytes(PIECE) for _ in range(BATCH)]
    padded, nblocks = pad_pieces(full)
    d256 = torch.from_numpy(padded).to(dev)
    n256 = torch.from_numpy(nblocks).to(dev)
    del padded
    k = sha1_cuda.sha1_pieces_cuda(d256, n256)
    p, plain_ms = plain_timed(sha1_pieces_torch, d256, n256)
    total_mismatch += mismatches(k, p)
    max_abs_err = abs_err(k, p)
    want = [hashlib.sha1(x).digest() for x in full]
    check(digests(k) == want, "full batch: kernel disagrees with hashlib")
    check(digests(p) == want, "full batch: plain version disagrees with hashlib")
    del full, want
    log(f"kernels: sha1_cuda launches={sha1_cuda.sha1_pieces_cuda.launches} mismatches={total_mismatch}")
    check(total_mismatch == 0 and max_abs_err == 0, "kernel disagrees with its plain version")
    log(
        f"phase 3: sha1 kernel == plain == hashlib on NIST, ragged, sentinel, "
        f"{', '.join(str(r) for r, _ in CTA_BATCHES)}-row and {BATCH} x 256 KiB batches"
    )

    # SHA-256 rows: NIST vectors, ragged lengths with sentinels, u8 and int32
    mis256 = 0
    k, k32, p = kernel_and_plain(sha256_rows, sha256_pieces_torch, [m for m, _ in NIST256])
    mis256 += mismatches(k, p) + mismatches(k32, p)
    check([d.hex() for d in digests(k)] == [h for _, h in NIST256], "sha256: NIST vectors wrong")
    check([d.hex() for d in digests(p)] == [h for _, h in NIST256], "sha256 plain: NIST vectors wrong")
    padded, nblocks = pad_pieces([b"a" * 1_000_000])
    k = sha256_rows(torch.from_numpy(padded).to(dev), torch.from_numpy(nblocks).to(dev))
    check(digests(k)[0].hex() == MILLION_A256, "sha256: 1,000,000 x 'a' wrong")
    ragged = [rng.bytes(n) for n in RAGGED256]
    iv256 = words_to_digests(np.asarray([IV256], dtype=np.uint32))[0]
    for sentinels in ((), (0, 4, 12)):
        k, k32, p = kernel_and_plain(sha256_rows, sha256_pieces_torch, ragged, sentinels)
        mis256 += mismatches(k, p) + mismatches(k32, p)
        got = digests(k)
        for i, x in enumerate(ragged):
            want = iv256 if i in sentinels else hashlib.sha256(x).digest()
            check(got[i] == want, f"sha256 ragged row {i} (sentinels {sentinels})")
    # one full authoring leaf launch: 32768 leaves of 16 KiB
    leaf_padded, leaf_view = alloc_padded(LEAF_LAUNCH, LEAF)
    leaf_view[:] = np.frombuffer(rng.bytes(LEAF_LAUNCH * LEAF), dtype=np.uint8).reshape(LEAF_LAUNCH, LEAF)
    leaf_nb = pad_in_place(leaf_padded, np.full(LEAF_LAUNCH, LEAF))
    d_leaf = torch.from_numpy(leaf_padded).to(dev)
    n_leaf = torch.from_numpy(leaf_nb).to(dev)
    k, first_leaf_ms = plain_timed(sha256_rows, d_leaf, n_leaf)  # the first launch at this shape
    k32 = sha256_rows(d_leaf.view(torch.int32), n_leaf)
    p, plain256_ms = plain_timed(sha256_pieces_torch, d_leaf, n_leaf)
    mis256 += mismatches(k, p) + mismatches(k32, p)
    err256 = abs_err(k, p)
    want = [hashlib.sha256(leaf_view[i].tobytes()).digest() for i in range(LEAF_LAUNCH)]
    check(digests(k) == want, "leaf launch: kernel disagrees with hashlib")
    check(digests(p) == want, "leaf launch: plain version disagrees with hashlib")
    del leaf_padded, leaf_view, want
    log(f"kernels: sha256_cuda launches={sha256_rows.launches} mismatches={mis256}")
    check(mis256 == 0 and err256 == 0, "sha256 kernel disagrees with its plain version")
    # one merkle level: random child digests, parents against hashlib
    kids = rng.bytes(PAIRS * 64)
    pair_words = torch.from_numpy(
        digests_to_words([kids[i : i + 32] for i in range(0, len(kids), 32)], words=8)
        .reshape(PAIRS, 16).view(np.int32)
    ).to(dev)
    k = sha256_pairs(pair_words)
    p, plain_pairs_ms = plain_timed(sha256_pairs_torch, pair_words)
    mis_pairs = mismatches(k, p)
    err_pairs = abs_err(k, p)
    want = [hashlib.sha256(kids[i : i + 64]).digest() for i in range(0, len(kids), 64)]
    check(digests(k) == want, "pair level: kernel disagrees with hashlib")
    check(digests(p) == want, "pair level: plain version disagrees with hashlib")
    del kids, want
    log(f"kernels: sha256_pairs_cuda launches={sha256_pairs.launches} mismatches={mis_pairs}")
    check(mis_pairs == 0 and err_pairs == 0, "pair kernel disagrees with its plain version")
    # whole merkle reductions: random node words, roots against hashlib
    mis_merkle = err_merkle = 0
    for b, l in MERKLE_SHAPES:
        levels = l.bit_length() - 1
        grid = rng.integers(0, 2**32, size=(b, l, 8), dtype=np.uint32)
        words = torch.from_numpy(grid.reshape(-1, 8).view(np.int32)).to(dev)
        launches0 = sha256_merkle.launches
        k = sha256_merkle(words, levels)
        check(
            sha256_merkle.launches - launches0 == len(sha256_cuda.merkle_passes(levels)),
            f"merkle [{b}, {l}]: launches differ from the pass plan",
        )
        p, ms = plain_timed(sha256_merkle_torch, words, levels)
        if (b, l) == MERKLE_RECORD:
            plain_merkle_ms = ms
        mis_merkle += mismatches(k, p)
        err_merkle = max(err_merkle, abs_err(k, p))
        want = hashlib_roots(grid)
        check(digests(k) == want, f"merkle [{b}, {l}]: kernel disagrees with hashlib")
        check(digests(p) == want, f"merkle [{b}, {l}]: plain version disagrees with hashlib")
    log(f"kernels: sha256_merkle_cuda launches={sha256_merkle.launches} mismatches={mis_merkle}")
    check(mis_merkle == 0 and err_merkle == 0, "merkle kernel disagrees with its plain version")
    log(
        f"phase 3: sha256 kernels == plain == hashlib on NIST (+ 1,000,000 x 'a' vs hashlib), "
        f"ragged, sentinel, {LEAF_LAUNCH} x 16 KiB leaf and {PAIRS}-pair level batches, and merkle "
        f"reductions of {', '.join(f'[{b}, {l}]' for b, l in MERKLE_SHAPES)} trees"
    )

    # ---------------------------------------------------------------- 4
    def recheck_stages(storage) -> dict:
        """Seconds of each stage of one full recheck batch, run apart:
        a pinned slot's allocation, the loader's read (4 striped
        read_batch calls, as verify_storage makes them) and padding on
        the host clock, the host→device copy on CUDA events. The
        kernel's time comes from phase 6."""
        ta = time.perf_counter()
        host = torch.empty((BATCH, padded_len_for(PIECE)), dtype=torch.uint8, pin_memory=True)
        alloc_s = time.perf_counter() - ta
        padded = host.numpy()
        view = padded[:, :PIECE]
        step = BATCH // 4
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [
                pool.submit(storage.read_batch, range(s, s + step), out=view[s : s + step])
                for s in range(0, BATCH, step)
            ]
            for f in futs:
                f.result()
        t1 = time.perf_counter()
        padded[:, PIECE:] = 0
        pad_in_place(padded, np.full(BATCH, PIECE))
        t2 = time.perf_counter()
        dev_buf = torch.empty(host.shape, dtype=torch.uint8, device=dev)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dev_buf.copy_(host, non_blocking=True)
        b.record()
        torch.cuda.synchronize()
        return {
            "alloc_s": alloc_s, "read_s": t1 - t0, "pad_s": t2 - t1,
            "h2d_s": a.elapsed_time(b) / 1e3,
        }

    def v2_stages(path: str, info) -> dict:
        """Seconds of each stage of one v2 authoring launch (the file's
        first LEAF_LAUNCH leaves) and one v2 recheck batch (256 pieces of
        1 MiB), run apart as ``build_v2`` and ``verify_pieces`` run them:
        the host stages on the host clock, the device work (host→device
        copy, kernels) on CUDA events."""
        from torrent_tpu_torch.models.merkle import _merkle_reduce_fused
        from torrent_tpu_torch.models.v2 import _LeafPlane
        from torrent_tpu_torch.native.io_engine import get_engine

        def on_device(fn):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            return out, a.elapsed_time(b) / 1e3

        n = LEAF_LAUNCH * LEAF
        step = n // 4
        buf = np.empty(n, dtype=np.uint8)
        t0 = time.perf_counter()
        get_engine().read_segments([path], [(0, o, o, step) for o in range(0, n, step)], buf)
        t1 = time.perf_counter()
        chunk = buf.tobytes()
        t2 = time.perf_counter()
        plane = _LeafPlane(LEAF_LAUNCH, dev)
        t3 = time.perf_counter()
        k = plane.stage_bytes(chunk)
        t4 = time.perf_counter()
        words, author_dev_s = on_device(lambda: plane.launch(k))
        t5 = time.perf_counter()
        words_to_numpy(words)
        t6 = time.perf_counter()
        del plane, chunk, buf
        storage = Storage(FsStorage(os.path.dirname(path)), info)
        pieces = list(range(256))
        t7 = time.perf_counter()
        pbuf, lengths = storage.read_batch(pieces)
        t8 = time.perf_counter()
        plane = _LeafPlane(VERIFY_LEAVES, dev)
        t9 = time.perf_counter()
        plane.stage_pieces(pbuf, lengths, 64)
        t10 = time.perf_counter()
        merkle0 = sha256_merkle.launches
        _, verify_dev_s = on_device(lambda: _merkle_reduce_fused(plane.launch_grid(256, 64), 6))
        return {
            "verify_merkle_launches": sha256_merkle.launches - merkle0,
            "author_read_s": t1 - t0, "author_tobytes_s": t2 - t1, "author_alloc_s": t3 - t2,
            "author_stage_s": t4 - t3, "author_device_s": author_dev_s, "author_d2h_s": t6 - t5,
            "verify_read_s": t8 - t7, "verify_alloc_s": t9 - t8, "verify_stage_s": t10 - t9,
            "verify_device_s": verify_dev_s,
        }

    def reset_counts() -> None:
        sha1_cuda.sha1_pieces_cuda.launches = 0
        sha256_rows.launches = 0
        sha256_pairs.launches = 0
        sha256_merkle.launches = 0

    reset_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        single = os.path.join(tmp, "single.bin")
        write_random(single, SINGLE_BYTES, rng)
        multi_root = os.path.join(tmp, "multi")
        for rel, size in MULTI_FILES:
            write_random(os.path.join(multi_root, rel), size, rng)
        log(f"phase 4: wrote {SINGLE_BYTES} + {sum(s for _, s in MULTI_FILES)} seeded bytes")

        results = {}
        infos = {}
        torrents = {}  # the authored bytes phase 8's ranks parse
        for label, path, storage_root in (
            ("single", single, tmp),
            ("multi", multi_root, tmp),
        ):
            t = time.perf_counter()
            gpu_torrent = make_torrent(path, "http://localhost/announce", piece_length=PIECE, hasher="gpu")
            author_s = time.perf_counter() - t
            t = time.perf_counter()
            cpu_torrent = make_torrent(path, "http://localhost/announce", piece_length=PIECE, hasher="cpu")
            author_cpu_s = time.perf_counter() - t
            meta = parse_metainfo(gpu_torrent)
            torrents[label] = gpu_torrent
            check(meta is not None, f"{label}: authored torrent does not parse")
            check(
                meta.info.pieces == parse_metainfo(cpu_torrent).info.pieces,
                f"{label}: gpu authoring differs from hashlib authoring",
            )
            info = infos[label] = meta.info
            launches0 = sha1_cuda.sha1_pieces_cuda.launches
            t = time.perf_counter()
            bf = verify_pieces(Storage(FsStorage(storage_root), info), info, hasher="gpu", batch_size=BATCH)
            gpu_s = time.perf_counter() - t
            batch_launches = sha1_cuda.sha1_pieces_cuda.launches - launches0
            check(bf.shape == (info.num_pieces,) and bf.all(), f"{label}: clean recheck not all True")
            if label == "single":
                stages = recheck_stages(Storage(FsStorage(storage_root), info))
            # flip one byte deep in the file (single) or inside a piece
            # that spans a file boundary (multi); a fresh FsStorage drops
            # cached handles, as a new process would
            if label == "single":
                victim, off = single, 5000 * PIECE + 777
                bad_piece = 5000
            else:
                # 12,345 bytes into d.bin, whose first piece also holds
                # the tail of the file before it in the torrent's order
                victim, off = os.path.join(multi_root, "d.bin"), 12_345
                start = 0
                for entry in info.files:
                    if entry.path == ("d.bin",):
                        break
                    start += entry.length
                bad_piece = (start + off) // PIECE
                check(start % PIECE != 0, "d.bin should start inside a piece")
            flip_byte(victim, off)
            t = time.perf_counter()
            bf = verify_pieces(Storage(FsStorage(storage_root), info), info, hasher="gpu", batch_size=BATCH)
            gpu_again_s = time.perf_counter() - t
            check(
                list(np.nonzero(~bf)[0]) == [bad_piece],
                f"{label}: expected only piece {bad_piece} False, got {list(np.nonzero(~bf)[0])}",
            )
            t = time.perf_counter()
            cpu_bf = verify_pieces(Storage(FsStorage(storage_root), info), info, hasher="cpu")
            cpu_s = time.perf_counter() - t
            check((cpu_bf == bf).all(), f"{label}: hashlib recheck disagrees with the gpu recheck")
            flip_byte(victim, off)  # restore the seeded payload for phase 5
            results[label] = dict(
                pieces=info.num_pieces, bytes=info.length, gpu_s=gpu_s,
                gpu_again_s=gpu_again_s, cpu_s=cpu_s,
                author_s=author_s, author_cpu_s=author_cpu_s, batch_launches=batch_launches,
            )
            log(
                f"phase 4: {label}: {info.num_pieces} pieces authored (gpu == hashlib), "
                f"recheck all True, flipped byte flags exactly piece {bad_piece}, "
                f"{batch_launches} kernel launches per recheck"
            )
        main_launches = sha1_cuda.sha1_pieces_cuda.launches
        check(main_launches > 0, "the v1 main path launched the SHA-1 kernel no time")
        log(f"phase 4: v1 main path launched sha1_cuda {main_launches} times")

        # ------------------------------------------------------------ 5
        reset_counts()
        v2_results = {}
        multi_files = [(tuple(rel.split("/")), os.path.join(multi_root, rel)) for rel, _ in MULTI_FILES]
        for label, files, name, source_of, victim, off in (
            ("single", [(("single.bin",), single)], "single.bin",
             lambda p: single if p == ("single.bin",) else None,
             ("single.bin",), 5000 * PIECE + 777),
            ("multi", multi_files, "multi",
             lambda p: os.path.join(multi_root, *p),
             ("d.bin",), 12_345),
        ):
            def read_file(path):
                src = source_of(path)
                return src if src is not None and os.path.exists(src) else None

            t = time.perf_counter()
            gpu_meta = build_v2(files, name, V2_PIECE, hasher="gpu", announce="http://localhost/announce")
            author_s = time.perf_counter() - t
            t = time.perf_counter()
            cpu_meta = build_v2(files, name, V2_PIECE, hasher="cpu", announce="http://localhost/announce")
            author_cpu_s = time.perf_counter() - t
            check(bencode(gpu_meta.raw) == bencode(cpu_meta.raw), f"v2 {label}: gpu authoring differs from hashlib")
            hybrid = ""
            if label == "multi":
                t = time.perf_counter()
                blob_gpu, _ = build_hybrid(files, name, V2_PIECE, hasher="gpu", announce="http://localhost/announce")
                hybrid_s = time.perf_counter() - t
                t = time.perf_counter()
                blob_cpu, _ = build_hybrid(files, name, V2_PIECE, hasher="cpu", announce="http://localhost/announce")
                hybrid_cpu_s = time.perf_counter() - t
                check(blob_gpu == blob_cpu, "hybrid: gpu authoring differs from hashlib")
                hybrid = f"hybrid author gpu s={hybrid_s:.3f} hashlib s={hybrid_cpu_s:.3f}"
            info = v2_session_info(gpu_meta.info, gpu_meta.piece_layers)
            t = time.perf_counter()
            res = verify_v2(read_file, gpu_meta, hasher="gpu")
            verify_v2_s = time.perf_counter() - t
            check(all(ok.all() for ok in res.values()), f"v2 {label}: clean verify_v2 not all True")
            t = time.perf_counter()
            bf = verify_pieces(Storage(FsStorage(tmp), info), info, hasher="gpu")
            vp_s = time.perf_counter() - t
            check(bf.shape == (info.num_pieces,) and bf.all(), f"v2 {label}: clean verify_pieces not all True")
            if label == "single":
                single_v2_info = info
                torrents["v2 single"] = encode_metainfo_v2(gpu_meta.info, gpu_meta.piece_layers)
            else:
                v2_multi_meta = gpu_meta  # phase 10's v2 swarm
            # the flat piece index of the flipped byte (files start on
            # piece boundaries in v2's piece space)
            first = 0
            for f in gpu_meta.info.files:
                if f.path == victim:
                    break
                first += f.num_pieces(V2_PIECE)
            bad_piece = first + off // V2_PIECE
            victim_path = source_of(victim)
            flip_byte(victim_path, off)
            t = time.perf_counter()
            res = verify_v2(read_file, gpu_meta, hasher="gpu")
            verify_v2_again_s = time.perf_counter() - t
            for path, ok in res.items():
                want_bad = [off // V2_PIECE] if path == victim else []
                check(list(np.nonzero(~ok)[0]) == want_bad, f"v2 {label}: verify_v2 flags {path} {list(np.nonzero(~ok)[0])}")
            t = time.perf_counter()
            res_cpu = verify_v2(read_file, gpu_meta, hasher="cpu")
            verify_v2_cpu_s = time.perf_counter() - t
            check(all((res_cpu[p] == ok).all() for p, ok in res.items()), f"v2 {label}: hashlib verify_v2 disagrees")
            t = time.perf_counter()
            bf = verify_pieces(Storage(FsStorage(tmp), info), info, hasher="gpu")
            vp_again_s = time.perf_counter() - t
            check(
                list(np.nonzero(~bf)[0]) == [bad_piece],
                f"v2 {label}: expected only piece {bad_piece} False, got {list(np.nonzero(~bf)[0])}",
            )
            t = time.perf_counter()
            cpu_bf = verify_pieces(Storage(FsStorage(tmp), info), info, hasher="cpu")
            vp_cpu_s = time.perf_counter() - t
            check((cpu_bf == bf).all(), f"v2 {label}: hashlib recheck disagrees with the gpu recheck")
            flip_byte(victim_path, off)
            v2_results[label] = dict(
                pieces=info.num_pieces, bytes=info.payload_length, author_s=author_s,
                author_cpu_s=author_cpu_s, verify_v2_s=verify_v2_s,
                verify_v2_again_s=verify_v2_again_s, verify_v2_cpu_s=verify_v2_cpu_s,
                vp_s=vp_s, vp_again_s=vp_again_s, vp_cpu_s=vp_cpu_s, hybrid=hybrid,
            )
            log(
                f"phase 5: v2 {label}: {info.num_pieces} pieces of 1 MiB authored (gpu == hashlib"
                f"{', hybrid gpu == hashlib' if hybrid else ''}), verify_v2 and verify_pieces all True, "
                f"flipped byte flags exactly piece {bad_piece}"
            )
        v2_launches = {
            "sha256_cuda": sha256_rows.launches,
            "sha256_merkle_cuda": sha256_merkle.launches,
            "sha256_pairs_cuda": sha256_pairs.launches,
            "sha1_cuda": sha1_cuda.sha1_pieces_cuda.launches,
        }
        for name in ("sha256_cuda", "sha256_merkle_cuda", "sha1_cuda"):
            check(v2_launches[name] > 0, f"the v2 main path launched {name} no time")
        check(
            v2_launches["sha256_merkle_cuda"] <= MERKLE_PATH_MAX,
            f"the v2 main path made {v2_launches['sha256_merkle_cuda']} merkle launches, more than {MERKLE_PATH_MAX}",
        )
        log(f"phase 5: v2 main path launches {v2_launches}")
        # measured after the counts are read: its launches are not the path's
        stages_v2 = v2_stages(single, single_v2_info)

        # ------------------------------------------------------------ 7
        sched_launches, lib_torrents, lib_sweep = sched_phase(tmp, single, multi_root, infos["multi"], rng, card)

        # ------------------------------------------------------------ 8
        single_walls = {
            "v1": results["single"]["gpu_s"], "v1 again": results["single"]["gpu_again_s"],
            "v2": v2_results["single"]["vp_s"], "v2 again": v2_results["single"]["vp_again_s"],
        }
        dist_launches = dist_phase(tmp, torrents, lib_torrents, single_walls, card)

        # ------------------------------------------------------------ 9
        baselines = {
            "v1_s": results["single"]["gpu_again_s"], "v1_hashlib_s": results["single"]["cpu_s"],
            "lib_s": lib_sweep["sched_s"], "lib_hashlib_s": lib_sweep["hashlib_s"], "lib_bytes": lib_sweep["bytes"],
        }
        bridge_launches = bridge_phase(tmp, single, torrents["single"], lib_torrents, baselines, card)

        # ----------------------------------------------------------- 10
        session_launches = session_phase(tmp, lib_torrents, v2_multi_meta, card)

        # ----------------------------------------------------------- 11
        magnet_launches = magnet_phase(tmp, v2_multi_meta, rng, card)

        # ----------------------------------------------------------- 12
        serving_launches = serving_phase(tmp, v2_multi_meta, rng, card)

        # ----------------------------------------------------------- 13
        cli_launches = cli_phase(tmp, single, multi_root, rng, card)

        # ----------------------------------------------------------- 14
        bench_out = bench_phase(tmp, card)

        # ----------------------------------------------------------- 15
        analysis_launches = analysis_phase(tmp, single, lib_torrents, card)

        # ----------------------------------------------------------- 16
        ci_launches = ci_phase(tmp, card)

        # ----------------------------------------------------------- 17
        mesh_launches = mesh_phase(tmp, single, infos["single"], multi_root, infos["multi"], card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---------------------------------------------------------------- 6
    clock_phase6 = smi("clocks.sm")

    def time_kernel(fn, *args, reps=10) -> float:
        for _ in range(2):
            fn(*args)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def rows_bound(nb: torch.Tensor, words_out: int, ops_per_block: int) -> tuple[float, str]:
        blocks = int(nb.to(torch.int64).sum())
        rows = nb.shape[0]
        # blocks read, counts read, words written
        return bound_ms(blocks * ops_per_block, blocks * 64 + rows * 4 + rows * 4 * words_out)

    def device_rows(rows: int, piece: int):
        """``rows`` seeded random pieces of ``piece`` bytes, made and padded
        on the card as ops/padding.py pads them, and their block counts."""
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + rows)
        d = torch.randint(0, 256, (rows, padded_len_for(piece)), dtype=torch.uint8, device=dev, generator=g)
        nblk = int(num_blocks_for(piece))
        d[:, piece:] = 0
        d[:, piece] = 0x80
        d[:, nblk * 64 - 8 : nblk * 64] = torch.tensor(
            list((piece * 8).to_bytes(8, "big")), dtype=torch.uint8, device=dev
        )
        return d, torch.full((rows,), nblk, dtype=torch.int32, device=dev)

    def timed_and_checked(d, n, piece: int, label: str):
        """The SHA-1 kernel's ms per launch on (d, n), and a few rows of
        one launch's output against hashlib."""
        ms = time_kernel(sha1_cuda.sha1_pieces_cuda, d, n)
        got = digests(sha1_cuda.sha1_pieces_cuda(d, n))
        rows = d.shape[0]
        for i in sorted({0, 1, 31, 32, rows // 2, rows - 1} & set(range(rows))):
            want = hashlib.sha1(d[i, :piece].cpu().numpy().tobytes()).digest()
            check(got[i] == want, f"{label}: row {i} disagrees with hashlib")
        return ms

    ms_256 = time_kernel(sha1_cuda.sha1_pieces_cuda, d256, n256)
    bound_256, by_256 = rows_bound(n256, 5, SHA1_BLOCK_OPS)
    del d256
    # 4096 x 1 MiB (every row a full 1 MiB piece)
    mib = 1 << 20
    rows = BATCH
    d1m, n1m = device_rows(rows, mib)
    ms_1m = timed_and_checked(d1m, n1m, mib, "1 MiB rows")
    bound_1m, by_1m = rows_bound(n1m, 5, SHA1_BLOCK_OPS)
    del d1m
    # the batch sweep at 256 KiB: leading slices of one device batch
    d_sweep, n_sweep = device_rows(max(SWEEP_ROWS), PIECE)
    sweep = {}
    for r in SWEEP_ROWS:
        ms = timed_and_checked(d_sweep[:r], n_sweep[:r], PIECE, f"sweep {r} rows")
        sweep[r] = (ms, *rows_bound(n_sweep[:r], 5, SHA1_BLOCK_OPS))
    del d_sweep

    ms_leaf = time_kernel(sha256_rows, d_leaf, n_leaf)
    bound_leaf, by_leaf = rows_bound(n_leaf, 8, SHA256_BLOCK_OPS)
    ms_verify_leaf = time_kernel(sha256_rows, d_leaf[:VERIFY_LEAVES], n_leaf[:VERIFY_LEAVES])
    bound_verify_leaf, by_verify_leaf = rows_bound(n_leaf[:VERIFY_LEAVES], 8, SHA256_BLOCK_OPS)
    del d_leaf
    # the merkle reduction at the v2 paths' shapes and one pair level; the
    # JSON records take the device's own time (the host's launch work is
    # on the time: lines) at the authoring piece grid, whose plain version
    # phase 3 timed, and at the pair level
    merkle_times = {r["name"]: r for r in time_shapes()}
    pair_rec, grid_rec = merkle_times["pair level"], merkle_times["authoring piece grid"]
    b, l, _ = grid_rec["shape"]
    check((b, l) == MERKLE_RECORD, f"time_merkle's authoring piece grid is [{b}, {l}, 8], not {MERKLE_RECORD}")

    s, m = results["single"], results["multi"]
    log(f"time: sha1_cuda {BATCH} x 256 KiB ms={ms_256:.4f} bound_ms={bound_256:.4f} ({by_256}) {card}")
    log(f"time: sha1_cuda {rows} x 1 MiB ms={ms_1m:.4f} bound_ms={bound_1m:.4f} ({by_1m}) {card}")
    for r, (ms, bound, by) in sweep.items():
        log(f"time: sha1_cuda sweep {r} x 256 KiB ms={ms:.4f} bound_ms={bound:.4f} ({by}) {card}")
    log(f"time: sha1_torch (plain) {BATCH} x 256 KiB ms={plain_ms:.1f} {card}")
    log(f"time: sha256_cuda {LEAF_LAUNCH} x 16 KiB ms={ms_leaf:.4f} bound_ms={bound_leaf:.4f} ({by_leaf}) {card}")
    log(
        f"time: sha256_cuda {VERIFY_LEAVES} x 16 KiB ms={ms_verify_leaf:.4f} "
        f"bound_ms={bound_verify_leaf:.4f} ({by_verify_leaf}) {card}"
    )
    log(
        f"time: sha256_cuda first launch of the process at {LEAF_LAUNCH} x 16 KiB "
        f"ms={first_leaf_ms:.4f}; SM clock before phase 3 {clock_phase3}, before phase 6 {clock_phase6} {card}"
    )
    log(f"time: sha256_torch (plain) {LEAF_LAUNCH} x 16 KiB ms={plain256_ms:.1f} {card}")
    log(f"time: sha256_pairs_torch (plain) {PAIRS} pairs ms={plain_pairs_ms:.1f} {card}")
    log(f"time: sha256_merkle_torch (plain) [{b}, {l}, 8] ms={plain_merkle_ms:.1f} {card}")
    for label, r in (("single 2 GiB", s), ("multi 184 MB", m)):
        log(
            f"time: recheck {label} gpu pieces/s={r['pieces'] / r['gpu_s']:.1f} "
            f"GiB/s={r['bytes'] / r['gpu_s'] / 2**30:.3f} s={r['gpu_s']:.3f} "
            f"(second recheck in the process s={r['gpu_again_s']:.3f}); "
            f"hashlib pieces/s={r['pieces'] / r['cpu_s']:.1f} s={r['cpu_s']:.3f}; "
            f"author gpu s={r['author_s']:.3f} hashlib s={r['author_cpu_s']:.3f} {card}"
        )
    for label, r in (("single 2 GiB", v2_results["single"]), ("multi 184 MB", v2_results["multi"])):
        log(
            f"time: v2 {label} (1 MiB pieces) build_v2 gpu s={r['author_s']:.3f} "
            f"hashlib s={r['author_cpu_s']:.3f}; verify_v2 gpu s={r['verify_v2_s']:.3f} "
            f"GiB/s={r['bytes'] / r['verify_v2_s'] / 2**30:.3f} (after the flip s={r['verify_v2_again_s']:.3f}) "
            f"hashlib s={r['verify_v2_cpu_s']:.3f}; verify_pieces gpu s={r['vp_s']:.3f} "
            f"pieces/s={r['pieces'] / r['vp_s']:.1f} (after the flip s={r['vp_again_s']:.3f}) "
            f"hashlib s={r['vp_cpu_s']:.3f} pieces/s={r['pieces'] / r['vp_cpu_s']:.1f}"
            f"{'; ' + r['hybrid'] if r['hybrid'] else ''} {card}"
        )
    log(
        "time: v2 stages, one authoring launch of "
        f"{LEAF_LAUNCH} leaves: read (4 stripes) s={stages_v2['author_read_s']:.4f} "
        f"tobytes s={stages_v2['author_tobytes_s']:.4f} staging alloc s={stages_v2['author_alloc_s']:.4f} "
        f"stage+pad s={stages_v2['author_stage_s']:.4f} h2d+kernel s={stages_v2['author_device_s']:.4f} "
        f"words d2h s={stages_v2['author_d2h_s']:.4f}; one recheck batch of 256 x 1 MiB: "
        f"read_batch s={stages_v2['verify_read_s']:.4f} staging alloc s={stages_v2['verify_alloc_s']:.4f} "
        f"stage_pieces s={stages_v2['verify_stage_s']:.4f} h2d+leaf kernel+"
        f"{stages_v2['verify_merkle_launches']} merkle launch(es) s={stages_v2['verify_device_s']:.4f} {card}"
    )
    log("time: library_ms none (no single PyTorch call computes SHA-1 or SHA-256)")
    batches = -(-s["pieces"] // BATCH)
    device_s = batches * (stages["h2d_s"] + ms_256 / 1e3)
    log(
        f"time: recheck stages per {BATCH} x 256 KiB batch: pinned 1 GiB slot alloc "
        f"s={stages['alloc_s']:.4f} read (4 stripes) s={stages['read_s']:.4f} "
        f"pad s={stages['pad_s']:.4f} h2d s={stages['h2d_s']:.4f} kernel s={ms_256 / 1e3:.4f}; "
        f"device busy share of the 2 GiB recheck (h2d + kernel) = {device_s / s['gpu_s']:.3f} {card}"
    )

    def record(name, source, replaces, launches, err, ms, plain, bound, by):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        }

    kernels = {
        "kernels": [
            {**record("sha1_cuda", "torrent_tpu_torch/csrc/sha1.cu", "torrent_tpu/ops/sha1_pallas.py:151",
                      main_launches, max_abs_err, ms_256, plain_ms, bound_256, by_256),
             "variants": bench_out["variants"]["sha1_cuda"]},
            {**record("sha256_cuda", "torrent_tpu_torch/csrc/sha256.cu", "torrent_tpu/ops/sha256_pallas.py:200",
                      v2_launches["sha256_cuda"], err256, ms_leaf, plain256_ms, bound_leaf, by_leaf),
             "variants": bench_out["variants"]["sha256_cuda"]},
            record("sha256_pairs_cuda", "torrent_tpu_torch/csrc/sha256.cu", "torrent_tpu/models/merkle.py:30",
                   v2_launches["sha256_pairs_cuda"], err_pairs, pair_rec["device_ms"], plain_pairs_ms,
                   pair_rec["bound_ms"], pair_rec["bound_by"]),
            record("sha256_merkle_cuda", "torrent_tpu_torch/csrc/sha256.cu", "torrent_tpu/models/merkle.py:49",
                   v2_launches["sha256_merkle_cuda"], err_merkle, grid_rec["device_ms"], plain_merkle_ms,
                   grid_rec["bound_ms"], grid_rec["bound_by"]),
        ]
    }
    log(
        "phase 7: scheduler path launches (default, batch 4096): "
        f"sha1_cuda {[v[0] for v in sched_launches.values()]} sha256_cuda {[v[1] for v in sched_launches.values()]}"
    )
    log(f"phase 8: launches per rank and sub-phase {dist_launches}")
    log(f"phase 9: bridge path launches {bridge_launches}")
    log(f"phase 10: session path launches {session_launches}")
    log(f"phase 11: magnet path launches {magnet_launches}")
    log(f"phase 12: serving path launches {serving_launches}")
    log(f"phase 13: command-line path launches {cli_launches}")
    log(f"phase 14: bench path launches {bench_out['launches']}")
    log(f"phase 15: sanitized path launches {analysis_launches}")
    log(f"phase 16: examples' launches {ci_launches}")
    log(f"phase 17: grid path launches (17e: per rank) {mesh_launches}")
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "torrent_tpu"))
    check(not leaked, f"the port imported {leaked}")
    log(f"time: chip_smoke wall s={time.perf_counter() - t_smoke:.3f} (the kernels' builds included) {card}")
    log(json.dumps(kernels))
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    if "--dist-rank" in sys.argv:
        rank_main(sys.argv[1:])  # a rank of phase 8; its parent reads its file
        sys.exit(0)
    if "--bridge-client" in sys.argv:
        bridge_client_main(sys.argv[1:])  # phase 9's client; its parent reads its file
        sys.exit(0)
    if "--tsan-child" in sys.argv:
        tsan_child_main(sys.argv[1:])  # phase 15b's sanitized child; its parent reads its file
        sys.exit(0)
    try:
        result = main()
    except Exception:  # the boundary: report and fail, never exit 0
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        sys.exit(1)
    print(json.dumps(result), flush=True)
