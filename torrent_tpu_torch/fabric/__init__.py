"""torrent_tpu_torch.fabric — the multi-process verify fabric.

Shards a library recheck across processes (``fabric/plan.py``: a
deterministic byte-weight planner every process computes identically —
no coordinator RPC) and feeds each process's shard through its LOCAL
continuous-batching scheduler (``fabric/executor.py``), so cross-tenant
coalescing and multi-process sharding compose instead of competing for
the hash plane. A periodic few-byte heartbeat carries progress and
verdict bits; survivors adopt orphaned work from lapsed or
breaker-degraded processes, sentinel-cross-checking adopted verdicts so
a bad worker cannot poison the global bitfield. With
``FabricConfig.byzantine_f > 0`` the fabric additionally tolerates up
to f *lying* processes: verdicts travel as Merkle-committed receipts
(``fabric/receipts.py``), claims are audit-sampled every round, and
coverage needs a quorum of f + 1 matching receipts (see
``fabric/executor.py``'s module docstring). ``plan.py`` and
``receipts.py`` are copies of the reference's; the executor's
collective heartbeat rides ``torch.distributed``. Public entry point:
``torrent_tpu_torch.parallel.bulk.verify_library_fabric``.
"""

from torrent_tpu_torch.fabric.executor import (
    FAULT_EXIT_CODE,
    AllgatherHeartbeat,
    FabricConfig,
    FabricExecutor,
    FileHeartbeat,
    pack_bits,
    plan_payload_bytes,
    unpack_bits,
)
from torrent_tpu_torch.fabric.plan import (
    DEFAULT_UNIT_BYTES,
    FabricPlan,
    WorkUnit,
    adoption_owner,
    plan_library,
    replica_owners,
)
from torrent_tpu_torch.fabric.receipts import (
    audit_sample,
    leaf_hash,
    merkle_proof,
    merkle_root,
    unit_leaves,
    verify_proof,
)

__all__ = [
    "FAULT_EXIT_CODE",
    "AllgatherHeartbeat",
    "DEFAULT_UNIT_BYTES",
    "FabricConfig",
    "FabricExecutor",
    "FabricPlan",
    "FileHeartbeat",
    "WorkUnit",
    "adoption_owner",
    "audit_sample",
    "build_fabric_executor",
    "leaf_hash",
    "merkle_proof",
    "merkle_root",
    "pack_bits",
    "plan_library",
    "plan_payload_bytes",
    "replica_owners",
    "unit_leaves",
    "unpack_bits",
    "verify_proof",
]


def build_fabric_executor(
    items,
    scheduler,
    *,
    nproc: int | None = None,
    pid: int | None = None,
    heartbeat_dir: str | None = None,
    transport=None,
    config: FabricConfig | None = None,
    unit_bytes: int = DEFAULT_UNIT_BYTES,
    progress_cb=None,
) -> FabricExecutor:
    """Plan a library and build this process's executor.

    ``nproc``/``pid`` default to the live ``torch.distributed`` default
    process group (its world size and rank; 1 and 0 without one); pass
    them explicitly to run the fabric WITHOUT a process group (the file
    transport needs no collective — that is how the CPU tests spawn
    plain OS processes).

    Transport precedence: explicit ``transport`` > ``heartbeat_dir``
    (:class:`FileHeartbeat` — shared-filesystem heartbeats, supports
    lapse adoption) > the all-gather transport in a process group >
    none (solo). Shared by ``verify_library_fabric`` and
    ``tools/fabric_verify.py`` so the wiring lives in one place.
    """
    from torrent_tpu_torch.parallel.distributed import world

    if nproc is None or pid is None:
        size, rank = world()
        nproc = size if nproc is None else nproc
        pid = rank if pid is None else pid
    plan = plan_library([info for _, info in items], nproc, unit_bytes)
    cfg = config or FabricConfig()
    if transport is None:
        if heartbeat_dir is not None:
            # purge heartbeat files older than the lapse window so a
            # reused dir can't feed this run the previous run's verdicts
            transport = FileHeartbeat(
                heartbeat_dir, pid, purge_stale_s=cfg.lapse_after
            )
        elif nproc > 1:
            # the collective transport only works in a live group of
            # exactly nproc ranks — anything else would hang the first
            # all-gather round forever, so fail loudly up front
            size, _ = world()
            if size != nproc:
                raise ValueError(
                    f"allgather heartbeat needs a live torch.distributed "
                    f"process group of {nproc} ranks (found {size}); pass "
                    "heartbeat_dir for the shared-filesystem transport instead"
                )
            # the receipt plane's root/evidence keys only exist at
            # byzantine_f > 0, and the buffer budget tracks that
            transport = AllgatherHeartbeat(
                nproc, pid, plan_payload_bytes(plan, cfg.byzantine_f)
            )
    return FabricExecutor(
        items,
        plan,
        pid,
        scheduler,
        config=config,
        transport=transport,
        progress_cb=progress_cb,
    )
