"""torrent_tpu_torch.sched — the continuous-batching hash-plane scheduler.

All hash-plane dispatch flows through one :class:`HashPlaneScheduler`
per process: the ``parallel/verify.py`` and ``parallel/bulk.py``
scheduler sessions here, and (in the reference, and in the port's later
slices) the bridge's routes and session self-heal rechecks, submit into
a shared multi-tenant queue with
admission control, deadline-aware batch assembly, deficit-round-robin
fairness, and per-launch result demux. See scheduler.py for the design.
"""

from torrent_tpu_torch.sched.control import ControlConfig, SchedulerAutopilot
from torrent_tpu_torch.sched.faults import (
    DeviceFaultError,
    FaultPlan,
    PoisonedPayloadError,
)
from torrent_tpu_torch.sched.scheduler import (
    HashPlaneScheduler,
    SchedLaunchError,
    SchedRejected,
    SchedulerConfig,
    classify_error,
    resolve_sha256_backend,
)

__all__ = [
    "ControlConfig",
    "DeviceFaultError",
    "FaultPlan",
    "HashPlaneScheduler",
    "PoisonedPayloadError",
    "SchedLaunchError",
    "SchedRejected",
    "SchedulerConfig",
    "SchedulerAutopilot",
    "classify_error",
    "resolve_sha256_backend",
]
