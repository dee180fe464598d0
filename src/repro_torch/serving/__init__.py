"""Continuous-batching serving of the port (port of `repro.serving`, the
single-engine half: the fleet front-end and its outputs come later)."""
from repro_torch.kernels.config import KernelConfig
from repro_torch.serving.block_manager import BlockManager, NoFreeBlocksError
from repro_torch.serving.engine import (
    Request,
    ServeReport,
    ServingEngine,
    kv_bytes_per_token,
    request_state_bytes,
)
from repro_torch.serving.faults import (
    NULL_INJECTOR,
    CrashFault,
    FaultError,
    FaultInjector,
    FaultPlan,
    HostCopyError,
    HostCopyFault,
    InstallFault,
    ReplicaCrash,
    WeightInstallError,
)
from repro_torch.serving.scheduler import (
    EVICTION_POLICIES,
    ScheduleDecision,
    Scheduler,
    StepBudget,
)
from repro_torch.serving.spec_decode import NGramProposer, SpecConfig

__all__ = [
    "BlockManager", "CrashFault", "EVICTION_POLICIES", "FaultError",
    "FaultInjector", "FaultPlan", "HostCopyError", "HostCopyFault",
    "InstallFault", "KernelConfig", "NGramProposer", "NULL_INJECTOR",
    "NoFreeBlocksError", "ReplicaCrash", "Request", "ScheduleDecision",
    "Scheduler", "ServeReport", "ServingEngine", "SpecConfig", "StepBudget",
    "WeightInstallError", "kv_bytes_per_token", "request_state_bytes",
]
