"""Continuous-batching serving of the port (port of `repro.serving`): the
engine, and the streaming fleet front-end over N engine replicas."""
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
from repro_torch.serving.frontend import FleetReport, ServingFrontend
from repro_torch.serving.outputs import (
    FINISH_ABORT,
    FINISH_LENGTH,
    FINISH_STOP,
    CompletionOutput,
    RequestOutput,
)
from repro_torch.serving.scheduler import (
    EVICTION_POLICIES,
    Draft,
    ScheduleDecision,
    Scheduler,
    StepBudget,
    Verify,
)
from repro_torch.serving.spec_decode import NGramProposer, SpecConfig

__all__ = [
    "BlockManager", "CompletionOutput", "CrashFault", "Draft",
    "EVICTION_POLICIES", "FINISH_ABORT", "FINISH_LENGTH", "FINISH_STOP",
    "FaultError", "FaultInjector", "FaultPlan", "FleetReport",
    "HostCopyError", "HostCopyFault", "InstallFault", "KernelConfig",
    "NGramProposer", "NULL_INJECTOR", "NoFreeBlocksError", "ReplicaCrash",
    "Request", "RequestOutput", "ScheduleDecision", "Scheduler",
    "ServeReport", "ServingEngine", "ServingFrontend", "SpecConfig",
    "StepBudget", "Verify", "WeightInstallError", "kv_bytes_per_token",
    "request_state_bytes",
]
