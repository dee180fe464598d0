"""Optimizer of the port (port of `repro.optim`)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    global_norm,
    init,
    state_bytes,
    update,
)

__all__ = ["AdamWConfig", "AdamWState", "init", "update", "global_norm", "state_bytes"]
