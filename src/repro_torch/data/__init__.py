"""Data helpers of the port (port of `repro.data`)."""
from repro_torch.data import tasks

__all__ = ["tasks"]
