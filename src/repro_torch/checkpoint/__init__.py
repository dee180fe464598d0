"""Checkpointing of the port (port of `repro.checkpoint`)."""
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten_tree

__all__ = ["Checkpointer", "flatten_tree"]
