"""Data helpers of the port (port of `repro.data`)."""
from repro_torch.data import tasks
from repro_torch.data.pipeline import PromptBatch, PromptPipeline

__all__ = ["tasks", "PromptBatch", "PromptPipeline"]
