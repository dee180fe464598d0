"""Models of the port (port of `repro.models`): the dense decoder."""
from repro_torch.models.transformer import Transformer

__all__ = ["Transformer"]
