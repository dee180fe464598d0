"""Models of the port (port of `repro.models`): the dense decoder (gated
SwiGLU or classic gelu / relu MLPs, tied or separate embeddings)."""
from repro_torch.models.transformer import Transformer, forward_train, token_logprobs

__all__ = ["Transformer", "forward_train", "token_logprobs"]
