"""Models of the port (port of `repro.models`): the dense decoder."""
from repro_torch.models.transformer import Transformer, forward_train, token_logprobs

__all__ = ["Transformer", "forward_train", "token_logprobs"]
