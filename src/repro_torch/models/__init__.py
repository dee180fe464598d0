"""Models of the port (port of `repro.models`): dense decoders (gated
SwiGLU or classic gelu / relu MLPs, tied or separate embeddings), MoE
layers, Mamba2 SSM layers and hybrids of attention and SSM layers."""
from repro_torch.models.transformer import Transformer, forward_train, token_logprobs

__all__ = ["Transformer", "forward_train", "token_logprobs"]
