"""Models of the port (port of `repro.models`): dense decoders (gated
SwiGLU or classic gelu / relu MLPs, tied or separate embeddings), MoE
layers, Mamba2 SSM layers, hybrids of attention and SSM layers, an
encoder-decoder (a bidirectional encoder over frames, cross attention in
the decoder) and a VLM (projected patches as a prefix ahead of the
text)."""
from repro_torch.models.transformer import Transformer, forward_train, token_logprobs

__all__ = ["Transformer", "forward_train", "token_logprobs"]
