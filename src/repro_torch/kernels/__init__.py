"""Hand-written Hopper kernels of the port (port of `repro.kernels`).

`ops` is the public surface; each kernel module holds the CUDA launch,
its plain PyTorch version and a note on what bounds it.  Sources are in
`repro_torch/csrc/`, built by `build` at first use.
"""
from repro_torch.kernels import ops

__all__ = ["ops"]
