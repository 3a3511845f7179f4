"""Kernels of the port: hand-written CUDA for the card, plain PyTorch
versions (``ref``) for the CPU and as oracles, and ``ops`` to dispatch.
Importing them builds nothing: each library is compiled at its first
launch (``build.py``)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
