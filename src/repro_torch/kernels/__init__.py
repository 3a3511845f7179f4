"""Kernels of the port: hand-written CUDA for the card, plain PyTorch
versions (``ref``) for the CPU and as oracles, and ``ops`` to dispatch."""
