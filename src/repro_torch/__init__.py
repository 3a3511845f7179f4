"""PyTorch/CUDA port of the UAV-swarm split-computing reproduction.

Mirrors the JAX package ``repro`` (the reference it is held against) module
for module: ``configs``, ``rng``, ``core``, ``swarm``, ``kernels``,
``fleet``.  Imports torch, numpy and the standard library only.
"""
