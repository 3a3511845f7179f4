"""PyTorch/CUDA port of the UAV-swarm split-computing reproduction.

Mirrors the JAX package ``repro`` (the reference it is held against) module
for module: ``configs``, ``rng``, ``core``, ``swarm``, ``fleet``, ``kernels``
(hand-written CUDA for the card, plain versions for the CPU), ``models``
(the dense LM), ``splitcompute`` (the φ stage planner and split-serve
engine), ``launch``, and the numpy halves of ``obs`` and ``trace``.
Imports torch, numpy and the standard library only.
"""
