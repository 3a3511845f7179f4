"""Core protocol of the paper (Eqs. 9-16) on batched ``[R, ...]`` tensors."""
