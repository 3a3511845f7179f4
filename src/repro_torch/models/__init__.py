"""Model zoo of the port (the dense, moe, vlm, ssm and hybrid families):
``build_model`` gives the uniform ``Model`` API of ``repro.models``."""
from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
