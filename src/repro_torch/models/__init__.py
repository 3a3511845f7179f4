"""Model zoo of the port (the dense, moe, vlm, ssm and hybrid families):
``build_model`` gives the uniform ``Model`` API of ``repro.models``."""
from repro_torch.models.registry import (Model, build_model,
                                         input_partition_specs, input_structs)

__all__ = ["Model", "build_model", "input_structs", "input_partition_specs"]
