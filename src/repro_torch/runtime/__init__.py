"""int8 gradient compression and the fault-tolerant training driver;
port of ``repro/runtime``."""
from repro_torch.runtime.compression import (CompressionState,
                                             compress_grads, dequantize,
                                             init_compression, quantize)
from repro_torch.runtime.fault import (DriverConfig, FailureInjected,
                                       StepStats, run_training,
                                       run_with_restarts)

__all__ = ["CompressionState", "init_compression", "compress_grads",
           "quantize", "dequantize", "DriverConfig", "run_training",
           "run_with_restarts", "FailureInjected", "StepStats"]
