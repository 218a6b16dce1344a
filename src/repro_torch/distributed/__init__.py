from .compression import (CompressionState, compress_decompress,
                          compress_gradients, dequantize_int8,
                          init_compression_state, quantize_int8)
from .straggler import StragglerConfig, StragglerMonitor

__all__ = ["CompressionState", "StragglerConfig", "StragglerMonitor",
           "compress_decompress", "compress_gradients", "dequantize_int8",
           "init_compression_state", "quantize_int8"]
