"""Post-training quantization of the port (W8A8, W4A8)."""
from .ptq import (DEFAULT_W4_POLICY, ptq_quantize_params, quantize_for,
                  quantized_param_fraction)

__all__ = ["DEFAULT_W4_POLICY", "ptq_quantize_params", "quantize_for",
           "quantized_param_fraction"]
