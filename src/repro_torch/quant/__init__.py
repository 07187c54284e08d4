"""Post-training quantization of the port (W8A8, W4A8, the W4 calibration
search)."""
from .ptq import (DEFAULT_W4_POLICY, W4_CLIPS, W4_GROUPS, calibrate_ptq,
                  ptq_quantize_params, quantize_for, quantized_copy,
                  quantized_param_fraction)

__all__ = ["DEFAULT_W4_POLICY", "W4_CLIPS", "W4_GROUPS", "calibrate_ptq",
           "ptq_quantize_params", "quantize_for", "quantized_copy",
           "quantized_param_fraction"]
