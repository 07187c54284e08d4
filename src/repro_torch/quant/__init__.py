"""Post-training quantization of the port (W8A8)."""
from .ptq import ptq_quantize_params

__all__ = ["ptq_quantize_params"]
