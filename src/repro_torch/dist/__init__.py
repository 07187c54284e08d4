"""Distribution substrate of the port: so far the error-feedback int8
gradient compression (``compression``).  The reference's ``sharding``,
``pipeline`` and ``tp`` are not ported yet (ROADMAP.md)."""
from .compression import compress_grads, decompress_grads, init_error_state

__all__ = ["compress_grads", "decompress_grads", "init_error_state"]
