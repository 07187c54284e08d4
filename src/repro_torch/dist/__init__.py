"""Distribution substrate of the port: the error-feedback int8 gradient
compression (``compression``), serving tensor parallelism (``tp``: the
exact TP boundaries over ``torch.distributed``) and its shard rules
(``sharding``: the serving part).  The reference's training rules in
``sharding`` and its ``pipeline`` are not ported yet (ROADMAP.md §A10b)."""
from .compression import compress_grads, decompress_grads, init_error_state
from .sharding import (serve_param_dim, serve_state_dim, shard_params,
                       shard_states)
from .tp import (COLLECTIVES, TPConfigError, TPServing, tp_out_projection,
                 tp_row_shard, tp_row_unshard, tp_serving, tp_serving_ctx,
                 validate_tp_serving)

__all__ = ["COLLECTIVES", "TPConfigError", "TPServing", "compress_grads",
           "decompress_grads", "init_error_state", "serve_param_dim",
           "serve_state_dim", "shard_params", "shard_states",
           "tp_out_projection", "tp_row_shard", "tp_row_unshard",
           "tp_serving", "tp_serving_ctx", "validate_tp_serving"]
