"""Distribution substrate of the port: the error-feedback int8 gradient
compression (``compression``), serving tensor parallelism (``tp``: the
exact TP boundaries over ``torch.distributed``), the shard rules
(``sharding``: the serving rules, and the training rules' logical axes,
``param_specs`` and the identity ``shard_hint``) and pipeline parallelism
(``pipeline``: stage splitting, the GPipe schedule over a
``torch.distributed`` group, bubble math).  ROADMAP.md item 12b (§A10b)
closed these."""
from .compression import compress_grads, decompress_grads, init_error_state
from .pipeline import bubble_fraction, pipeline_apply, split_stages
from .sharding import (AxisEnv, axis_env, param_specs, serve_param_dim,
                       serve_state_dim, set_axis_env, shard_hint,
                       shard_params, shard_states)
from .tp import (COLLECTIVES, TPConfigError, TPServing, tp_out_projection,
                 tp_row_shard, tp_row_unshard, tp_serving, tp_serving_ctx,
                 validate_tp_serving)

__all__ = ["AxisEnv", "COLLECTIVES", "TPConfigError", "TPServing",
           "axis_env", "bubble_fraction", "compress_grads",
           "decompress_grads", "init_error_state", "param_specs",
           "pipeline_apply", "serve_param_dim", "serve_state_dim",
           "set_axis_env", "shard_hint", "shard_params", "shard_states",
           "split_stages",
           "tp_out_projection", "tp_row_shard", "tp_row_unshard",
           "tp_serving", "tp_serving_ctx", "validate_tp_serving"]
