from .convert import cache_from_jax, opt_state_from_jax, params_from_jax
from .lm import (DecodeState, decode_step, forward, forward_aux, init_cache,
                 init_params, loss_fn, prefill)

__all__ = ["DecodeState", "cache_from_jax", "decode_step", "forward",
           "forward_aux", "init_cache", "init_params", "loss_fn",
           "opt_state_from_jax", "params_from_jax", "prefill"]
