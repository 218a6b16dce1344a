from .convert import opt_state_from_jax, params_from_jax
from .lm import forward, init_params, loss_fn, prefill

__all__ = ["forward", "init_params", "loss_fn", "opt_state_from_jax",
           "params_from_jax", "prefill"]
