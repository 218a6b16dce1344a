from .convert import params_from_jax
from .lm import forward, init_params, prefill

__all__ = ["forward", "init_params", "params_from_jax", "prefill"]
