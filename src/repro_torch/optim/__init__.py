from .adamw import (AdamWConfig, AdamWState, apply_updates, global_norm,
                    init_state)

__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "global_norm",
           "init_state"]
