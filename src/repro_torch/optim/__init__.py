from repro_torch.optim.adamw import (AdamWConfig, OptState, cast_params,
                                     init_state, lr_at, update)
from repro_torch.optim import adamw

__all__ = ["AdamWConfig", "OptState", "init_state", "lr_at", "update",
           "cast_params", "adamw"]
