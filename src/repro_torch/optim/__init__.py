"""Functional optimizers and learning-rate schedules (the JAX package's
``optim/``): :mod:`repro_torch.optim.optimizers` and
:mod:`repro_torch.optim.schedules`."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_global_norm,
                                          get as get_optimizer, sgd)
from repro_torch.optim.schedules import constant, cosine, linear_warmup

__all__ = ["Optimizer", "adafactor", "adamw", "sgd", "get_optimizer",
           "clip_by_global_norm", "constant", "cosine", "linear_warmup"]
