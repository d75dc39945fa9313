"""Optimizers and learning-rate schedules, the reference's update rules."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState, adamw_init, adamw_update, clip_by_global_norm, lamb_init,
    lamb_update, make_optimizer)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup  # noqa: F401
