"""Optimizer substrate: AdamW and the learning-rate schedules (cosine,
MiniCPM's WSD), the JAX package's ``optim``."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    opt_state_defs)
from .schedules import cosine_schedule, make_schedule, wsd_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "make_schedule", "opt_state_defs", "wsd_schedule"]
