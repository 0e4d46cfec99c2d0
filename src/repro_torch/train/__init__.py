"""Training/serving step construction (the JAX package's ``train``)."""

from .steps import (StepBundle, build_decode_step, build_prefill_step,
                    build_step, build_train_step, default_step_cfg)

__all__ = ["StepBundle", "build_decode_step", "build_prefill_step",
           "build_step", "build_train_step", "default_step_cfg"]
