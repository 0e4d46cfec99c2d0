"""The model stack of the port (the JAX package's ``repro.models``): the
dense decoder's train step, with the flash-attention kernel on its
attention path, and the Mamba2 ``ssm`` and ``hybrid`` families' train
and prefill steps (``ssm`` decode too), with the SSD chunk-scan kernel in
every Mamba2 layer."""

from .config import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                     ModelConfig, WorkloadShape, cache_len,
                     cell_is_applicable)
from .transformer import StepConfig

__all__ = ["DECODE_32K", "LONG_500K", "PREFILL_32K", "SHAPES", "TRAIN_4K",
           "ModelConfig", "StepConfig", "WorkloadShape", "cache_len",
           "cell_is_applicable"]
