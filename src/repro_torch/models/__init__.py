"""The model stack of the port (the JAX package's ``repro.models``): the
train step, prefill and decode of every family (``dense``, ``moe``,
``vlm``, ``encdec``, ``ssm``, ``hybrid``), with the flash-attention
kernel on the train step's causal self-attention and the SSD chunk-scan
kernel in every Mamba2 layer."""

from .config import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                     ModelConfig, WorkloadShape, cache_len,
                     cell_is_applicable)
from .transformer import StepConfig

__all__ = ["DECODE_32K", "LONG_500K", "PREFILL_32K", "SHAPES", "TRAIN_4K",
           "ModelConfig", "StepConfig", "WorkloadShape", "cache_len",
           "cell_is_applicable"]
