"""The hand-written kernels as ``torch.library`` ops.

Each kernel is one operator of the ``repro_torch`` namespace
(``repro_torch::triad``, ``repro_torch::matmul``,
``repro_torch::flash_attention_fwd``, ``repro_torch::ssd_chunk_scan_fwd``)
with three implementations:

- ``CUDA``: the ctypes launch of the hand kernel (no fallback: a build
  or launch failure raises);
- ``CPU``: the kernel's plain PyTorch version;
- a fake one (``register_fake``), which gives the output shapes on the
  ``meta`` device and under fake tensors, allocating nothing;

and a FLOP formula in ``torch.utils.flop_counter``'s registry, the
kernel's own work, so ``FlopCounterMode`` and every other
``TorchDispatchMode`` (:func:`repro_torch.analysis.ops.count_ops`) see the
kernel as one op, and ``torch.profiler`` names its event
``repro_torch::<name>``.

The ops are defined with ``torch.library.Library(..., "DEF")`` and
``Library.impl`` rather than the ``torch.library.custom_op`` decorator:
the decorator's Python wrapping costs tens of microseconds a call on the
host, which the small TRIAD sizes of the paper's bandwidth table would
measure. Defining the ops is cheap and happens when each kernel's module
is imported; nothing is built or launched until a CUDA call.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["DEVICES", "NAMESPACE", "OPS", "check_device", "define"]

NAMESPACE = "repro_torch"
#: the devices an op has an implementation for (``meta`` through the fake)
DEVICES = ("cpu", "cuda", "meta")
#: op name -> its ``OpOverload`` (``torch.ops.repro_torch.<name>.default``)
OPS: dict[str, torch._ops.OpOverload] = {}

_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, *, cpu: Callable, cuda: Callable,
           fake: Callable, flops: Callable) -> torch._ops.OpOverload:
    """Define ``repro_torch::<name><schema>`` with its CPU and CUDA
    implementations, its fake implementation and its FLOP formula
    (``flops(*shapes_and_args, out_shape=...)``, the arguments with
    every tensor replaced by its shape); returns the op."""
    _LIB.define(f"{name}{schema}")
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet)(flops)
    OPS[name] = packet.default
    return packet.default


def check_device(what: str, device: torch.device) -> None:
    """Raise for a device no implementation of the op takes."""
    if device.type not in DEVICES:
        raise ValueError(f"{what} runs on cpu, cuda or meta, not {device}")
