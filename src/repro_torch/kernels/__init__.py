"""Hand-written CUDA kernels, each beside its plain PyTorch version.

A kernel's wrapper takes the plain version for CPU tensors and launches
the kernel for CUDA tensors (or raises); it counts its launches in a
``launches`` attribute and carries a ``resolve`` hook for the
executable cache. The library is built from ``csrc/`` at first use
(:mod:`repro_torch.kernels.build`), never at import.
"""

from .flash_attention import attention_ref, flash_attention
from .matmul import matmul, matmul_ref
from .ssd import ssd_chunk_scan, ssd_chunk_scan_ref
from .triad import triad, triad_ref

#: every kernel wrapper of the port (name -> wrapper)
WRAPPERS = {"matmul": matmul, "triad": triad,
            "flash_attention": flash_attention,
            "ssd_chunk_scan": ssd_chunk_scan}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count, and flash attention's count per
    route, to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for route in flash_attention.route_launches:
        flash_attention.route_launches[route] = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["WRAPPERS", "attention_ref", "flash_attention", "launch_counts",
           "matmul", "matmul_ref", "reset_launch_counts",
           "ssd_chunk_scan", "ssd_chunk_scan_ref", "triad", "triad_ref"]
