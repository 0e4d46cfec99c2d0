from .ops import bytes_moved, flops, triad, triad_ref

__all__ = ["bytes_moved", "flops", "triad", "triad_ref"]
