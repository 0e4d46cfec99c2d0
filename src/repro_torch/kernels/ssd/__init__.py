from .ops import (KERNELS, MAX_STATE, bytes_moved, chunk_scan, grid,
                  kernel_info, needed_flops, ssd_chunk_scan, tma_rows,
                  work_items)
from .ref import flops, ssd_chunk_scan_ref

__all__ = ["KERNELS", "MAX_STATE", "bytes_moved", "chunk_scan", "flops",
           "grid", "kernel_info", "needed_flops", "ssd_chunk_scan",
           "ssd_chunk_scan_ref", "tma_rows", "work_items"]
