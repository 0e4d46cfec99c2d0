from .ops import (MAX_STATE, bytes_moved, chunk_scan, needed_flops,
                  smem_bytes, ssd_chunk_scan)
from .ref import flops, ssd_chunk_scan_ref

__all__ = ["MAX_STATE", "bytes_moved", "chunk_scan", "flops", "needed_flops",
           "smem_bytes", "ssd_chunk_scan", "ssd_chunk_scan_ref"]
