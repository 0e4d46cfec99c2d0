from .ops import (ROUTE_TILES, SM90_TILES, TF32X3_D256_TILES, TF32X3_TILES,
                  attention_ref, bytes_moved, flash_attention, flops,
                  padded_blocks, physical_tile, route, sm90_smem_bytes,
                  smem_bytes, tf32x3_smem_bytes)

__all__ = ["ROUTE_TILES", "SM90_TILES", "TF32X3_D256_TILES", "TF32X3_TILES",
           "attention_ref", "bytes_moved", "flash_attention", "flops",
           "padded_blocks", "physical_tile", "route", "sm90_smem_bytes",
           "smem_bytes", "tf32x3_smem_bytes"]
