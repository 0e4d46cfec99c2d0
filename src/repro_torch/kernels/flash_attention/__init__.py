from .ops import (SM90_TILES, attention_ref, bytes_moved, flash_attention,
                  flops, padded_blocks, physical_tile, sm90_smem_bytes,
                  smem_bytes)

__all__ = ["SM90_TILES", "attention_ref", "bytes_moved", "flash_attention",
           "flops", "padded_blocks", "physical_tile", "sm90_smem_bytes",
           "smem_bytes"]
