from .ops import (attention_ref, bytes_moved, flash_attention, flops,
                  padded_blocks, smem_bytes)

__all__ = ["attention_ref", "bytes_moved", "flash_attention", "flops",
           "padded_blocks", "smem_bytes"]
