from .ops import (BF16_TILES, DEFAULT_TILES, F32_STAGES, ROUTE_TILES, TILES,
                  flops, matmul, matmul_ref, route, smem_bytes, tiles,
                  tma_operand)

__all__ = ["BF16_TILES", "DEFAULT_TILES", "F32_STAGES", "ROUTE_TILES",
           "TILES", "flops", "matmul", "matmul_ref", "route", "smem_bytes",
           "tiles", "tma_operand"]
