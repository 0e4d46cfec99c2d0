from .ops import TILES, flops, matmul, matmul_ref, smem_bytes

__all__ = ["TILES", "flops", "matmul", "matmul_ref", "smem_bytes"]
