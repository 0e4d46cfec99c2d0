"""The benchmark's own work counts: the operations and bytes a kernel or
a model step needs, from shapes alone. They are the yardstick of the
roofline and ``mfu`` metrics, so they live here and not in the program:
a change to the program cannot move them. ``perfbench/tests`` holds
them equal to the port's own counts at small shapes.

A model configuration is the ``port_config`` mapping of its file under
``perfbench/configs/`` (the port's ``ModelConfig`` fields), read as a
plain dict.
"""

from __future__ import annotations

from typing import Mapping, Optional

__all__ = ["attention_flops", "decode_step_flops", "gemm_bytes",
           "gemm_flops", "head_dim", "matmul_params", "prefill_flops"]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def gemm_flops(m: int, n: int, k: int) -> float:
    """C = A @ B with A (m, k) and B (k, n): one multiply and one add per
    term."""
    return 2.0 * m * n * k


def gemm_bytes(m: int, n: int, k: int, itemsize: int = 4) -> float:
    """A and B read once, C written once."""
    return float(itemsize) * (m * k + k * n + m * n)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def head_dim(cfg: Mapping) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def _attention_params(cfg: Mapping) -> int:
    d, h, hk, dh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        head_dim(cfg)
    return d * h * dh + 2 * d * hk * dh + h * dh * d


def _mlp_params(cfg: Mapping) -> int:
    per = 2 if cfg.get("mlp_type", "glu") == "plain" else 3
    return per * cfg["d_model"] * cfg["d_ff"]


def _layers(cfg: Mapping) -> int:
    if cfg["family"] != "dense":
        raise ValueError(f"no work count for family {cfg['family']!r}")
    return cfg["n_layers"]


def matmul_params(cfg: Mapping) -> int:
    """Weights a token is multiplied by, without the output head: every
    layer's projections and MLP."""
    return _layers(cfg) * (_attention_params(cfg) + _mlp_params(cfg))


def _keys_sum(n: int, window: Optional[int]) -> float:
    """sum over m = 1..n of min(m, window): the keys the first n causal
    queries see."""
    if window is None or n <= window:
        return n * (n + 1) / 2.0
    return window * (window + 1) / 2.0 + (n - window) * float(window)


def attention_flops(cfg: Mapping, start: int, n_queries: int,
                    causal: bool = True,
                    keys: Optional[int] = None) -> float:
    """Score and value products of one attention layer for one sequence:
    queries at positions ``start`` .. ``start + n_queries - 1``, each
    seeing its causal keys (inside the configuration's window), or with
    ``causal=False`` all ``keys`` keys; 4 FLOPs a (query, key, head,
    head-dim) term."""
    per_key = 4.0 * cfg["n_heads"] * head_dim(cfg)
    if not causal:
        return per_key * n_queries * keys
    window = cfg.get("window")
    seen = (_keys_sum(start + n_queries, window)
            - _keys_sum(start, window))
    return per_key * seen


def prefill_flops(cfg: Mapping, batch: int, seq: int, *,
                  causal: bool = True,
                  vocab: Optional[int] = None) -> float:
    """A prefill of ``batch`` prompts of ``seq`` tokens: every matmul
    weight once a token, each attention layer-use's causal products
    (with ``causal=False`` the full S x S square the plain masked path
    computes) and the output head at the last position (over ``vocab``
    rows, the configuration's vocabulary by default)."""
    v = vocab or cfg["vocab_size"]
    total = 2.0 * matmul_params(cfg) * batch * seq
    total += _layers(cfg) * batch * attention_flops(
        cfg, 0, seq, causal=causal, keys=seq)
    return total + 2.0 * batch * cfg["d_model"] * v


def decode_step_flops(cfg: Mapping, batch: int, pos: int, *,
                      cache: Optional[int] = None,
                      vocab: Optional[int] = None) -> float:
    """One decode step of ``batch`` tokens at position ``pos``: every
    matmul weight once, each attention layer-use over the pos + 1 causal
    keys inside the window (or, with ``cache``, over all of a cache of
    that many slots, as the plain decode path computes) and the output
    head."""
    v = vocab or cfg["vocab_size"]
    total = 2.0 * matmul_params(cfg) * batch
    if cache is None:
        att = attention_flops(cfg, pos, 1)
    else:
        att = attention_flops(cfg, pos, 1, causal=False, keys=cache)
    total += _layers(cfg) * batch * att
    return total + 2.0 * batch * cfg["d_model"] * v
