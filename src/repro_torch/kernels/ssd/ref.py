"""The plain PyTorch version of the SSD chunk scan (the JAX package's
``kernels/ssd/ref.py``) and its work term (``kernels/ssd/ssd.py``).

Contract (all f32; ``xdt`` = x * dt head-major, ``bm``/``cm`` shared by
the heads, ``cum`` the within-chunk cumsum of dt * A, which is <= 0):

  xdt (B, H, C, Q, P), bm (B, C, Q, N), cm (B, C, Q, N), cum (B, H, C, Q)
  -> y (B, H, C, Q, P) and the state after the last chunk (B, H, P, N).

Per (b, h), for each chunk in order, with a (P, N) state h from ``h0``
(zeros by default):

  y  = ((C Bᵀ) ⊙ L) xdt + (C hᵀ) ⊙ exp(cum),  L[i, j] = exp(cum_i - cum_j)
                                              for i >= j, else 0
  h <- exp(cum[Q-1]) h + (xdt ⊙ exp(cum[Q-1] - cum))ᵀ B
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flops", "ssd_chunk_scan_ref"]


def ssd_chunk_scan_ref(xdt: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, cum: torch.Tensor, *,
                       h0: Optional[torch.Tensor] = None,
                       return_state: bool = False):
    """The chunk scan as the reference writes it: a Python loop over the
    chunks (the reference's ``lax.scan``) with the (B, H) axes batched
    (its ``vmap``s). Returns ``y``, or ``(y, h_final)`` with
    ``return_state``.

    The decay mask is ``exp`` of the difference with the masked entries
    set to -inf first, where the reference takes ``exp`` of every
    difference and zeroes the masked ones after. The values are the same
    (exp(-inf) is 0); the gradients are the same wherever the
    reference's are finite, and stay finite where an entry above the
    diagonal, cum_i - cum_j > 0, passes exp's f32 range (~88) and the
    reference's become NaN (0 * inf).
    """
    b, h, c, q, p = xdt.shape
    n = bm.shape[-1]
    xdt, bm, cm, cum = (t.float() for t in (xdt, bm, cm, cum))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=xdt.device) if h0 is None else h0.float())
    causal = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    ys = []
    for ci in range(c):
        x_c = xdt[:, :, ci]                                # (B, H, Q, P)
        b_c = bm[:, ci]                                    # (B, Q, N)
        c_c = cm[:, ci]                                    # (B, Q, N)
        u_c = cum[:, :, ci]                                # (B, H, Q)
        diff = u_c[..., :, None] - u_c[..., None, :]       # (B, H, Q, Q)
        decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
        scores = (c_c @ b_c.transpose(-1, -2))[:, None]    # (B, 1, Q, Q)
        y = (scores * decay) @ x_c
        y = y + (c_c[:, None] @ state.transpose(-1, -2)) * \
            torch.exp(u_c)[..., None]
        total = u_c[..., -1]                               # (B, H)
        sd = torch.exp(total[..., None] - u_c)             # (B, H, Q)
        state = torch.exp(total)[..., None, None] * state + \
            (x_c * sd[..., None]).transpose(-1, -2) @ b_c[:, None]
        ys.append(y)
    y = torch.stack(ys, dim=2)                             # (B, H, C, Q, P)
    return (y, state) if return_state else y


def flops(B: int, H: int, S: int, Q: int, P: int, N: int) -> float:
    """Per-forward FLOPs: scores QQN + intra QQP + inter QPN + state QPN
    per chunk per head (the JAX package's formula)."""
    n_chunks = S // Q
    per_chunk = 2.0 * (Q * Q * N + Q * Q * P + Q * P * N + Q * P * N)
    return B * H * n_chunks * per_chunk
