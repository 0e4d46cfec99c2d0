"""Synthetic LM data pipeline (the JAX package's ``data/pipeline.py``).

Properties this substrate provides:
  * **Determinism & resumability** — batch ``i`` is a pure function of
    (seed, i); restart from any step reproduces the exact stream with no
    state files (the checkpoint only needs the step counter).
  * **Sharding awareness** — :func:`make_batch_sharded` makes each
    rank's rows of the step's batch locally (no global batch on the
    host) and returns them as a DTensor.
  * **Structured tokens** — a tiny k-order Markov construction instead of
    iid noise, so the LM loss actually decreases during training
    (learnable bigram structure).

The successor table is the reference's own (numpy ``default_rng(seed)``),
so it is identical. The reference draws each step's first tokens, noise
and follow mask with ``jax.random``; the port draws them from a numpy
generator seeded by ``(seed, step)``, so for the same seed the streams
differ (the same distribution, other draws) while each stays a pure
function of (seed, step). :func:`markov_tokens` is the recurrence alone,
a function of the three draws, so the reference's draws give the
reference's tokens. A shard's draws are seeded by (seed, step, its first
row), as the reference folds the row start into its key, so the sharded
stream is not the :meth:`SyntheticLM.batch_at` stream (in either
package).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DataConfig", "SyntheticLM", "make_batch_sharded",
           "markov_tokens"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    structure: float = 0.8      # probability of following the Markov chain


def markov_tokens(succ: np.ndarray, first: np.ndarray, noise: np.ndarray,
                  follow: np.ndarray) -> np.ndarray:
    """The Markov recurrence: column t is ``succ[prev]`` where
    ``follow[:, t]`` holds, else ``noise[:, t]``, with ``prev`` the column
    before (``first`` (rows, 1) before column 0). Returns (rows, S)
    int32."""
    rows, seq = noise.shape
    out = np.empty((rows, seq), dtype=np.int32)
    prev = np.asarray(first, dtype=np.int32)[:, 0]
    for t in range(seq):
        prev = np.where(follow[:, t], succ[prev], noise[:, t])
        out[:, t] = prev
    return out


class SyntheticLM:
    """Deterministic synthetic token stream: batch(i) is pure in (seed, i).
    The tokens land on ``device`` (the card unless the caller asks for the
    CPU) as int64 (torch's index dtype)."""

    def __init__(self, cfg: DataConfig, batch: int, seq_len: int,
                 device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.device = resolve_device(device)
        # fixed random bigram successor table: token t -> succ(t)
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab_size,
                                  size=cfg.vocab_size).astype(np.int32)

    def draws(self, step: int, rows: int,
              start: "int | None" = None) -> tuple[np.ndarray, ...]:
        """The step's first tokens (rows, 1), noise (rows, S) and follow
        mask (rows, S), from numpy's generator seeded by (seed, step), or
        by (seed, step, start) for the shard whose first row is
        ``start``."""
        key = [self.cfg.seed, step] + ([] if start is None else [start])
        rng = np.random.default_rng(key)
        vocab = self.cfg.vocab_size
        first = rng.integers(0, vocab, (rows, 1), dtype=np.int32)
        noise = rng.integers(0, vocab, (rows, self.seq_len), dtype=np.int32)
        follow = rng.random((rows, self.seq_len)) < self.cfg.structure
        return first, noise, follow

    def batch_at(self, step: int) -> dict:
        """Global batch for one step (pure function of step)."""
        toks = markov_tokens(self._succ, *self.draws(step, self.batch))
        return {"tokens": torch.from_numpy(toks).to(self.device,
                                                    torch.int64)}


def make_batch_sharded(pipeline: SyntheticLM, step: int, mesh, spec) -> dict:
    """The step's batch as a DTensor of ``spec`` (a sharding spec, as
    :func:`repro_torch.distributed.sharding.logical_to_spec` gives) on
    ``mesh``: this rank makes only its own rows, from draws seeded by
    (seed, step, first row), and keeps its columns of them (the
    reference's per-shard callback)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from ..distributed.sharding import placements
    shape = (pipeline.batch, pipeline.seq_len)
    pl = placements(spec, mesh)
    local_shape, offset = compute_local_shape_and_global_offset(shape, mesh,
                                                                pl)
    rows = local_shape[0]
    toks = markov_tokens(pipeline._succ,
                         *pipeline.draws(step, rows, start=offset[0]))
    toks = toks[:, offset[1]:offset[1] + local_shape[1]]
    local = torch.from_numpy(np.ascontiguousarray(toks)).to(pipeline.device,
                                                            torch.int64)
    return {"tokens": DTensor.from_local(local, mesh, pl, run_check=False,
                                         shape=shape,
                                         stride=(pipeline.seq_len, 1))}
