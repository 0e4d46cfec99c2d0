"""What the serving drivers share: the model and its seeded weights, the
sample of finished units that is compared, the comparison of served
tokens and logits with the plain reference, and the slots of the
attention cache that decode wrote, with their check."""

from __future__ import annotations

import random

from . import judge, spec, weights
from .seeds import derive

__all__ = ["Comparison", "cache_check", "model", "reference", "sample",
           "weights_for", "written"]


def model(run):
    """The port's ``ModelConfig`` of the cell's configuration."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**run.model)


def weights_for(run, cfg) -> dict:
    """The seeded weights of ``cfg`` (the same tensors at every call)."""
    from repro_torch.models import api
    return weights.make(api.param_defs(cfg), run.seed, run.device,
                        run.cell.config.get("init"))


def sample(run, n_units: int, want: int) -> list:
    """The units (batches, rounds) to compare: the last, and ``want - 1``
    of the others drawn from the seed."""
    last = n_units - 1
    rest = random.Random(derive(run.seed, "sample")).sample(
        range(last), min(want - 1, last))
    return sorted(rest) + [last]


class Comparison:
    """Accumulates, over the compared positions, the widest gap by which
    a served token's reference logit lies below the reference's best
    (``gap``) and the logits' relative distance from the reference's
    (``logit_rms``). The control reads, at the same positions, the gap
    of the token its own logits put first."""

    def __init__(self, vocab: int):
        self.vocab = vocab
        self.gap = 0.0
        self.num = 0.0
        self.den = 0.0
        self.positions = 0

    def add(self, ref, served, logits) -> None:
        """``ref`` (B, T, V) float32; ``served`` (B, T) the tokens served
        from those positions, or None to take the argmax of ``logits``
        (B, T, >= V) (the control)."""
        logits = logits[..., :self.vocab].float()
        if served is None:
            served = logits.argmax(dim=-1)
        if bool(((served < 0) | (served >= self.vocab)).any()):
            self.gap = float("inf")
        else:
            self.gap = max(self.gap, judge.served_gap(ref, served))
        self.num += float((logits.double() - ref.double()).square().sum())
        self.den += float(ref.double().square().sum())
        self.positions += served.numel()

    def values(self) -> dict:
        rms = (self.num / self.den) ** 0.5 if self.den > 0 else float("inf")
        return {"gap": self.gap, "logit_rms": rms}


def reference(run):
    return spec.reference(run.cell.config["reference"])


def written(cache: dict, first: int, n: int) -> dict:
    """Copies of slots ``first`` .. ``first + n - 1`` of the attention
    cache in ``cache`` (the node with keys ``k``, ``v``, ``pos``): keys
    and values (L, B, Hk, n, Dh), position tags (L, B, n)."""
    node = cache
    while set(node) != {"k", "v", "pos"}:
        (node,) = [v for v in node.values() if isinstance(v, dict)]
    return {"k": node["k"][:, :, :, first:first + n].clone(),
            "v": node["v"][:, :, :, first:first + n].clone(),
            "pos": node["pos"][:, :, first:first + n].clone()}


def cache_check(got: dict, ref_k, ref_v, first: int) -> dict:
    """Written slots ``got`` (:func:`written`) against the reference's
    rotated keys and values of the same positions, each (L, B, Hk, n,
    Dh): ``cache_rms``, the larger of the two relative distances, and
    ``cache_tags``, the slots not tagged with their position ``first``,
    ``first + 1``, ..."""
    import torch
    n = ref_k.shape[3]
    expect = torch.arange(first, first + n, device=ref_k.device)
    return {"cache_rms": max(judge.rel_rms(got["k"].float(), ref_k),
                             judge.rel_rms(got["v"].float(), ref_v)),
            "cache_tags": float((got["pos"].to(expect.device).long()
                                 != expect).sum())}
