"""Decode at a long context through the port's ``launch.serve.
greedy_decode``: a KV cache of ``batch`` x (``context`` + ``steps``)
slots whose first ``context`` slots hold seeded K/V tagged 0 ..
context - 1 (filled in set-up, an input handed to the program and, drawn
again, to the reference), then rounds of ``steps`` greedy steps from
position ``context``. Every round starts from the same filled prefix
(its writes land in the last ``steps`` slots, which the next round
overwrites) with first tokens of its own.

Traffic keys: ``batch``, ``context``, ``steps``, ``compare_rounds``
(rounds the reference checks after the window; the last is one, and its
cache writes are checked too).
"""

from __future__ import annotations

import time

from torch.profiler import record_function

from .. import counts, serving
from ..seeds import derive

__all__ = ["end_to_end", "judge", "release", "setup", "window", "work"]


def _shape(run) -> tuple:
    t = run.cell.traffic
    return int(t["batch"]), int(t["context"]), int(t["steps"])


def _prefix(run, which: str, layer: int):
    """Layer ``layer``'s cached keys or values of positions 0 .. context -
    1: standard normals in the model's dtype, (B, Hk, context, Dh)."""
    import torch
    b, ctx, _ = _shape(run)
    m = run.model
    shape = (b, m["n_kv_heads"], ctx, counts.head_dim(m))
    gen = torch.Generator(device=run.device).manual_seed(
        derive(run.seed, "prefix", which, layer))
    dtype = getattr(torch, m["dtype"])
    return torch.randn(shape, generator=gen, dtype=dtype, device=run.device)


def _first(run, index):
    """The round's first tokens, drawn from the seed and the round's
    index, (B, 1)."""
    import torch
    gen = torch.Generator(device=run.device).manual_seed(
        derive(run.seed, "first", index))
    return torch.randint(0, run.model["vocab_size"], (_shape(run)[0], 1),
                         generator=gen, device=run.device)


def _first_logits(run, index):
    """Logits whose argmax is the round's first tokens, (B, 1, V_pad) in
    the model's dtype."""
    import torch
    cfg = run.state["cfg"]
    logits = torch.zeros((_shape(run)[0], 1, cfg.vocab_padded),
                         dtype=cfg.tdtype, device=run.device)
    return logits.scatter_(-1, _first(run, index)[..., None], 1.0)


def _round(run, index) -> dict:
    from repro_torch.launch import serve
    from repro_torch.models.transformer import StepConfig
    st = run.state
    _, ctx, steps = _shape(run)
    with record_function("perfbench.round"):
        return serve.greedy_decode(st["params"], _first_logits(run, index),
                                   st["cache"], ctx, steps, st["cfg"],
                                   StepConfig(remat=False))


def setup(run) -> None:
    import torch
    from repro_torch.models.transformer import kv_cache_spec
    cfg = serving.model(run)
    b, ctx, steps = _shape(run)
    cache = kv_cache_spec(cfg, b, ctx + steps).init_tree(run.device)
    for layer in range(cfg.n_layers):
        cache["k"][layer, :, :, :ctx] = _prefix(run, "k", layer)
        cache["v"][layer, :, :, :ctx] = _prefix(run, "v", layer)
    cache["pos"][..., :ctx] = torch.arange(ctx, dtype=cache["pos"].dtype,
                                           device=run.device)
    run.state.update(cfg=cfg, params=serving.weights_for(run, cfg),
                     cache={"attn": cache})
    _round(run, "warmup")


def window(run, seconds: float) -> None:
    rounds = []
    run.sync()
    t0 = time.perf_counter()
    while True:
        tr = time.perf_counter()
        out = _round(run, len(rounds))
        run.sync()
        rounds.append({"tokens": out["tokens"], "logits": out["logits"],
                       "seconds": time.perf_counter() - tr})
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.records["rounds"] = rounds
    run.attempted = len(rounds) * _shape(run)[0]


def work(run) -> dict:
    """Tokens and model FLOPs of one round, and its decode steps."""
    b, ctx, steps = _shape(run)
    flops = sum(counts.decode_step_flops(run.model, b, ctx + i)
                for i in range(steps))
    return {"tokens": b * steps, "flops": flops, "steps": steps}


def end_to_end(run) -> dict:
    """``decode_tokens_per_s``: every token generated, over the window."""
    n = len(run.records["rounds"])
    return {"decode_tokens_per_s": n * work(run)["tokens"] / run.window_s}


def release(run) -> None:
    """Keep the last round's cache writes (its K/V and position tags),
    free the rest."""
    _, ctx, steps = _shape(run)
    run.records["written"] = serving.written(run.state["cache"], ctx, steps)
    run.state.clear()


def judge(run, precision: str) -> dict:
    """The sampled rounds' served tokens and logits against the plain
    reference over the prefix drawn again and the served tokens; and the
    last round's cache writes against the reference's keys and values
    (``cache_rms``) and positions (``cache_tags``, slots tagged wrong)."""
    import torch
    cfg = serving.model(run)
    ref = serving.reference(run)
    w = serving.weights_for(run, cfg)
    b, ctx, steps = _shape(run)
    rounds = run.records["rounds"]
    cmp = serving.Comparison(run.model["vocab_size"])
    picked = serving.sample(run, len(rounds),
                            int(run.cell.traffic["compare_rounds"]))

    def prefix(layer):
        return _prefix(run, "k", layer), _prefix(run, "v", layer)

    values = {}
    for i in picked:
        served = rounds[i]["tokens"][:, 1:].to(run.device)
        seq = torch.cat([_first(run, i), served[:, :-1].long()], dim=1)
        want = ref.forward(w, run.model, seq, start=ctx, prefix=prefix)
        if precision == "f32":
            cmp.add(want["logits"], served, rounds[i]["logits"][:, 1:])
            got = run.records["written"]
        else:
            ctl = ref.forward(w, run.model, seq, start=ctx, prefix=prefix,
                              precision=precision)
            cmp.add(want["logits"], None, ctl["logits"])
            got = {"k": torch.stack([k for k, _ in ctl["kv"]]),
                   "v": torch.stack([v for _, v in ctl["kv"]]),
                   "pos": torch.arange(ctx, ctx + steps).expand(
                       cfg.n_layers, b, steps)}
            del ctl
        if i == picked[-1]:
            values = serving.cache_check(
                got, torch.stack([k for k, _ in want["kv"]]),
                torch.stack([v for _, v in want["kv"]]), ctx)
        del want
    return {**cmp.values(), **values}
