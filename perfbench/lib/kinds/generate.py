"""Static prompt batches through the port's serving entry,
``launch.serve.generate``: a prefill of ``batch`` prompts of
``prompt_len`` tokens, then greedy decode to ``gen`` tokens each,
batch after batch.

Traffic keys: ``batch``, ``prompt_len``, ``gen``, ``compare_batches``
(batches the reference checks after the window). Prompt tokens are
uniform over the vocabulary, each batch's drawn on the device from the
seed and its index; the warm-up batch (set-up) is a batch of its own.

The check reads, besides the served tokens and logits, the cache slots
that decode wrote: ``generate`` hands its cache to ``greedy_decode``,
which writes it in place, and the driver keeps a copy of the ``gen -
1`` slots after the prompt from the cache it sees passed (a decode step
that leaves the cache unchanged moves a logit by a key or two among
``prompt_len``, under what the logits' check can see).
"""

from __future__ import annotations

import time

from torch.profiler import record_function

from .. import counts, serving
from ..seeds import derive

__all__ = ["end_to_end", "judge", "release", "setup", "window", "work"]


def _prompt(run, index):
    import torch
    t = run.cell.traffic
    gen = torch.Generator(device=run.device).manual_seed(
        derive(run.seed, "prompt", index))
    return torch.randint(0, run.model["vocab_size"],
                         (int(t["batch"]), int(t["prompt_len"])),
                         generator=gen, device=run.device)


def _generate(run, index) -> dict:
    """One batch through ``generate``; its result gains ``written``, the
    decode steps' cache slots (:func:`serving.written`), or None when
    ``generate`` did not decode through ``greedy_decode``."""
    from repro_torch.launch import serve
    st = run.state
    t = run.cell.traffic
    real = serve.greedy_decode
    seen = {}

    def watched(params, logits, cache, *args, **kw):
        seen["cache"] = cache
        return real(params, logits, cache, *args, **kw)

    serve.greedy_decode = watched
    try:
        with record_function("perfbench.generate"):
            out = serve.generate(st["params"], _prompt(run, index),
                                 st["cfg"], int(t["gen"]))
    finally:
        serve.greedy_decode = real
    out["written"] = None if "cache" not in seen else serving.written(
        seen["cache"], int(t["prompt_len"]), int(t["gen"]) - 1)
    return out


def setup(run) -> None:
    cfg = serving.model(run)
    run.state.update(cfg=cfg, params=serving.weights_for(run, cfg))
    _generate(run, "warmup")


def window(run, seconds: float) -> None:
    batches = []
    run.sync()
    t0 = time.perf_counter()
    while True:
        out = _generate(run, len(batches))
        batches.append({"prefill_s": out["prefill_s"],
                        "decode_s": out["decode_s"],
                        "tokens": out["tokens"], "logits": out["logits"],
                        "written": out["written"]})
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    run.window_s = time.perf_counter() - t0
    run.records["batches"] = batches
    run.attempted = len(batches) * int(run.cell.traffic["batch"])


def work(run) -> dict:
    """Tokens and model FLOPs of one batch, and its decode steps."""
    t = run.cell.traffic
    b, s, g = int(t["batch"]), int(t["prompt_len"]), int(t["gen"])
    flops = counts.prefill_flops(run.model, b, s) + sum(
        counts.decode_step_flops(run.model, b, s + i) for i in range(g - 1))
    return {"tokens": b * (s + g), "flops": flops, "steps": g - 1}


def end_to_end(run) -> dict:
    """``tokens_per_s``: every prompt token prefilled and every token
    generated, over the window."""
    n = len(run.records["batches"])
    return {"tokens_per_s": n * work(run)["tokens"] / run.window_s}


def release(run) -> None:
    run.state.clear()


def judge(run, precision: str) -> dict:
    """The sampled batches' served tokens and logits against the plain
    reference's forward over prompt and served tokens, and their decode
    steps' cache slots against the reference's keys and values
    (``cache_rms``, the widest batch) and positions (``cache_tags``,
    slots tagged wrong; a batch whose slots were not seen counts all).
    The control: the reference in ``precision`` in the program's place."""
    import torch
    cfg = serving.model(run)
    ref = serving.reference(run)
    w = serving.weights_for(run, cfg)
    t = run.cell.traffic
    s, n = int(t["prompt_len"]), int(t["gen"]) - 1
    batches = run.records["batches"]
    cmp = serving.Comparison(run.model["vocab_size"])
    cache = {"cache_rms": 0.0, "cache_tags": 0.0}

    def slots(kv):
        return (torch.stack([k[:, :, s:s + n] for k, _ in kv]),
                torch.stack([v[:, :, s:s + n] for _, v in kv]))

    for i in serving.sample(run, len(batches), int(t["compare_batches"])):
        served = batches[i]["tokens"].to(run.device)
        seq = torch.cat([_prompt(run, i), served[:, :-1].long()], dim=1)
        want = ref.forward(w, run.model, seq, logits_from=s - 1)
        ref_k, ref_v = slots(want["kv"])
        if precision == "f32":
            cmp.add(want["logits"], served, batches[i]["logits"])
            got = batches[i]["written"]
        else:
            ctl = ref.forward(w, run.model, seq, logits_from=s - 1,
                              precision=precision)
            cmp.add(want["logits"], None, ctl["logits"])
            k, v = slots(ctl["kv"])
            got = {"k": k, "v": v, "pos": torch.arange(s, s + n).expand(
                k.shape[0], k.shape[1], n)}
            del ctl
        del want
        if got is None:
            cache["cache_rms"] = float("inf")
            cache["cache_tags"] += ref_k.shape[0] * ref_k.shape[1] * n
            continue
        one = serving.cache_check(got, ref_k, ref_v, s)
        cache["cache_rms"] = max(cache["cache_rms"], one["cache_rms"])
        cache["cache_tags"] += one["cache_tags"]
    return {**cmp.values(), **cache}
