"""Batched serving launcher: prefill a prompt batch, then greedy decode (the
JAX package's ``launch/serve.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The reference jits the steps of ``train.steps.build_prefill_step`` and
``build_decode_step`` over a host mesh, and its decode once more with
``jax.jit(decode.fn)``, compiled at its first call and run ``gen - 1``
times. On one card there is nothing to shard, so the port calls the
model API, ``api.prefill_fn``, ``api.extend_cache`` and
``api.decode_fn``, under ``torch.no_grad()`` (nothing here needs a
gradient, and without it every step would keep its activations for
one). Decode writes the KV cache in place, so a step moves one slot of
it, not the whole cache.

On the card decode goes through :func:`repro_torch.graphs.captured`,
the port's counterpart of ``jax.jit``: the first step runs eagerly, the
second captures a CUDA graph of one step (the cache donated, ``pos`` a
device scalar), and every later step replays it, so a step is no longer
the host issuing some 60 ops a layer. The logits a step returns are the
graph's buffer, so the loop keeps clones. Prefill stays eager: it runs
once, and a graph pays only when it is replayed. On the host every step
is eager.

The clocks read the host's ``time.perf_counter`` after a device
synchronize: after the prefill (the cache it fills is what decode
reads) and after the decode loop, which holds the warm-up step and the
capture, as the reference's decode clock holds its compilation. The
first prefill of a process also holds the one-time costs (the SSD
kernel library's build on the card), as the reference's first call
holds its compilation; warm up with a short call first to time the
steady state.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .. import configs, graphs
from ..device import resolve_device, synchronizer
from ..models import api
from ..models.config import ModelConfig
from ..models.params import materialize
from ..models.transformer import StepConfig

__all__ = ["generate", "greedy_decode", "main", "serve", "serve_inputs"]


def serve_inputs(cfg: ModelConfig, batch: int, rng: np.random.Generator,
                 device: torch.device) -> dict:
    """The family's inputs besides the prompt: ``frames`` (B, n_frames,
    d_enc) for enc-dec, ``image_embeds`` (B, n_image_tokens, d_model) for
    a VLM, standard normals from ``rng`` in the model's dtype."""
    shape = {"encdec": ("frames", (batch, cfg.n_frames, cfg.d_enc)),
             "vlm": ("image_embeds",
                     (batch, cfg.n_image_tokens, cfg.d_model))}
    if cfg.family not in shape:
        return {}
    name, dims = shape[cfg.family]
    x = rng.standard_normal(dims, dtype=np.float32)
    return {name: torch.from_numpy(x).to(device=device, dtype=cfg.tdtype)}


def greedy_decode(params: dict, logits: torch.Tensor, cache: dict, pos: int,
                  steps: int, cfg: ModelConfig, step: StepConfig, *,
                  forced: Optional[torch.Tensor] = None,
                  inputs: Optional[dict] = None) -> dict:
    """``steps`` decode steps from ``cache`` after ``logits`` (B, L, V)
    (a prefill's, or the step before's), at positions ``pos``, ``pos +
    1``, ...; ``cache`` is written in place. Each token is the argmax of
    the last logits over the vocabulary, or, when ``forced`` (B, steps +
    1) is given, its column t (teacher forcing); ``inputs`` (the
    family's ``frames`` or ``image_embeds``) go to every step. On the
    card the steps go through :func:`repro_torch.graphs.captured`: the
    first runs eagerly, the second captures a CUDA graph of one step (the
    cache donated, ``pos`` a device scalar), the rest replay it; the
    graph is released at the end. Returns the tokens (B, steps + 1),
    the first picked from ``logits``, and the logits each came from (B,
    steps + 1, V)."""
    inputs = inputs or {}

    def pick(t: int, logits: torch.Tensor) -> torch.Tensor:
        if forced is not None:
            return forced[:, t:t + 1]
        return logits[:, -1:, :cfg.vocab_size].argmax(dim=-1)

    def decode_step(params, batch, cache, pos):
        return api.decode_fn(params, batch, cache, pos, cfg, step)

    decode = decode_step
    if graphs.enabled(logits.device):
        decode = graphs.captured(decode_step, donate_argnums=(2,),
                                 device_scalars=(3,))
    tokens = pick(0, logits)
    generated, step_logits = [tokens], [logits[:, -1:]]
    with torch.no_grad():
        for t in range(steps):
            logits, cache = decode(params, {"tokens": tokens, **inputs},
                                   cache, pos + t)
            tokens = pick(t + 1, logits)
            generated.append(tokens)
            # a graph's logits are its buffer, overwritten by the next step
            step_logits.append(logits.clone())
    if decode is not decode_step:
        decode.release()
    return {"tokens": torch.cat(generated, dim=1),
            "logits": torch.cat(step_logits, dim=1)}


def generate(params: dict, prompt: torch.Tensor, cfg: ModelConfig, gen: int,
             *, forced: Optional[torch.Tensor] = None,
             inputs: Optional[dict] = None) -> dict:
    """Prefill ``prompt`` (B, S) and decode ``gen - 1`` more tokens, each
    at position S + t from the cache the prefill built (grown by ``gen``
    slots), by :func:`greedy_decode` (on the card, replayed from a CUDA
    graph from its second step on). ``inputs`` holds the family's other
    inputs (``frames``, ``image_embeds``), given to the prefill and to
    every decode step. Each token is the argmax of the last logits over
    the vocabulary, or, when ``forced`` (B, gen) is given, its column t
    (teacher forcing). Returns the tokens (B, gen) int32, the logits each
    token came from (B, gen, vocab_padded) and the seconds of the prefill
    and of the decode loop, each read after a device synchronize. The
    steps run the reference's fixed ``StepConfig`` (no remat, loss chunk
    ``min(128, S)``)."""
    prompt_len = prompt.shape[1]
    step = StepConfig(remat=False, loss_chunk=min(128, prompt_len))
    sync = synchronizer(prompt.device)
    inputs = inputs or {}
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = api.prefill_fn(params, {"tokens": prompt, **inputs},
                                       cfg, step)
        # the cache is what decode reads: wait for all of the prefill
        sync()
        t_prefill = time.perf_counter() - t0
        cache = api.extend_cache(cache, gen)
        t0 = time.perf_counter()
        out = greedy_decode(params, logits, cache, prompt_len, gen - 1, cfg,
                            step, forced=forced, inputs=inputs)
        sync()
        t_decode = time.perf_counter() - t0
    return {"tokens": out["tokens"].to(torch.int32), "logits": out["logits"],
            "prefill_s": t_prefill, "decode_s": t_decode}


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          smoke: bool = True, seed: int = 0,
          device: "str | torch.device" = "cuda") -> dict:
    """Serve one prompt batch of ``arch`` (its SMOKE config, or the full
    one with ``smoke=False``) on ``device``: weights from ``materialize``
    with a ``torch.Generator`` seeded ``seed``, prompt tokens from
    ``np.random.default_rng(seed + 1)`` and after them, from the same
    generator, standard normal ``frames`` (enc-dec) or ``image_embeds``
    (VLM) as the reference's ``serve`` builds them, then
    :func:`generate`. Returns
    the generated tokens (numpy, (batch, gen)), the prefill's seconds
    and the decode seconds per generated token."""
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    params = materialize(torch.Generator(device=dev).manual_seed(seed),
                         api.param_defs(cfg))
    rng = np.random.default_rng(seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len))).to(dev)
    out = generate(params, prompt, cfg, gen,
                   inputs=serve_inputs(cfg, batch, rng, dev))
    return {
        "tokens": out["tokens"].cpu().numpy(),
        "prefill_s": out["prefill_s"],
        "decode_s_per_token": out["decode_s"] / max(gen - 1, 1),
    }


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, smoke=args.smoke, device=args.device)
    print(f"[serve] generated shape {result['tokens'].shape} "
          f"prefill={result['prefill_s']*1e3:.0f}ms "
          f"decode={result['decode_s_per_token']*1e3:.1f}ms/token")
    print(result["tokens"][:2, :12])


if __name__ == "__main__":
    main()
