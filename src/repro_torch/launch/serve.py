"""Batched serving launcher: prefill a prompt batch, then greedy decode (the
JAX package's ``launch/serve.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The reference jits the steps of ``train.steps.build_prefill_step`` and
``build_decode_step`` over a host mesh; both belong to the port's
training launch and distribution (``ROADMAP.md``), and on one card
there is nothing to shard. So the port calls the model API directly,
``api.prefill_fn``, ``api.extend_cache`` and ``api.decode_fn``, under
``torch.no_grad()`` (nothing here needs a gradient, and without it every
step would keep its activations for one). Decode writes the KV cache in
place, so a step moves one slot of it, not the whole cache.

The clocks read the host's ``time.perf_counter`` after a device
synchronize: after the prefill (the cache it fills is what decode
reads) and after the decode loop. The first prefill of a process also
holds the one-time costs (the SSD kernel library's build on the card),
as the reference's first call holds its compilation; warm up with a
short call first to time the steady state.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .. import configs
from ..device import resolve_device, synchronizer
from ..models import api
from ..models.config import ModelConfig
from ..models.params import materialize
from ..models.transformer import StepConfig

__all__ = ["generate", "main", "serve"]


def generate(params: dict, prompt: torch.Tensor, cfg: ModelConfig, gen: int,
             *, forced: Optional[torch.Tensor] = None) -> dict:
    """Prefill ``prompt`` (B, S) and decode ``gen - 1`` more tokens, each
    at position S + t from the cache the prefill built (grown by ``gen``
    slots). Each token is the argmax of the last logits over the
    vocabulary, or, when ``forced`` (B, gen) is given, its column t
    (teacher forcing). Returns the tokens (B, gen) int32, the logits each
    token came from (B, gen, vocab_padded) and the seconds of the prefill
    and of the decode loop, each read after a device synchronize. The
    steps run the reference's fixed ``StepConfig`` (no remat, loss chunk
    ``min(128, S)``)."""
    prompt_len = prompt.shape[1]
    step = StepConfig(remat=False, loss_chunk=min(128, prompt_len))
    sync = synchronizer(prompt.device)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = api.prefill_fn(params, {"tokens": prompt}, cfg, step)
        # the cache is what decode reads: wait for all of the prefill
        sync()
        t_prefill = time.perf_counter() - t0
        cache = api.extend_cache(cache, gen)

        def pick(t: int, logits: torch.Tensor) -> torch.Tensor:
            if forced is not None:
                return forced[:, t:t + 1]
            return logits[:, -1:, :cfg.vocab_size].argmax(dim=-1)

        tokens = pick(0, logits)
        generated, step_logits = [tokens], [logits[:, -1:]]
        t0 = time.perf_counter()
        for t in range(gen - 1):
            logits, cache = api.decode_fn(params, {"tokens": tokens}, cache,
                                          prompt_len + t, cfg, step)
            tokens = pick(t + 1, logits)
            generated.append(tokens)
            step_logits.append(logits)
        sync()
        t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(generated, dim=1).to(torch.int32),
            "logits": torch.cat(step_logits, dim=1),
            "prefill_s": t_prefill, "decode_s": t_decode}


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          smoke: bool = True, seed: int = 0,
          device: "str | torch.device" = "cuda") -> dict:
    """Serve one prompt batch of ``arch`` (its SMOKE config, or the full
    one with ``smoke=False``) on ``device``: weights from ``materialize``
    with a ``torch.Generator`` seeded ``seed``, prompt tokens from
    ``np.random.default_rng(seed + 1)``, then :func:`generate`. Returns
    the generated tokens (numpy, (batch, gen)), the prefill's seconds
    and the decode seconds per generated token."""
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    params = materialize(torch.Generator(device=dev).manual_seed(seed),
                         api.param_defs(cfg))
    rng = np.random.default_rng(seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len))).to(dev)
    out = generate(params, prompt, cfg, gen)
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
