"""End-to-end driver: train a ~110M-parameter dense LM for a few hundred
steps, with checkpointing + resume (the JAX package's
``examples/train_100m.py``).

  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200 \\
      [--device cpu]

The model is a granite-family GQA transformer scaled to ~110M params;
data is the deterministic structured synthetic stream, so the loss has
real bigram signal to descend on. On the host CPU expect seconds a step;
pass --steps 30 for a quick check.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import types
from typing import Optional

from .. import configs
from ..configs import granite_3_2b as granite
from ..launch.train import train
from ..models import api
from ..models import params as P

__all__ = ["MODEL_100M", "main", "register"]

MODEL_100M = dataclasses.replace(
    granite.CONFIG,
    name="granite-110m",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab_size=32768,
    dtype="float32",
)
ARCH = "granite_110m"


def register() -> None:
    """Register MODEL_100M under a temporary id so the driver can find it
    (as its own CONFIG and SMOKE), as the reference does."""
    mod = types.ModuleType(f"{configs.__name__}.{ARCH}")
    mod.CONFIG = MODEL_100M
    mod.SMOKE = MODEL_100M
    sys.modules[mod.__name__] = mod
    if ARCH not in configs.ARCH_IDS:
        configs.ARCH_IDS.append(ARCH)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/train_100m_ckpt")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    n = P.n_params(api.param_defs(MODEL_100M))
    print(f"[train_100m] {MODEL_100M.name}: {n/1e6:.1f}M params")
    register()
    result = train(ARCH, steps=args.steps, batch=args.batch,
                   seq=args.seq, smoke=False, ckpt_dir=args.ckpt_dir,
                   ckpt_every=50, peak_lr=1e-3, log_every=10,
                   device=args.device)
    mean = result["mean_step_s"]
    print(f"[train_100m] loss {result['losses'][0]:.4f} -> "
          f"{result['final_loss']:.4f} over {args.steps} steps "
          + (f"({mean:.2f}s/step)" if mean is not None else ""))


if __name__ == "__main__":
    main()
