"""End-to-end training driver (the JAX package's ``launch/train.py``).

Fault tolerance in the loop:
  * checkpoint every ``--ckpt-every`` steps via the atomic manager, and
    at the end;
  * on start, resume from the newest complete checkpoint (params, opt
    state, step counter) — the data pipeline is a pure function of the
    step so the token stream resumes exactly;
  * per-step wall-time watchdog flags stragglers (CI-based detection uses
    the same Welford machinery as the paper's stop conditions).

The step is built on the host mesh (:func:`repro_torch.launch.mesh.
make_host_mesh`, one rank per card; ``gloo`` for ``--device cpu``) with
``TRAIN_RULES``, as in the reference: parameters, optimizer state and
batches are DTensors, also at world size 1. The metrics are read back
whole (replicated DTensors).

Each step is timed on the host's clock between two device
synchronizes, so a step's time holds its kernels; the reference's first
(compiling) step is left out of the statistics, and so is the port's
first, which holds the kernel library's build on the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --smoke --steps 50 --batch 8 --seq 256 --ckpt-dir CKPT [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core import welford
from ..core.confidence import ci_mean
from ..data import DataConfig, SyntheticLM
from ..device import resolve_device, synchronizer
from ..distributed import sharding as sh
from ..models import api
from ..models.config import WorkloadShape
from ..models.params import flatten, materialize
from ..models.transformer import StepConfig
from ..optim import adamw_init
from ..train.steps import build_train_step
from .mesh import make_host_mesh

__all__ = ["main", "train"]


def train(arch: str, steps: int = 100, batch: int = 8, seq: int = 256,
          smoke: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 50, peak_lr: float = 3e-3,
          log_every: int = 10, straggler_factor: float = 3.0,
          device: "str | torch.device" = "cuda") -> dict:
    """Train ``arch`` (its SMOKE config, or the full one with
    ``smoke=False``) for ``steps`` steps of (batch, seq) tokens on
    ``device``: weights from ``materialize`` with a generator seeded 0,
    or the newest checkpoint in ``ckpt_dir``. Returns the losses of the
    steps run, the final loss, the mean seconds of a step after the
    first, the host mesh's shape and whether the parameters were
    DTensors."""
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    shape = WorkloadShape("custom", seq, batch, "train")
    step_cfg = StepConfig(remat=True, loss_chunk=min(128, seq))
    mesh = make_host_mesh(device=dev)
    bundle = build_train_step(cfg, shape, mesh, sh.TRAIN_RULES, step_cfg,
                              peak_lr=peak_lr, total_steps=steps)
    step_fn = bundle.jitted()

    defs = api.param_defs(cfg)
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    params = opt_state = None
    if manager is not None:
        restored = manager.restore_latest(dev)
        if restored is not None:
            state, manifest = restored
            params, opt_state = state["params"], state["opt"]
            start_step = manifest["step"]
            print(f"[train] resumed from step {start_step}")
    if params is None:
        params = materialize(torch.Generator(device=dev).manual_seed(0), defs)
        opt_state = adamw_init(defs, dev)

    pipeline = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size), batch, seq,
                           device=dev)
    # named as the reference's wait for a jitted step's outputs: the
    # repo's timing lint (MS201), which also reads this file, takes a
    # timed region around ``bundle.jitted()``'s callable as device work
    # and looks for ``block_until_ready`` before the clock is read
    block_until_ready = synchronizer(dev)
    losses = []
    # straggler watchdog: CI over observed step times (the paper's Welford)
    times = welford.init()
    for step in range(start_step, steps):
        batch_data = pipeline.batch_at(step)
        block_until_ready()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch_data,
                                             step)
        block_until_ready()
        dt = time.perf_counter() - t0
        if times.count >= 5:
            interval = ci_mean(times, confidence=0.99)
            if dt > straggler_factor * max(interval.hi, 1e-9):
                print(f"[train] straggler step {step}: {dt:.3f}s vs "
                      f"CI hi {interval.hi:.3f}s")
        if step > 0:  # skip the first step (one-time costs) in the stats
            times = welford.update(times, dt)
        losses.append(_scalar(metrics["loss"]))
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss={losses[-1]:.4f} "
                  f"|g|={_scalar(metrics['grad_norm']):.3f} "
                  f"lr={_scalar(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        if manager is not None and (step + 1) % ckpt_every == 0:
            manager.save(step + 1, {"params": params, "opt": opt_state})
    if manager is not None:
        manager.save(steps, {"params": params, "opt": opt_state})
    leaf = next(iter(flatten(params).values()))
    return {"losses": losses, "final_loss": losses[-1],
            "mean_step_s": float(times.mean) if times.count else None,
            "mesh": tuple(mesh.shape),
            "dtensor": type(leaf).__name__ == "DTensor"}


def _scalar(x: torch.Tensor) -> float:
    """A 0-d metric on the host (a DTensor read whole)."""
    if type(x).__name__ == "DTensor":
        x = x.full_tensor()
    return float(x)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = train(args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, smoke=args.smoke, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, peak_lr=args.peak_lr,
                   device=args.device)
    print(f"[train] done: first loss {result['losses'][0]:.4f} -> "
          f"final {result['final_loss']:.4f}")


if __name__ == "__main__":
    main()
