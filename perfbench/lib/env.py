"""The run's surroundings: cache directories inside the checkout, the look
for a chip, the device record, and the check that nothing of the JAX
package was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

__all__ = ["CACHE_VARS", "FORBIDDEN", "NoChip", "device_record",
           "forbidden_modules", "power_limit", "require_chips",
           "set_cache_dirs"]

#: top-level module names a run may not load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: every build and kernel cache a library of the stack may write, each
#: at a fixed directory under ``build/perfbench/`` of the checkout (the
#: kernel library itself builds into ``build/repro_torch/<hash>/``)
CACHE_VARS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "CUDA_CACHE_PATH": "cuda_cache"}


class NoChip(RuntimeError):
    """The machine lacks the cards a cell asks for."""


def set_cache_dirs(root: Path) -> None:
    """Point every cache at its directory in the checkout (set before
    torch is imported). ``USE_FLAX=0`` keeps ``transformers``, should
    anything load it, from loading JAX."""
    for var, sub in CACHE_VARS.items():
        path = root / "build" / "perfbench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def require_chips(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"{torch.cuda.device_count()} cards visible, the cell "
                     f"asks for {chips}")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def device_record(device, chips: int) -> dict:
    """``device`` of the result line: the platform, the card's name, the
    cards used and the peak of allocated memory on the fullest of
    them (on the host, where the tests run: no card, no peak)."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}
