"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronizer"]


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``cuda`` is the default everywhere; asking for it without a visible
    card raises instead of quietly running on the host, so a host timing
    can never be reported as a card's.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           f"torch.cuda.is_available() is False; pass "
                           f"device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def _no_sync(_handle=None) -> None:
    return None


def _cuda_sync(_handle=None) -> None:
    torch.cuda.synchronize()


def synchronizer(device: torch.device):
    """``sync(handle)`` that waits for work launched on ``device``: the
    card's ``torch.cuda.synchronize``, or nothing on the host (CPU ops
    are done when they return)."""
    return _cuda_sync if device.type == "cuda" else _no_sync
