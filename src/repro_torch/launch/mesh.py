"""Mesh construction (the JAX package's ``launch/mesh.py``).

Mesh layout of the production meshes (the reference's TPU pods of 256
chips):
  single pod : (data=16, model=16)
  multi-pod  : (pod=2, data=16, model=16)  — "pod" is pure DP.

:func:`make_production_mesh` builds them over a *fake* world of 256 or
512 ranks (``torch.distributed``'s ``fake`` backend, this process being
rank 0): collectives do nothing and no device is touched, which is what
the dry run needs (the reference's 512 placeholder host devices). A
process has one default process group, so the dry run keeps it to
itself; asking for the other production mesh replaces the fake world.
:func:`make_host_mesh` is the mesh over this host's real world: ``nccl``
over the cards (the default), ``gloo`` only when the caller asks for the
CPU.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_host_mesh", "make_production_mesh", "release_world"]

_FAKE = "fake"


#: the production meshes built over the current fake world
_MESHES: dict = {}


def _fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks."""
    if dist.is_initialized():
        if dist.get_backend() != _FAKE:
            raise RuntimeError(
                "this process already has a real process group; the dry "
                "run's fake world needs a process of its own")
        if dist.get_world_size() == world:
            return
        release_world()
    # the fake backend registers itself when its module is imported
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(_FAKE, rank=0, world_size=world,
                            store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16), or (pod=2, data=16, model=16), over a fake
    world; the mesh's device type is ``cpu`` and its tensors live on
    ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_world(math.prod(shape))
    if shape not in _MESHES:
        _MESHES[shape] = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    return _MESHES[shape]


def make_host_mesh(model: int = 1, device: "str | torch.device" = "cuda"):
    """(data, model) mesh over this host's real world: the ranks of a
    ``torchrun`` launch (``WORLD_SIZE``/``RANK`` and the rendezvous
    address in the environment), else this one process. ``nccl`` on
    ``cuda`` (which raises without a card), ``gloo`` on ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"this process's process group is "
                               f"{dist.get_backend()!r}, not {backend!r}")
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        if world > 1:
            dist.init_process_group(backend, init_method="env://")
        else:
            # one rank: an in-process store, no rendezvous address needed
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    n = dist.get_world_size()
    model = max(1, min(model, n))
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def release_world() -> None:
    """Destroy this process's default process group, if it has one (and
    the production meshes built over it)."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
