"""Parameter definitions: one source of truth for shapes, logical axes and
initializers (the JAX package's ``models/params.py``).

Every model declares its parameters as a nested dict of :class:`ParamDef`.
From that tree come:
  * :func:`materialize` — real tensors from an explicit ``torch.Generator``,
    with the reference's init rules (fan-in scaled normal, ``embed``,
    ``ones``, ``zeros``). JAX's random bits cannot be reproduced, so each
    leaf gets its own generator seeded from the root seed and the same
    sha256 digest of the leaf's path that the reference folds into its key;
  * :func:`n_params` — the parameter count;
  * :class:`ShapeDtype` — the shape and dtype of one tensor (the decode
    caches' shape trees);
  * :func:`from_numpy` / :func:`to_numpy` — the bridge that carries the
    JAX package's parameters (numpy arrays, same keys and layouts) into
    the port and back, which is how the parity tests feed both packages
    the same weights.

The logical axis names (:func:`logical_tree`) feed the sharding rules
of :mod:`repro_torch.distributed.sharding`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

__all__ = ["ParamDef", "ShapeDtype", "empty_like_defs", "from_numpy",
           "flatten", "logical_tree", "map_tree", "materialize", "n_params",
           "shape_tree", "to_numpy", "unflatten"]

Tree = Any  # nested dict of ParamDef / tensors / arrays


class ShapeDtype(NamedTuple):
    """Shape and dtype of one tensor (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: torch.Size
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]     # logical axis name per dim
    init: str = "normal"                # normal | zeros | ones | embed
    scale: float | None = None          # stddev override (default: fan-in)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def map_tree(fn: Callable[[str, Any], Any], tree: Tree,
             path: str = "") -> Tree:
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict; paths are
    ``/key/subkey`` as in the reference."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v, f"{path}/{k}") for k, v in tree.items()}
    return fn(path, tree)


def flatten(tree: Tree, prefix: str = "") -> dict[str, Any]:
    """``a/b/c`` paths to the leaves of a nested dict, keys sorted at every
    level: ``jax.tree.leaves``'s order, in which the reference sums the
    global norm and ``jax.device_get`` writes a checkpoint."""
    if isinstance(tree, Mapping):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def unflatten(flat: Mapping[str, Any]) -> dict:
    """The nested dict of :func:`flatten`'s paths."""
    tree: dict = {}
    for path, value in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


def _defs_only(fn: Callable[[str, ParamDef], Any]):
    def wrapped(path: str, leaf):
        if not isinstance(leaf, ParamDef):
            raise TypeError(f"unexpected node at {path!r}: {type(leaf)}")
        return fn(path, leaf)
    return wrapped


def _fan_in(defn: ParamDef) -> float:
    # For >=2D weights treat all but the last dim as fan-in (weights are
    # stored (in_dims..., out_dims...) with contraction dims leading).
    if len(defn.shape) < 2:
        return 1.0
    fan = 1.0
    for d in defn.shape[:-1]:
        fan *= d
    return max(fan, 1.0)


def _leaf_seed(root: int, path: str) -> int:
    """The seed of one leaf: the first four bytes of the sha256 of its
    path (the digest the reference folds into its PRNG key) plus the root
    seed times an odd constant, so that every root moves the low 32 bits
    (all that the CPU generator reads of a seed)."""
    digest = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4],
                            "little")
    return (digest + root * 0x9E37_79B9_7F4A_7C15) % (2 ** 63)


def materialize(gen: torch.Generator, defs: Tree,
                device: "str | torch.device | None" = None) -> Tree:
    """Initialize real parameter tensors from the definition tree.

    ``gen`` supplies the root seed (``gen.initial_seed()``) and the device
    the normals are drawn on (its own, unless ``device`` is given): draw
    on the card for full-width models. Each leaf draws float32 normals
    from its own generator (:func:`_leaf_seed`), scales them and casts to
    the leaf's dtype, so a leaf's values depend only on the root seed and
    its path.
    """
    root = gen.initial_seed()
    dev = torch.device(device) if device is not None else gen.device

    def init_leaf(path: str, d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=dev)
        scale = d.scale if d.scale is not None else _fan_in(d) ** -0.5
        if d.init == "embed":
            scale = d.scale if d.scale is not None else 1.0
        leaf_gen = torch.Generator(device=dev).manual_seed(
            _leaf_seed(root, path))
        x = torch.randn(d.shape, generator=leaf_gen, dtype=torch.float32,
                        device=dev)
        # in place: a leaf's float32 draw is its one transient (mixtral's
        # stacked experts draw 26 GB a leaf)
        return x.mul_(scale).to(d.dtype)

    return map_tree(_defs_only(init_leaf), defs)


def empty_like_defs(defs: Tree, device: "str | torch.device") -> Tree:
    """Uninitialized tensors of the tree's shapes and dtypes (the ``meta``
    device gives shape-only stand-ins, the counterpart of the reference's
    ``shape_tree``)."""
    return map_tree(_defs_only(lambda _, d: torch.empty(
        d.shape, dtype=d.dtype, device=device)), defs)


def shape_tree(defs: Tree) -> Tree:
    """:class:`ShapeDtype` stand-ins of the tree's leaves."""
    return map_tree(_defs_only(lambda _, d: ShapeDtype(torch.Size(d.shape),
                                                       d.dtype)), defs)


def logical_tree(defs: Tree) -> Tree:
    """The logical-axes tree, same structure as the params."""
    return map_tree(_defs_only(lambda _, d: d.logical), defs)


def n_params(defs: Tree) -> int:
    total = 0

    def count(_, d: ParamDef):
        nonlocal total
        size = 1
        for s in d.shape:
            size *= s
        total += size

    map_tree(_defs_only(count), defs)
    return total


def from_numpy(tree: Tree, device: "str | torch.device" = "cuda",
               dtype: "torch.dtype | None" = None) -> Tree:
    """A tree of numpy arrays (the JAX package's parameters, same keys and
    layouts) as torch tensors on ``device``. Floating leaves are cast to
    ``dtype`` when it is given; a ``bfloat16`` numpy leaf (ml_dtypes) goes
    through float32, which holds every bfloat16 value exactly."""

    def convert(_, a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))   # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return map_tree(convert, tree)


def to_numpy(tree: Tree) -> Tree:
    """A tree of tensors as numpy arrays on the host (``bfloat16`` leaves
    as float32, which holds them exactly)."""

    def convert(_, t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_tree(convert, tree)
