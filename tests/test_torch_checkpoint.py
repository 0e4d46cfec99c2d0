"""The port's checkpoint manager against the JAX package's: atomicity,
roundtrip, retention and corruption (the reference's
``tests/test_checkpoint.py``; its reshard test becomes a restore onto an
explicit device with the dtypes kept), and the shared on-disk format: a
checkpoint either package writes loads in the other bit for bit
(bfloat16 and float32 leaves, int32 scalars, nested keys), with the same
manifest. The port's own resume equivalence (6 steps straight against 3
+ checkpoint + 3) holds at the reference's rtol 1e-4."""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)


def tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.ones((3,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip(tmp_path):
    path = save_checkpoint(str(tmp_path), 7, tree())
    restored, manifest = load_checkpoint(path, "cpu")
    assert manifest["step"] == 7
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["b"], torch.ones(3, dtype=torch.bfloat16))
    assert int(restored["step"]) == 7


def test_manager_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, tree())
    assert mgr.latest_step() == 30
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["step_00000020", "step_00000030"]
    restored, manifest = mgr.restore_latest("cpu")
    assert manifest["step"] == 30


def test_restore_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "nope"))
    assert mgr.restore_latest("cpu") is None


def test_corruption_detected(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, tree())
    npz = os.path.join(path, "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="checksum"):
        load_checkpoint(path, "cpu")


def test_incomplete_save_is_invisible(tmp_path):
    """A .tmp directory (crash mid-save) must not be offered for restore."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree())
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() == 5


def test_restore_onto_an_explicit_device_keeps_dtypes(tmp_path):
    """The reference restores onto a mesh; the port onto the device asked
    for, every leaf in its stored dtype and shape."""
    src = {"w": torch.ones((8, 4)), "h": torch.zeros((2,), dtype=torch.bfloat16),
           "n": {"c": torch.tensor(3.0)}}
    path = save_checkpoint(str(tmp_path), 1, src)
    restored, _ = load_checkpoint(path, device=torch.device("cpu"))
    for key, want in (("w", src["w"]), ("h", src["h"])):
        assert restored[key].device.type == "cpu"
        assert restored[key].dtype == want.dtype
        assert restored[key].shape == want.shape
    assert restored["n"]["c"].shape == () and float(restored["n"]["c"]) == 3.0


def test_train_resume_equivalence(tmp_path):
    """Train 6 steps straight vs 3 + checkpoint + resume 3: the same last
    loss (checkpoint + pure-function data pipeline)."""
    from repro_torch.launch.train import train
    kw = dict(batch=2, seq=32, smoke=True, log_every=100, device="cpu")
    r_full = train("granite_3_2b", steps=6, ckpt_dir=None, **kw)
    ck = str(tmp_path / "ck")
    train("granite_3_2b", steps=3, ckpt_dir=ck, ckpt_every=100, **kw)
    r_resumed = train("granite_3_2b", steps=6, ckpt_dir=ck, ckpt_every=100,
                      **kw)
    assert len(r_resumed["losses"]) == 3
    np.testing.assert_allclose(r_resumed["losses"][-1],
                               r_full["losses"][-1], rtol=1e-4)


# ---------------------------------------------------------------------------
# The shared format
# ---------------------------------------------------------------------------


def _shared_tree(rng):
    """The same values for both packages: (numpy for JAX, torch)."""
    w = rng.standard_normal((3, 5)).astype(np.float32)
    e = rng.standard_normal((4, 2)).astype(np.float32).astype(
        ml_dtypes.bfloat16)
    m = rng.standard_normal((2, 2, 3)).astype(np.float32)
    jax_tree = {"params": {"embed": {"table": jnp.asarray(e)},
                           "layers": {"w": jnp.asarray(w)}},
                "opt": {"m": {"w": jnp.asarray(m)},
                        "count": jnp.float32(4.0)},
                "step": jnp.int32(11)}
    ours = {"params": {"embed": {"table": torch.from_numpy(
        e.view(np.int16).copy()).view(torch.bfloat16)},
        "layers": {"w": torch.from_numpy(w)}},
        "opt": {"m": {"w": torch.from_numpy(m)},
                "count": torch.tensor(4.0)},
        "step": torch.tensor(11, dtype=torch.int32)}
    return jax_tree, ours


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf (bfloat16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _pairs(a, b, prefix=""):
    assert sorted(a) == sorted(b), prefix
    for k in a:
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", a[k], b[k]


def _assert_same_bits(got, want):
    for path, x, y in _pairs(got, want):
        bx, by = _bits(x), _bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape, path
        np.testing.assert_array_equal(bx, by, err_msg=path)


def test_a_reference_checkpoint_loads_in_the_port_bit_for_bit(tmp_path):
    jax_tree, ours = _shared_tree(np.random.default_rng(0))
    path = jax_save(str(tmp_path), 11, jax_tree)
    restored, manifest = load_checkpoint(path, "cpu")
    assert manifest["step"] == 11
    assert restored["params"]["embed"]["table"].dtype == torch.bfloat16
    assert restored["step"].dtype == torch.int32
    _assert_same_bits(restored, ours)


def test_a_port_checkpoint_loads_in_the_reference_bit_for_bit(tmp_path):
    jax_tree, ours = _shared_tree(np.random.default_rng(1))
    path = save_checkpoint(str(tmp_path), 11, ours)
    restored, manifest = jax_load(path)
    assert manifest["step"] == 11
    assert restored["params"]["embed"]["table"].dtype.name == "bfloat16"
    _assert_same_bits(restored, jax_tree)


def test_the_manifests_agree(tmp_path):
    """Per-leaf shapes and dtype names, in the same order, and the keys of
    the archive."""
    jax_tree, ours = _shared_tree(np.random.default_rng(2))
    p_ref = jax_save(str(tmp_path / "ref"), 3, jax_tree, extra={"a": 1})
    p_ours = save_checkpoint(str(tmp_path / "ours"), 3, ours,
                             extra={"a": 1})
    manifests = []
    for p in (p_ref, p_ours):
        with open(os.path.join(p, "manifest.json")) as f:
            manifests.append(json.load(f))
        assert sorted(os.listdir(p)) == ["arrays.npz", "manifest.json"]
    ref, got = manifests
    assert list(got["leaves"].items()) == list(ref["leaves"].items())
    assert got["leaves"]["params/embed/table"]["dtype"] == "bfloat16"
    assert (got["step"], got["extra"]) == (ref["step"], ref["extra"])
    with np.load(os.path.join(p_ref, "arrays.npz")) as a, \
            np.load(os.path.join(p_ours, "arrays.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
