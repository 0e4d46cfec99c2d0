"""Guards of the port: it never imports jax, the JAX package or
``ml_dtypes``, it still imports and runs with all three blocked, and
asking for the card where there is none raises instead of quietly
running on the host."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
#: top-level modules the port never imports (``ml_dtypes``: the JAX
#: package's checkpoint reads bfloat16 through it; the port's does not)
BLOCKED = ("jax", "jaxlib", "repro", "ml_dtypes")

BLOCKER = """
import sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
"""


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in BLOCKED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _run_blocked(code: str, *, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", BLOCKER + code], env=env,
                          cwd=cwd or REPO, capture_output=True, text=True,
                          timeout=240)


def test_imports_and_cli_help_with_jax_and_reference_blocked():
    proc = _run_blocked("""
import runpy
import repro_torch, repro_torch.core, repro_torch.kernels
import repro_torch.bench.common, repro_torch.bench.roofline_model
import repro_torch.tune
import repro_torch.models, repro_torch.configs
import repro_torch.kernels.flash_attention
import repro_torch.models.api, repro_torch.models.workloads
from repro_torch.configs import get
assert get("granite_3_2b").n_params() == 2534049792
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
sys.argv = ["repro_torch.tune", "--help"]
runpy.run_module("repro_torch.tune", run_name="__main__")
""")
    assert proc.returncode == 0, proc.stderr
    assert "--benchmark" in proc.stdout and "--device" in proc.stdout


def test_cli_session_runs_with_jax_and_reference_blocked(tmp_path):
    proc = _run_blocked(f"""
from repro_torch.tune import main
raise SystemExit(main(["--session", "s", "--benchmark", "synthetic",
                       "--device", "cpu", "--cache-dir", {str(tmp_path)!r}]))
""")
    assert proc.returncode == 0, proc.stderr
    assert "best      : {'x': 7}" in proc.stdout


def test_history_and_search_clis_with_jax_and_reference_blocked(tmp_path):
    """The sweep CLI runs on the host when asked and refuses the card it
    does not find; the gate reads a ledger; neither imports jax."""
    proc = _run_blocked(f"""
import sys
from repro_torch import perf_gate
from repro_torch.sweep.__main__ import main
argv = ["--session", "s", "--benchmark", "synthetic", "--cache-dir",
        {str(tmp_path)!r}, "--grid", "m=256,1024;n=256", "--budget-per-shape",
        "3", "--predict", "m=512,n=256"]
assert main(argv + ["--device", "cpu"]) == 0
assert perf_gate.main([{str(tmp_path / "history.jsonl")!r}]) == 0
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
try:
    main(argv)
except RuntimeError as e:
    print("refused:", e)
""", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "predict    : m=512,n=256 -> " in proc.stdout
    assert "perf-gate: 2 series, 0 confirmed regression(s)" in proc.stdout
    assert "refused: device 'cuda' requested" in proc.stdout


def test_serve_cli_with_jax_and_reference_blocked():
    """The serving launcher imports and serves on the host when asked with
    jax and the JAX package blocked, its default device refuses without
    a card, and its ``--help`` runs."""
    proc = _run_blocked("""
import runpy
import repro_torch.launch.serve
from repro_torch.launch.serve import main
main(["--arch", "granite_3_2b", "--smoke", "--batch", "2", "--prompt-len",
      "8", "--gen", "3", "--device", "cpu"])
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
try:
    main(["--arch", "granite_3_2b", "--smoke"])
except RuntimeError as e:
    print("refused:", e)
sys.argv = ["repro_torch.launch.serve", "--help"]
runpy.run_module("repro_torch.launch.serve", run_name="__main__")
""")
    assert proc.returncode == 0, proc.stderr
    assert "[serve] generated shape (2, 3)" in proc.stdout
    assert "refused: device 'cuda' requested" in proc.stdout
    assert "--prompt-len" in proc.stdout and "--device" in proc.stdout


def test_train_cli_with_jax_reference_and_ml_dtypes_blocked(tmp_path):
    """The training launcher's ``--help`` runs, a 2-step smoke run on the
    host checkpoints and resumes, and its default device refuses without
    a card, with jax, the JAX package and ``ml_dtypes`` blocked."""
    proc = _run_blocked(f"""
import runpy
from repro_torch.launch.train import main
ck = {str(tmp_path / "ck")!r}
main(["--arch", "mamba2_130m", "--smoke", "--steps", "2", "--device", "cpu",
      "--batch", "2", "--seq", "16", "--ckpt-dir", ck])
main(["--arch", "mamba2_130m", "--smoke", "--steps", "3", "--device", "cpu",
      "--batch", "2", "--seq", "16", "--ckpt-dir", ck])
import repro_torch.examples.train_100m
assert not any(m.split(".")[0] in ("jax", "repro", "ml_dtypes")
               for m in sys.modules)
try:
    main(["--arch", "mamba2_130m", "--smoke", "--steps", "2"])
except RuntimeError as e:
    print("refused:", e)
sys.argv = ["repro_torch.launch.train", "--help"]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
""")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("[train] done: first loss") == 2
    assert "[train] resumed from step 2" in proc.stdout
    assert "refused: device 'cuda' requested" in proc.stdout
    assert "--ckpt-every" in proc.stdout and "--device" in proc.stdout


def test_cuda_without_a_card_raises(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.bench import common
    from repro_torch.core import cache as port_cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_cache, "_FINGERPRINTS", {})
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        common.dgemm_benchmark()({"n": 8, "m": 8, "k": 8})
    with pytest.raises(RuntimeError):
        common.triad_benchmark("cuda")({"n_bytes": 1 << 16})
    with pytest.raises(RuntimeError):
        common.dgemm_data(8, 8, 8, 0)
    with pytest.raises(RuntimeError):
        port_cache.hardware_fingerprint()
    with pytest.raises(RuntimeError, match="is_available"):
        common.model_step_family("train_step")
    with pytest.raises(RuntimeError, match="is_available"):
        common.chunked_dgemm_family({"m": 8, "n": 8, "k": 8})
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw_init
    with pytest.raises(RuntimeError, match="is_available"):
        train("mamba2_130m", steps=1)
    with pytest.raises(RuntimeError, match="is_available"):
        adamw_init({})
    with pytest.raises(RuntimeError, match="is_available"):
        load_checkpoint("unused")
    assert resolve_device("cpu").type == "cpu"


def test_cli_defaults_to_the_card_and_refuses_without_one(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--session", "s",
         "--benchmark", "synthetic", "--cache-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert "is_available() is False" in proc.stderr
    assert not (tmp_path / "s.jsonl").exists()


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_distribution_modules_with_jax_and_reference_blocked(tmp_path):
    """The distribution and launch-topology modules import with jax and
    the JAX package blocked; the host mesh defaults to the card and
    refuses without one, and runs ``gloo`` when asked for the CPU; the
    dry run traces a cell on a fake world in its own process; the report
    and the finalize CLI read its records; the CLIs' ``--help`` run."""
    out = tmp_path / "dry.jsonl"
    doc = tmp_path / "EXP.md"
    doc.write_text("# x\n<!-- DRYRUN_TABLE -->\n<!-- ROOFLINE_TABLE -->\n")
    proc = _run_blocked(f"""
import runpy
import repro_torch.distributed, repro_torch.distributed.tuner
import repro_torch.analysis.terms, repro_torch.analysis.trace
import repro_torch.launch.perf, repro_torch.launch.report
import repro_torch.bench.distributed_tuner, repro_torch.models.remat
from repro_torch.launch import dryrun, mesh
from repro_torch import finalize_experiments
try:
    mesh.make_host_mesh()
except RuntimeError as e:
    print("refused:", e)
m = mesh.make_host_mesh(device="cpu")
import torch.distributed as dist
print("host mesh", tuple(m.shape), dist.get_backend())
mesh.release_world()
dryrun.main(["--arch", "mamba2_130m", "--shape", "decode_32k", "--mesh",
             "single", "--no-analysis", "--out", {str(out)!r}])
assert finalize_experiments.main([{str(out)!r}, "--file", {str(doc)!r},
                                  "--in-place"]) == 0
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
for mod in ("repro_torch.launch.dryrun", "repro_torch.launch.perf",
            "repro_torch.launch.report"):
    sys.argv = [mod, "--help"]
    try:
        runpy.run_module(mod, run_name="__main__")
    except SystemExit:
        pass
""")
    assert proc.returncode == 0, proc.stderr
    assert "refused: device 'cuda' requested" in proc.stdout
    assert "host mesh (1, 1) gloo" in proc.stdout
    assert "dry-run complete: 1 ok, 0 skipped, 0 failed" in proc.stdout
    assert "| mamba2-130m | decode_32k | single | ok |" in doc.read_text()
    assert "--no-analysis" in proc.stdout and "--remat-policy" in proc.stdout
