"""No module of JAX or of the JAX package in a run: the check compares
top-level names whole (``repro_torch`` is the port, ``repro`` is not),
a whole run at test size in a fresh process loads none, and the
references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.lib import env

BENCH = Path(__file__).resolve().parents[1]


def test_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.models", "jaxtyping",
                 "reproducible", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(env.forbidden_modules()) & {"repro", "jax", "flax"}
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"repro", "jaxlib"} <= set(env.forbidden_modules())


def test_a_run_loads_nothing_forbidden():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import run_small\n"
        "from perfbench.lib import env\n"
        "for w in ('granite-3-2b.tune_gemm_f32', "
        "'granite-3-2b.serve_prefill_4k'):\n"
        "    assert run_small(w)['correct']\n"
        "print(env.forbidden_modules())\n"
    ) % (str(BENCH / "tests"), str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stderr


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] in ("torch", "__future__", "typing",
                                          "math", "contextlib"), name


def test_run_refuses_without_a_chip():
    """On a machine without a card the entry exits with another code than
    0 and prints no result."""
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "granite-3-2b.tune_gemm_f32", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
