"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names, and the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from benchmark.harness import runner

BENCH = Path(__file__).resolve().parents[1]


def test_the_check_compares_whole_top_level_names(monkeypatch):
    fake = {"factorvae_tpu_torch.config": 1, "factorvae_tpu_torchx": 1, "jax_like": 1,
            "benchmark.harness": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert runner.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(fake, **{"factorvae_tpu.config": 1,
                                                      "jaxlib": 1, "flax.linen": 1}))
    assert runner.forbidden_modules() == ["factorvae_tpu.config", "flax.linen", "jaxlib"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "contextlib", "typing", "numpy",
                                  "torch"}, path


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(runner.FORBIDDEN), path


def test_a_cell_on_the_cpu_loads_no_jax():
    """A tiny cell driven end to end in a fresh interpreter leaves no module
    of JAX or the JAX package loaded."""
    code = (
        "import sys, time; t0 = time.perf_counter()\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from benchmark.tests.conftest import install_tiny\n"
        "from benchmark.harness import cells, runner\n"
        "install_tiny(cells)\n"
        "res, checks = runner.run_cell('tiny.backfill', 3, 0.1, False, t0, device='cpu')\n"
        "assert res['correct'], (res, checks)\n"
        "print('FORBIDDEN', runner.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code, str(BENCH.parent)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_without_a_card_the_command_prints_no_result(tmp_path):
    """No CUDA device (this machine), or no program beside the benchmark: a
    non-zero exit and nothing on standard output."""
    import shutil

    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this machine has a card")
    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "benchmark")
    shutil.copy(BENCH.parent / "BENCHMARK.json", bare / "BENCHMARK.json")
    for cwd in (BENCH.parent, bare):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                              "csi800-k60.train", "--seed", "1", "--seconds", "1"],
                             cwd=cwd, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and out.stdout == "", out.stderr
