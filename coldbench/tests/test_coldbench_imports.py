"""What the benchmark may load: no module under ``coldbench/`` imports JAX,
the JAX package or the reference's harness (compared by whole top-level
name: ``repro_torch`` is not ``repro``), and ``run.py`` refuses to measure
without a card."""
import ast
import os
import subprocess
import sys

import pytest

from coldbench import spec

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(spec.HERE)) for p in SOURCES])
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & BANNED


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert not top_level_imports(path) & (BANNED | {"repro_torch"}), path


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(spec.HERE / "run.py"), "--workload",
                        "qwen1.5-0.5b.cold", "--seed", "5000000000", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=120, env=env,
                       cwd=str(spec.ROOT))
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
