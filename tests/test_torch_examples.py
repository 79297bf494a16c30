"""The port's example scripts (``examples/torch_*.py``) against the JAX
package's (``examples/*.py``): each pair runs in subprocesses on the CPU and
must print the same narrative.  Lines whose numbers depend only on shapes,
bytes and policy must be equal; lines with times, losses, token ids or
temporary paths must be equal once those are masked (the two packages
initialize their weights differently, so token ids and losses differ)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
NUMBER = re.compile(r"\d+(?:\.\d+)?")
PATH = re.compile(r"(?:\S*/)+")


def _overlay(line):
    # a fine-tune's row: every column but the last (restore_ms) is bytes
    return line.rsplit(None, 1)[0] if "-tuned" in line else line


# script, the reference's needles (tests/test_examples.py), and the part of
# a line that depends only on shapes, bytes and policy (None: no part)
CASES = [
    ("quickstart", ("COLD start",), lambda line: None),
    ("overlay_finetunes", ("base-image cache",), _overlay),
    ("train_ft", ("resuming from step", "canary", "instant rollback"),
     lambda line: None if "loss" in line else line),
    ("serve_coldstart", ("node cache",),
     lambda line: line if line.startswith(("node cache:", "buffer pool:")) else None),
]


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _masked(line):
    # a masked number's column width may differ too
    return " ".join(NUMBER.sub("#", PATH.sub(".../", line)).split())


def _same_narrative(got, want, exact=lambda line: None):
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert _masked(g) == _masked(w), (g, w)
        if exact(w) is not None:
            assert exact(g) == exact(w)


@pytest.mark.parametrize("name,needles,exact", CASES, ids=[c[0] for c in CASES])
def test_twin_prints_the_reference_narrative(name, needles, exact):
    twin = _run(f"torch_{name}.py", "--device", "cpu")
    for n in needles:
        assert n in twin, f"missing narrative {n!r}"
    _same_narrative(twin, _run(f"{name}.py"), exact)


@pytest.mark.gpu
def test_quickstart_twin_runs_on_the_card():
    """The twin as a user runs it, on the card by default: the CPU's
    narrative and the CPU's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    card = _run("torch_quickstart.py")
    cpu = _run("torch_quickstart.py", "--device", "cpu")
    assert "COLD start" in card
    _same_narrative(card, cpu, lambda line: line if "tokens:" in line else None)
