"""The control, on the card: the program with its float32 matrix products
in TF32 for the window comes out not correct through the harness's own
check, while the program as it is comes out correct (at the tests' size;
the readings at the cells' own sizes, from ``coldbench/calibrate.py``,
are in PERF.md)."""
import pytest

from coldbench import harness
from coldbench.tests import small


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the card computes")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen1.5-0.5b.cold", "mamba2-780m.cold"])
def test_control_fails_the_limit(card, name):
    cell = small.cell(name)
    for seed in (11, 12, 13):
        for fault in (None, "tf32"):
            out = harness.run(name, seed, 0.5, False, t_start=0.0, device=card, cell=cell,
                              config=small.config(cell["config"]), sample=1.0, fault=fault)
            assert out["ok"] and out["correct"] is (fault is None), (fault, out["checks"])
