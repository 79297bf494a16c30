"""The correctness check decides: a run of the harness at the tests' size
on the CPU (the look for a card skipped) is correct, and the same run with
the timed path broken underneath is not, once for each fault a serving
cell can have: a served token altered where it is produced, half of the
batch left out (its tokens copied from the other half), a restored tensor
altered where the overlay-patch kernel makes it."""
import pytest

from coldbench import harness
from coldbench.tests import small


@pytest.mark.parametrize("fault", [None, "token", "half_batch", "patch"])
def test_fault_makes_the_run_incorrect(fault):
    cell = small.cell("qwen1.5-0.5b.cold")
    out = harness.run("qwen1.5-0.5b.cold", 2**31 + 99, 0.3, False, t_start=0.0,
                      device="cpu", cell=cell, config=small.config(cell["config"]),
                      sample=1.0, fault=fault)
    assert out["ok"] and out["correct"] is (fault is None), out["checks"]
