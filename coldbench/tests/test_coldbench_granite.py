"""The granite cell's own files: a run of the harness at the tests' size on
the CPU is correct and the same run with a served token altered is not,
and the readers of its metrics on a recorded run, numbers worked out by
hand."""
import pytest

from coldbench import harness, spec
from coldbench.costs import peaks
from coldbench.costs.flops_granite_hybrid import invocation_flops
from coldbench.costs.moe_experts import call_work, expected
from coldbench.tests import small_hybrid

CELL = "granite-4.0-h-small.cold"


@pytest.mark.parametrize("fault", [None, "token"])
def test_small_run_is_correct_and_a_fault_is_not(fault):
    cell = dict(spec.cell(CELL), budget_images=1000, prompt_len=16)
    out = harness.run(CELL, 2**31 + 99, 0.3, False, t_start=0.0, device="cpu", cell=cell,
                      config=small_hybrid.config(), sample=1.0, fault=fault)
    assert out["ok"] and out["correct"] is (fault is None), out["checks"]


def test_moe_experts_roofline_reader():
    """Two invocations' K5 calls (10 MoE layers: a prefill call and 7 decode
    calls each) in 0.1 s of device time."""
    config = spec.config(spec.cell(CELL)["config"])
    run = {"config": config, "cell": spec.cell(CELL), "trace": {"kernels": {
        "(anonymous namespace)::moe_experts_gate_up_kernel(Params)": [160, 0.08],
        "(anonymous namespace)::moe_experts_down_kernel(Params)": [160, 0.02],
        "void decode_attention_kernel<128>(Params)": [14, 1.0]}}}
    prefill = peaks.bound_s(*call_work(*expected(2048, 10, 72, 9), 4096, 768))
    decode = peaks.bound_s(*call_work(*expected(2, 10, 72, 9), 4096, 768))
    want = 100 * 2 * 10 * (prefill + 7 * decode) / 0.1
    assert spec.reader("moe_experts_roofline")(run) == pytest.approx(want, rel=1e-12)
    assert 2560 * 6 * 4096 * 768 / peaks.F32_FLOPS == pytest.approx(prefill)
    run["trace"]["kernels"] = {}
    assert spec.reader("moe_experts_roofline")(run) is None


def test_invocation_flops_by_hand():
    """The formula at the tests' size against a count written out term by
    term: 3 Mamba-2 layers and 1 attention layer, each with its MoE."""
    c = small_hybrid.config()
    B, S, new = 2, 16, 8
    d, di, N, Hm, P, K, V = 64, 128, 16, 8, 16, 4, 256
    mamba = 2 * d * (2 * di + 2 * N + Hm) + 2 * di * d + 2 * K * (di + 2 * N) + 4 * Hm * P * N
    attn = 2 * d * (4 + 2 * 2) * 16 + 2 * 4 * 16 * d
    ffn = 2 * d * 6 + 6 * d * 48 + 6 * d * 32 * 3 * 2 / 6
    tokens = B * S + B * (new - 1)
    keys = B * S * (S + 1) // 2 + B * (new - 1) * S
    want = (3 * mamba + attn + 4 * ffn) * tokens + 4 * 16 * 4 * keys + 2 * d * V * B * new
    assert invocation_flops(c, B, S, new) == pytest.approx(want, rel=1e-12)
