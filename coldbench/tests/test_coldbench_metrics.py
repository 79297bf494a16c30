"""Each metric's reader on a recorded run: invocations, restore stats, the
profile's reduction and the frozen counts, numbers worked out by hand."""
import pytest

from coldbench import spec
from coldbench.costs import peaks
from coldbench.trace import _gaps, _merge

import numpy as np


def row(f, sub, done, queue, ttft, total, **stats):
    return {"function": f, "prompt": 0, "submit": sub, "done": done, "error": None,
            "cold": True, "mode": "spice", "joined": False, "queue_s": queue, "ttft_s": ttft,
            "total_s": total, "queue_wait_s": queue / 2, "stats": stats}


def recorded():
    ok = [row("fn-ft-0", 0.0, 0.5, 0.01, 0.29, 0.48, total_s=0.2, upload_s=0.1, bytes_read=2e8),
          row("fn-ft-0", 0.6, 1.2, 0.02, 0.38, 0.57, total_s=0.3, upload_s=0.2, bytes_read=4e8),
          row("fn-ft-0", 1.3, 2.0, 0.03, 0.47, 0.66, total_s=0.4, upload_s=0.3, bytes_read=6e8)]
    return {
        "ok": ok, "rows": ok, "window_s": 2.0, "setup_s": 31.5, "publish_s": [7.0, 8.0],
        "cell": dict(spec.cell("qwen1.5-0.5b.cold"), new_tokens=8),
        "config": spec.config("qwen1.5-0.5b"),
        "k1": {"fn-ft-0": (289, 3_000_000_000)},
        "trace": {"busy_s": 0.1, "window_s": 2.0, "ok": ok, "kernels": {
            "void (anonymous namespace)::overlay_patch_kernel<float4>(...)": [867, 1.0e-3 * 3],
            "void decode_attention_kernel<64>(Params)": [504, 504 * 2e-6],
            "void ssd_chunk_out_kernel<float, true>(Params)": [96, 96 * 9e-6],
        }},
    }


EXPECTED = {
    "ttft_ms": 400.0, "total_ms": 600.0, "invocations_per_s": 1.5, "setup_s": 31.5,
    "publish.s": 15.0, "restore.total_ms": 300.0,
    "restore.read_gbps": 12e8 / 0.9 / 1e9, "install.upload_ms": 200.0,
    "gen.decode_step_ms": 190 / 7, "device.idle_pct": 95.0,
    "ttft_p90_ms": 300 + 0.8 * 100 + 0.2 * 0,
    "overlay_patch_roofline": 100 * 3 * 3e9 / peaks.HBM_BYTES_PER_S / 3e-3,
    "decode_attention_roofline": 100 * 278528 / peaks.HBM_BYTES_PER_S / 2e-6,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(metric):
    want = EXPECTED[metric]
    if metric == "ttft_p90_ms":
        want = float(np.percentile([300.0, 400.0, 500.0], 90))
    assert spec.reader(metric)(recorded()) == pytest.approx(want, rel=1e-9)


def test_mfu_and_ssd_roofline():
    run = recorded()
    from coldbench.costs.flops_dense_lm import invocation_flops

    flops = invocation_flops(run["config"], 2, 16, 8)
    busy = 0.5 + 0.6 + 0.7  # the union of the three submit-to-result intervals
    assert spec.reader("step_mfu")(run) == pytest.approx(
        100 * 3 * flops / busy / peaks.F32_FLOPS)
    run["config"] = spec.config("mamba2-780m")
    assert spec.reader("ssd_scan_roofline")(run) == pytest.approx(100 * 1.185e-6 / 9e-6, rel=1e-3)


def test_readers_find_nothing_where_nothing_ran():
    run = recorded()
    run["trace"] = {"busy_s": 0.1, "window_s": 2.0, "ok": run["ok"], "kernels": {}}
    for metric in ("overlay_patch_roofline", "decode_attention_roofline", "ssd_scan_roofline"):
        assert spec.reader(metric)(run) is None
    run["ok"] = []
    assert spec.reader("ttft_ms")(run) is None


def test_idle_gaps_by_host_op():
    busy = _merge(np.array([[0.0, 10.0], [5.0, 20.0], [50.0, 60.0], [61.0, 62.0]]))
    assert busy.tolist() == [[0.0, 20.0], [50.0, 60.0], [61.0, 62.0]]
    host = [(18.0, 45.0, "cudaStreamSynchronize"), (40.0, 49.0, "aten::copy_"),
            (0.0, 100.0, "coldbench.result")]
    gaps = _gaps(busy, host)
    assert [n for n, _ in gaps] == ["cudaStreamSynchronize", "coldbench.result"]
    assert [s for _, s in gaps] == pytest.approx([30e-6, 1e-6])


def test_traced_run_reads_the_window_and_breaks_down_after_it():
    """A traced run on the CPU at the tests' size: the untraced window's
    requests are the run's rows, and the traced windows after it give the
    reduction, with the device window's requests and length."""
    from coldbench import harness
    from coldbench.tests import small

    cell = small.cell("qwen1.5-0.5b.warm")
    out = harness.run("qwen1.5-0.5b.warm", 2**31 + 17, 0.3, True, t_start=0.0, device="cpu",
                      cell=cell, config=small.config(cell["config"]))
    assert out["correct"] and out["ok"]
    assert all(r["submit"] - out["ok"][0]["submit"] < out["window_s"] for r in out["rows"])
    tr = out["trace"]
    assert set(tr) == {"kernels", "busy_s", "device_ops", "idle_gaps", "ok", "window_s"}
    assert isinstance(tr["idle_gaps"], list) and tr["ok"] and tr["window_s"] > 0
    assert tr["ok"][0]["submit"] > max(r["done"] for r in out["rows"])
    for metric in ("gen.decode_step_ms", "step_mfu"):
        assert spec.reader(metric)(out) > 0
