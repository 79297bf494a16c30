"""The program's spans as the benchmark reads them: the readers of
``coldbench/spans.py``'s reduction and of ``RestoreStats.sync_wait_s`` on
a synthetic run, numbers worked out by hand; the reduction's alignment
check and idle time by innermost span; the program window at the tests'
size on the CPU; a run without ``--trace`` never turning the recorder on;
the step-logits hook against what the harness records."""
import numpy as np
import pytest

from coldbench import harness, spans, spec
from coldbench.tests import small
from repro_torch import obs

MS = 1_000_000  # ns


def sp(name, start, end, sid, parent=0, req=0, **attrs):
    return {"name": name, "start": start, "end": end, "id": sid, "parent": parent,
            "req": req, "attrs": attrs}


def synthetic(aligned=(99, 100)):
    """Two cold starts (requests 1 and 2, each with a restore) and a warm
    one (3); times in ms on the spans' clock."""
    s = [sp("invoke", 0, 100 * MS, 1, req=1), sp("restore", 1 * MS, 60 * MS, 2, 1, req=1),
         sp("gen.layer_wait", 5 * MS, 15 * MS, 3, 1, req=1),
         sp("gen.layer_wait", 20 * MS, 25 * MS, 4, 1, req=1),
         sp("gen.decode_step", 40 * MS, 50 * MS, 5, 1, req=1, step=1),
         sp("invoke.complete_wait", 50 * MS, 90 * MS, 6, 1, req=1),
         sp("invoke", 200 * MS, 300 * MS, 7, req=2), sp("restore", 201 * MS, 230 * MS, 8, 7, req=2),
         sp("gen.layer_wait", 205 * MS, 235 * MS, 9, 7, req=2),
         sp("gen.decode_step", 240 * MS, 260 * MS, 10, 7, req=2, step=1),
         sp("invoke.complete_wait", 260 * MS, 262 * MS, 11, 7, req=2),
         sp("invoke", 400 * MS, 420 * MS, 12, req=3),
         sp("gen.decode_step", 400 * MS, 430 * MS, 13, 12, req=3, step=1)]
    busy = [[42 * MS, 44 * MS], [245 * MS, 250 * MS], [255 * MS, 265 * MS]]
    prog = {"spans": s, "busy": busy, "window": [0, 500 * MS],
            "aligned": {"K1": [aligned[0], aligned[1]], "K3": [0, 0]}, "idle_by_span": []}
    ok = [{"cold": True, "stats": {"sync_wait_s": 0.2, "upload_s": 0.5}},
          {"cold": True, "stats": {"sync_wait_s": 0.4, "upload_s": 0.5}},
          {"cold": True, "stats": {"sync_wait_s": 0.3, "upload_s": 0.5}},
          {"cold": False, "stats": {}}]
    return {"ok": ok, "trace": {"program": prog}}


EXPECTED = {
    "install.sync_wait_ms": 300.0,
    "gen.layer_wait_ms": (15 + 30) / 2,  # request 1: 10 + 5, request 2: 30
    "invoke.complete_wait_ms": (40 + 2) / 2,
    "gen.decode_span_ms": 20.0,  # of 10, 20, 30
    # decode steps 60 ms long, of which 2 + 5 + 5 busy
    "gen.decode_idle_pct": 100 * (1 - 12 / 60),
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(metric):
    assert spec.reader(metric)(synthetic()) == pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_finds_nothing_where_nothing_was_traced(metric):
    bare = {"ok": [{"cold": True, "stats": {"upload_s": 0.5}}], "trace": None}
    assert spec.reader(metric)(bare) is None
    run = synthetic()
    run["trace"] = {"busy_s": 0.1, "window_s": 2.0}  # the parent's traced run
    run["ok"] = [{"cold": False, "stats": {}}]
    assert spec.reader(metric)(run) is None


def test_decode_idle_needs_the_clocks_aligned():
    assert spec.reader("gen.decode_idle_pct")(synthetic((98, 100))) is None
    assert spec.reader("gen.decode_idle_pct")(synthetic((0, 0))) is None


def test_reduction_aligns_and_breaks_idle_time_down(capsys):
    """Clock pairs with the wall clock 1 s ahead; one K1 launch inside its
    upload job, one 40 us past its end (inside the tolerance), one outside;
    the idle time goes to the deepest open span."""
    S = obs.Span
    a, b = (0, 10**9), (100 * MS, 10**9 + 100 * MS)
    recorded = [S("invoke", 0, 90 * MS, 1, 0, 1, "w", {}),
                S("restore", 10 * MS, 50 * MS, 2, 1, 1, "w", {}),
                S("install.job", 20 * MS, 30 * MS, 3, 2, 1, "u", {}),
                S("ADMITTED", 0, 0, 4, 1, 1, "w", {}, "i")]
    wall = lambda ns: (ns + 10**9) / 1e3  # noqa: E731  (ns on the spans' clock -> wall us)
    device = [(wall(21 * MS), wall(22 * MS), "overlay_patch_kernel<float4>"),
              (wall(29 * MS), wall(30 * MS + 40_000), "overlay_patch_kernel<float4>"),
              (wall(60 * MS), wall(61 * MS), "overlay_patch_kernel<float4>"),
              (wall(0), wall(5 * MS), "memcpy")]
    out = spans.reduce(recorded, device, a, b)
    assert out["aligned"] == {"K1": [2, 3], "K3": [0, 0]}
    assert [x["name"] for x in out["spans"]] == ["invoke", "restore", "install.job"]
    got = dict(out["idle_by_span"])
    # idle: 5-10 invoke, 10-20 restore, 20-21 / 22-29 / 30.04-30 job, 30-50 restore,
    # 50-60 and 61-90 invoke, 90-100 none
    assert got["install.job"] == pytest.approx(8e-3)
    assert got["restore"] == pytest.approx(10e-3 + 20e-3 - 40e-6)
    assert got["invoke"] == pytest.approx(5e-3 + 10e-3 + 29e-3)
    assert got["no program span"] == pytest.approx(10e-3)
    err = capsys.readouterr().err
    assert "K1 launches inside install.job: 2/3 (66.67%)" in err
    assert "idle by innermost span" in err


def test_program_window_on_the_cpu(monkeypatch):
    """A traced run at the tests' size with the program window after the
    traced ones: the readers of spans find cold starts, the alignment check
    counts no launch (the CPU has no device trace), so the idle share of
    decode is not read; the recorder is off again after it."""
    cell = small.cell("qwen1.5-0.5b.cold")
    real = harness._traced

    def traced(node, cell, pcfg, prompts, seconds, dev):
        out = real(node, cell, pcfg, prompts, seconds, dev)
        out["program"] = spans.window(node, cell, pcfg, prompts, seconds, dev)
        return out

    monkeypatch.setattr(harness, "_traced", traced)
    out = harness.run("qwen1.5-0.5b.cold", 2**31 + 5, 0.3, True, t_start=0.0, device="cpu",
                      cell=cell, config=small.config(cell["config"]))
    assert out["correct"] and not obs.ON
    prog = out["trace"]["program"]
    assert prog["rows"] and spans.cold_starts(prog)
    assert prog["aligned"] == {"K1": [0, 0], "K3": [0, 0]}
    for metric in ("gen.layer_wait_ms", "invoke.complete_wait_ms", "gen.decode_span_ms"):
        assert spec.reader(metric)(out) >= 0
    assert spec.reader("gen.decode_idle_pct")(out) is None
    assert spec.reader("install.sync_wait_ms")(out) >= 0
    assert obs.drain() == []


def test_untraced_run_never_turns_the_recorder_on(monkeypatch):
    calls = []
    monkeypatch.setattr(obs, "enable", lambda: calls.append(1))
    cell = small.cell("qwen1.5-0.5b.warm")
    obs.drain()
    out = harness.run("qwen1.5-0.5b.warm", 2**31 + 3, 0.3, False, t_start=0.0, device="cpu",
                      cell=cell, config=small.config(cell["config"]))
    assert out["correct"] and calls == [] and not obs.ON
    assert obs.drain() == []


def test_step_logits_hook_sees_what_the_harness_records():
    """The program's documented hook, set on the thread that generates,
    sees step for step the tensors the harness records where its patched
    ``serve.instance.unembed`` computes them."""
    import torch

    from repro_torch.core import BaseImage  # noqa: F401  (the port's package loads)
    from repro_torch.models import lm
    from repro_torch.serve import node as node_mod
    from repro_torch.serve.instance import layerwise_state

    config = small.config("qwen1.5-0.5b")
    pcfg = spec.program_config(config)
    params = lm.init_params(pcfg, seed=5, device="cpu")
    state = layerwise_state(pcfg, params)
    prompt = np.random.default_rng(5).integers(0, pcfg.vocab_size, (2, 16)).astype(np.int32)
    rec = harness.LogitsRecorder(seed=5, sample=1.0)
    seen = []
    rec.install()
    rec.active = True
    obs.on_step_logits(lambda x: seen.append(x.detach().clone()))
    try:
        toks, _ = node_mod.generate(pcfg, None, state, prompt, 8, device="cpu")
    finally:
        obs.on_step_logits(None)
        rec.remove()
    (_, served, recorded), = rec.calls
    np.testing.assert_array_equal(served, toks)
    assert len(seen) == len(recorded) == 8
    for got, want in zip(seen, recorded):
        assert torch.equal(got, want)
