"""The port's cost harness (``repro_torch.launch.{dryrun,hlo_analysis}``)
against the JAX package's ``repro.launch.{dryrun,hlo_analysis}``, on the
CPU.

The reference module sets ``XLA_FLAGS`` when imported, so its
``model_flops``, ``iter_cells`` and ``roofline`` keys are read in a
subprocess.  The counts are held exactly: a reduced cell counted in a real
run on the CPU (plain kernels) equals the same cell counted on ``meta``.
Every test that opens a process group (a fake one of 256 ranks, or one
gloo rank) closes it.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_analysis import collective_bytes as j_collective_bytes
from repro.launch.specs import cell_skip_reason as j_cell_skip_reason
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.interop import tree_map
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import init_single_process, make_host_mesh
from repro_torch.launch.specs import make_rules
from repro_torch.models import lm
from repro_torch.models.moe import capacity
from repro_torch.sharding.partition import axis_rules

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = r"""
import argparse, json
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import dryrun
args = argparse.Namespace(arch=None, shape=None, mesh="both")
print(json.dumps({
    "cells": [list(c) for c in dryrun.iter_cells(args)],
    "flops": {f"{a}/{s}": dryrun.model_flops(get_config(a), SHAPES[s])
              for a in ARCHS for s in SHAPES},
    "keys": sorted(dryrun.roofline({}, {}, 1, get_config("qwen1.5-0.5b"),
                                   SHAPES["prefill_32k"])),
}))
"""


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    return json.loads(out.stdout.splitlines()[-1])


@pytest.fixture
def host_mesh():
    """One gloo rank (an in-memory store) and the 1 x 1 host mesh."""
    assert not dist.is_initialized()
    init_single_process("cpu")
    try:
        yield make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_model_flops_match_reference(reference):
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            assert dryrun.model_flops(get_config(arch), shape) == \
                reference["flops"][f"{arch}/{name}"], (arch, name)


def test_cells_and_skips_match_reference(reference):
    import argparse

    args = argparse.Namespace(arch=None, shape=None, mesh="both")
    assert [list(c) for c in dryrun.iter_cells(args)] == reference["cells"]
    skipped = 0
    for arch, name, mp in dryrun.iter_cells(args):
        want = j_cell_skip_reason(arch, name)
        if want is not None:  # skipped cells trace nothing and open no group
            assert dryrun.run_cell(arch, name, mp) == {
                "cell": f"{arch}__{name}__{'multi' if mp else 'single'}", "arch": arch,
                "shape": name, "mesh": "2x16x16" if mp else "16x16", "skipped": want}
            skipped += 1
    assert skipped > 0 and not dist.is_initialized()


def _hlo_line(kind, shape, group, iota):
    dims = ",".join(map(str, shape))
    if kind == "collective-permute":
        groups = "source_target_pairs={{0,1},{1,0}}"
    elif iota:
        groups = f"replica_groups=[{64 // group},{group}]<=[64]"
    else:
        groups = "replica_groups={{" + ",".join(map(str, range(group))) + "}}"
    return f"  %r.1 = bf16[{dims}]{{1,0}} {kind}(bf16[{dims}]{{1,0}} %p.0), {groups}"


@pytest.mark.parametrize("iota", [False, True])
@pytest.mark.parametrize("group", [2, 4, 16])
def test_collective_bytes_match_reference_parser(group, iota):
    """Each of the five kinds, one record and its HLO line each, and all of
    them together: bytes and counts by kind equal the reference's parser's.
    ``view`` records are left out of the step's collectives."""
    records, lines = [], []
    for i, kind in enumerate(hlo_analysis.KINDS):
        shape = (4 + i, 8 * group)
        s = 2 if kind == "collective-permute" else group  # the parser's default
        rec = {"kind": kind, "dtype": torch.bfloat16, "shape": shape, "group": s}
        line = _hlo_line(kind, shape, group, iota)
        one, want = hlo_analysis.collective_bytes([rec]), j_collective_bytes(line)
        assert one[kind] == pytest.approx(want[kind], rel=1e-12) and one["counts"] == \
            want["counts"], kind
        records.append(rec)
        lines.append(line)
    got, want = hlo_analysis.collective_bytes(records), j_collective_bytes("\n".join(lines))
    assert got["counts"] == want["counts"]
    assert set(got) == set(want)
    for k in (*hlo_analysis.KINDS, "total"):
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    views = [{**r, "view": True} for r in records] + [
        {"kind": "slice", "dtype": torch.float32, "shape": (8,), "group": group, "view": True}]
    assert hlo_analysis.collective_bytes(records + views)["total"] == got["total"]
    assert hlo_analysis.collective_bytes(records + views, view=True)["counts"]["slice"] == 1


def _real(t, g, vocab):
    """A CPU tensor for a meta argument: tokens in the vocabulary, int8
    levels, positive f32 scales for an int8 cache, small normal weights."""
    if t.dtype == torch.int32:
        return torch.randint(0, vocab, t.shape, generator=g, dtype=t.dtype)
    if t.dtype == torch.int8:
        return torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8)
    return (torch.randn(t.shape, generator=g) * 0.05).abs().to(t.dtype)


REDUCED_CELLS = [
    ("qwen1.5-0.5b", "prefill_32k", {}),
    ("qwen1.5-0.5b", "decode_32k", {}),
    ("qwen1.5-0.5b", "decode_32k", {"kv_dtype": "int8"}),
    ("qwen1.5-0.5b", "train_4k", {}),
    ("mamba2-780m", "prefill_32k", {}),
    ("olmoe-1b-7b", "prefill_32k", {}),
]


@pytest.mark.parametrize("arch,name,over", REDUCED_CELLS,
                         ids=[f"{a}-{n}{'-' + str(o['kv_dtype']) if o else ''}"
                              for a, n, o in REDUCED_CELLS])
def test_cpu_and_meta_counts_equal(host_mesh, arch, name, over):
    """A reduced cell counted in a real run on the CPU (the plain kernels;
    K2 in prefill, K3 in decode, K4 in mamba2's, the MoE's regions in
    olmoe's) and on meta: FLOPs, bytes by class, ops and kernel calls
    equal, op by op."""
    cfg = get_config(arch).reduced()
    shape = InputShape(name, SHAPES[name].kind, 16, 2)
    plan, on_meta = dryrun.trace_cell(arch, name, host_mesh, False, dict(over), shape=shape,
                                      cfg=cfg)
    g = torch.Generator().manual_seed(0)
    args = tuple(a if isinstance(a, int) else tree_map(lambda t: _real(t, g, cfg.vocab_size), a)
                 for a in dryrun.step_args(plan, shape))
    with axis_rules(host_mesh, make_rules(cfg, shape, False)):
        on_cpu = dryrun.count_step(shape.kind, plan.fn, args)
    assert dict(on_cpu.ops) == dict(on_meta.ops)
    assert dict(on_cpu.kernels) == dict(on_meta.kernels)
    assert on_cpu.totals() == on_meta.totals()
    kernel = {"prefill": "ssd_scan" if arch.startswith("mamba") else "flash_attention",
              "decode": "decode_attention"}.get(shape.kind)
    if kernel:
        assert on_meta.kernel_calls() == {kernel: cfg.n_layers}
    else:  # training runs its attention as einsums, as the reference does
        assert on_meta.kernel_calls() == {}
    if arch.startswith("olmoe"):
        assert on_meta.totals(("region",))["flops"] > 0
    # on a 1 x 1 mesh the modeled column is the counted one
    s = dryrun.summarize(on_meta, cfg, shape, host_mesh, plan)
    assert s["modeled"]["flops"] == s["counted_rank0"]["flops"]
    assert s["modeled"]["bytes"] == s["counted_rank0"]["bytes"]


def test_dense_prefill_flops_match_formula(host_mesh):
    """The reduced qwen prefill's FLOPs: the projections and the MLP at
    2 params tokens, the head at the last position only, plus K2's causal
    4 B H hd S (S + 1) / 2 a layer."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    B, S = 2, 16
    shape = InputShape("prefill_32k", "prefill", S, B)
    _, rec = dryrun.trace_cell("qwen1.5-0.5b", "prefill_32k", host_mesh, False, shape=shape,
                               cfg=cfg)
    d, H, kvH, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    layer = d * H * hd + 2 * d * kvH * hd + H * hd * d + 3 * d * ff
    want = (cfg.n_layers * (2 * layer * B * S + 4 * B * H * hd * S * (S + 1) // 2)
            + 2 * d * cfg.vocab_size * B)
    assert rec.totals()["flops"] == want


def test_moe_region_collectives_on_fake_group():
    """The reduced olmoe prefill on a fake 16 x 16 group, 16 experts so
    that its body is the reference's all-to-all one (``moe.py``
    ``_moe_a2a_local``): per MoE layer an all-to-all out and one back over
    ``model`` of the (m, E / m, C, d) buffer and the aux loss's ``pmean``
    over every rank; the vocab-parallel embedding's one all-reduce.  The
    edges' cuts and gathers are ``view`` records, apart from these."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), n_experts=16)
    B, S = 32, 16
    shape = InputShape("prefill_32k", "prefill", S, B)
    with dryrun.fake_group(False) as mesh:
        plan, rec = dryrun.trace_cell("olmoe-1b-7b", "prefill_32k", mesh, False, shape=shape,
                                      cfg=cfg)
        s = dryrun.summarize(rec, cfg, shape, mesh, plan)
    assert not dist.is_initialized()
    n_moe = sum(1 for spec in lm.layer_sequence(cfg) if spec.moe)
    body = [r for r in rec.collectives if not r["view"]]
    a2a = [r for r in body if r["kind"] == "all-to-all"]
    T = (B // 16) * (S // 16)  # this rank's tokens
    assert len(a2a) == 2 * n_moe
    assert {r["shape"] for r in a2a} == {(16, 1, capacity(cfg, T), cfg.d_model)}
    assert {r["group"] for r in a2a} == {16}
    reduces = [r for r in body if r["kind"] == "all-reduce"]
    assert sorted((r["shape"], r["group"]) for r in reduces) == sorted(
        [((), 256)] * n_moe + [((B // 16, S, cfg.d_model), 16)])
    counted = s["collectives_counted_rank0"]
    assert counted["counts"] == {"all-to-all": 2 * n_moe, "all-reduce": n_moe + 1}
    view = s["collectives_view"]
    assert view["counts"]["all-gather"] > 0 and view["counts"]["slice"] > 0
    # the modeled collectives: the body's, then the dense layers' all-reduces
    terms = sum(t["count"] for t in s["modeled_terms"] if t["kind"] == "all-reduce")
    assert s["collectives"]["counts"] == {"all-to-all": 2 * n_moe,
                                          "all-reduce": n_moe + 1 + terms}


@pytest.mark.parametrize("name", ["prefill_32k", "decode_32k"])
def test_full_size_cells_trace_on_meta(reference, name):
    """qwen1.5-0.5b at full size on the 16 x 16 production mesh of a fake
    group: it traces in seconds, with the reference's roofline keys and
    K2 / K3 once a layer; no group is left."""
    res = dryrun.run_cell("qwen1.5-0.5b", name, False)
    assert not dist.is_initialized()
    assert "error" not in res and res["n_chips"] == 256 and res["trace_s"] < 30
    assert sorted(res["roofline"]) == reference["keys"]
    cfg = get_config("qwen1.5-0.5b")
    kernel = "flash_attention" if name.startswith("prefill") else "decode_attention"
    assert res["cost"]["counted_rank0"]["kernel_calls"] == {kernel: cfg.n_layers}
    assert res["roofline"]["model_flops"] == dryrun.model_flops(cfg, SHAPES[name])
    assert res["collectives"]["total"] > 0 and res["memory"]["modeled"]["total_bytes"] > 0
    assert res["cost"]["flops_per_device"] < res["cost"]["counted_rank0"]["flops"]


def test_no_group_after_run_cell():
    """``run_cell`` leaves no process group behind, refuses to start over
    one, and a gloo rank starts afterwards."""
    dryrun.run_cell("qwen1.5-0.5b", "decode_32k", True, shape=InputShape(
        "decode_32k", "decode", 64, 64))
    assert not dist.is_initialized()
    init_single_process(device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(RuntimeError, match="initialized already"):
            dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_kernel_costs_reproduce_the_recorded_bounds():
    """The kernels' ``cost`` functions give the bounds the card runs
    recorded (``PERF.md``'s kernel table): K2 at the sharded prefill cell
    278.003 us, K3 int8 on the sharded path 21.294 us, K4 at S 4096
    96.156 us, K1 at the embedding's size 371.540 us, each to 0.1 %."""
    from repro_torch.kernels.decode_attention import ops as k3
    from repro_torch.kernels.flash_attention import ops as k2
    from repro_torch.kernels.overlay_patch import ops as k1
    from repro_torch.kernels.ssd_scan import ops as k4
    from repro_torch.launch.hw import bound_ms

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    bf16, i8 = torch.bfloat16, torch.int8
    q = meta(8, 16, 4096, 64, dtype=bf16)
    k2_ms = bound_ms(*reversed(k2.cost(q, q, q)), "bfloat16")
    c = meta(8, 16, 4096, 64, dtype=i8)
    s = meta(8, 16, 4096)
    k3_ms = bound_ms(*reversed(k3.cost(meta(8, 16, 64, dtype=bf16), c, c, 4104, s, s)))
    k4_ms = bound_ms(*reversed(k4.cost(meta(1, 4096, 48, 64), meta(1, 48, 4096),
                                       meta(1, 4096, 1, 128), meta(1, 4096, 1, 128))))
    pages = meta(9496, 16384)
    k1_ms = bound_ms(*reversed(k1.cost(pages, meta(149, 16384), meta(9496, dtype=torch.int32),
                                       meta(9496, dtype=torch.int32))))
    for got, want in ((k2_ms, (278.003e-3, "operations")), (k3_ms, (21.294e-3, "bytes")),
                      (k4_ms, (96.156e-3, "operations")), (k1_ms, (371.540e-3, "bytes"))):
        assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-3)
    # the windowed count: sum over queries of min(i + 1, window)
    assert k2.pairs(2048, True, 1024) == sum(min(i + 1, 1024) for i in range(2048))
    assert k2.pairs(77, False, None) == 77 * 77
    assert k2.pairs(130, False, 40) == sum(min(130, i + 40) for i in range(130))


def test_meta_wrappers_check_like_the_card():
    """On meta each wrapper returns an empty result of the right shape and
    refuses what the card refuses."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.overlay_patch.ops import overlay_patch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    m = torch.device("meta")
    q = torch.empty(2, 4, 16, 64, device=m)
    out = torch.empty_like(q)
    assert flash_attention(q, q[:, :2], q[:, :2], out=out) is out
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :3], q[:, :3])
    qd = torch.empty(2, 4, 64, device=m)
    assert decode_attention(qd, q, q, 15).shape == qd.shape
    with pytest.raises(ValueError):
        decode_attention(qd, q.to(torch.int8), q.to(torch.int8), 15)
    x = torch.empty(2, 64, 4, 8, device=m)
    y, st = ssd_scan(x, torch.empty(2, 4, 64, device=m), torch.empty(2, 64, 1, 16, device=m),
                     torch.empty(2, 64, 1, 16, device=m), chunk=64)
    assert y.shape == x.shape and st.shape == (2, 4, 8, 16) and st.dtype == torch.float32
    pages = torch.empty(3, 256, device=m)
    tab = torch.empty(3, dtype=torch.int32, device=m)
    assert overlay_patch(pages, pages[:1], tab, tab).shape == pages.shape
    with pytest.raises(ValueError):
        overlay_patch(pages, pages[:1], tab.long(), tab)


# ------------------------------------------------------- on the card only
@pytest.mark.gpu
def test_card_and_meta_counts_equal_on_gpu():
    """A cut qwen prefill step on one NCCL rank counted on the card (K2
    launched) and on meta: FLOPs and bytes equal, K2 once a layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import launch_counters

    cuda = torch.device("cuda")
    cfg = get_config("qwen1.5-0.5b").reduced()
    shape = InputShape("prefill_32k", "prefill", 64, 2)
    init_single_process(cuda)
    try:
        mesh = make_host_mesh(cuda)
        plan, on_meta = dryrun.trace_cell("qwen1.5-0.5b", "prefill_32k", mesh, False,
                                          shape=shape, cfg=cfg)
        g = torch.Generator().manual_seed(0)
        args = tree_map(lambda t: _real(t, g, cfg.vocab_size).to(cuda), plan.args)
        counters = launch_counters()
        counters["flash_attention"].reset()
        with axis_rules(mesh, make_rules(cfg, shape, False)):
            on_card = dryrun.count_step("prefill", plan.fn, args)
        assert counters["flash_attention"].count == cfg.n_layers
        assert on_card.totals() == on_meta.totals()
        assert on_card.kernel_calls() == {"flash_attention": cfg.n_layers}
    finally:
        dist.destroy_process_group()
