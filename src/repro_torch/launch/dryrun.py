"""Multi-pod dry run: trace every (architecture x input-shape x mesh) cell
on ``meta`` tensors over a fake process group of 256 or 512 ranks and turn
the step's counted work into roofline terms; the counterpart of
``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --force
  ... --set kv_dtype=int8 --tag int8

Results cached to results/dryrun_torch/<cell>[.<tag>].json, beside the
reference's results/dryrun/ and never in it.

Where the reference compiles the step and reads XLA's per-device cost and
memory analyses, the port runs it once, eagerly, on ``meta`` tensors (no
data, no allocation) under ``hlo_analysis.StepRecorder``.  Eager execution
runs every layer, so there is nothing to extrapolate: the reference's
``_measure`` / ``_extrapolate`` (XLA counts a while body once) and its
``collectives_hlo_loop_once`` have no counterpart.  Nothing is compiled, so
there is no XLA memory analysis either; ``memory`` holds the analytic
model (``specs.modeled_memory``).

The port runs global views (``repro_torch.sharding``): rank 0 runs the
dense layers whole and its own block of each ``shard_map`` region.  So the
cost comes in two columns:

- ``counted_rank0``: what rank 0 executes, the ``shard_map`` edges' own
  cuts and gathers reported apart (``edge_bytes``, ``collectives_view``);
- ``modeled``: the per-rank numbers the roofline uses, derived from the
  rules' layout as ``modeled_memory`` derives memory.  Outside the regions
  every GEMM's FLOPs are divided over batch (the ``data``/``pod`` shards
  that hold rows) and ``model`` (heads, ff, vocab), and each byte by the
  shards of the tensor it belongs to (``hlo_analysis.StepRecorder``'s
  classes): an activation split over ``model`` over batch and ``model``,
  another (the residual stream) over batch, parameters as
  ``modeled_memory`` splits them (P / m in serve, fsdp x tp in train) and
  caches by ``kv_policy``'s head shards; each kernel over batch and its
  heads' shards.  Region work is taken as counted.  The dense layers'
  collectives are modeled from the rules and listed by name
  (``modeled_terms``): in serve one all-reduce over ``model`` of each
  mixer's and each dense FFN's (b_loc, S, d_model) output; in train the
  same in the forward, the remat recompute and the backward, plus each
  layer's fsdp all-gather (forward and recompute) and gradient
  reduce-scatter over ``data``.

On a 1 x 1 mesh ``modeled`` equals ``counted_rank0``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.interop import torch_dtype
from repro_torch.launch import hw
from repro_torch.launch.hlo_analysis import StepRecorder, collective_bytes, op_histogram
from repro_torch.launch.mesh import data_shards, make_production_mesh
from repro_torch.launch.specs import build_cell, cell_skip_reason, make_rules, modeled_memory
from repro_torch.models import lm
from repro_torch.sharding.partition import axis_rules, axis_sizes

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs: 6·N·D train, 2·N·D serve (N = active params)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


def roofline(cost, coll, n_chips, cfg, shape) -> dict:
    """The reference's roofline over the port's H100 constants
    (``launch.hw``): bf16 tensor-core peak, HBM3 rate, and the NVLink rate
    in place of v5e's ICI.  A 16-wide model axis spans two 8-GPU hosts, so
    the NVLink rate flatters its collectives."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(coll.get("total", 0.0))
    terms = {
        "compute_s": flops_dev / hw.PEAK_FLOPS_BF16,
        "memory_s": bytes_dev / hw.HBM_BW,
        "collective_s": coll_dev / hw.NVLINK_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = flops_dev * n_chips
    return {
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_flop_ratio": (mf / hlo_global) if hlo_global else 0.0,
        "roofline_fraction": (mf / hw.PEAK_FLOPS_BF16 / n_chips)
        / max(sum(terms.values()), 1e-30),
        "bound_time_s": max(terms.values()),
        "sum_time_s": sum(terms.values()),
    }


@contextlib.contextmanager
def fake_group(multi_pod: bool):
    """A fake process group of 256 ranks (16 x 16) or 512 (2 x 16 x 16) in
    this process (``torch.testing._internal.distributed.fake_pg``: every
    collective returns at once, moving nothing) and the production
    ``DeviceMesh`` over it; the group is destroyed on exit.  Refuses to run
    while another default group is initialized."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is initialized already; the dry run "
                           "opens a fake one of its own (run it in its own process)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        dist.destroy_process_group()


def step_args(plan, shape: InputShape):
    """The plan's arguments as the step is traced: a decode plan's ``meta``
    ``pos`` becomes the int S - 1, the last slot, so the step attends the
    whole cache as the reference's count does."""
    if shape.kind == "decode":
        return (*plan.args[:-1], shape.seq_len - 1)
    return plan.args


def count_step(kind: str, fn, args) -> StepRecorder:
    """Run ``fn(*args)`` once under a recorder (the step's parameters,
    optimizer state and caches told apart by ``kind``'s argument order)
    and return it."""
    state = args[:2] if kind == "train" else args[:1]
    caches = args[1] if kind == "decode" else None
    with StepRecorder(params=state, caches=caches) as rec:
        fn(*args)
    rec.check_closed()
    return rec


def trace_cell(arch: str, shape_name: str, mesh, multi_pod: bool, overrides=None,
               shape: Optional[InputShape] = None, cfg: Optional[ModelConfig] = None):
    """Build the cell's plan on ``mesh`` under its rules and count its step
    on ``meta``.  Returns (plan, recorder)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    with axis_rules(mesh, make_rules(cfg, shape, multi_pod)):
        plan = build_cell(arch, shape_name, mesh, multi_pod, overrides, cfg=cfg, shape=shape)
        rec = count_step(shape.kind, plan.fn, step_args(plan, shape))
    return plan, rec


def _shards(n: int, m: int) -> int:
    return m if n and n % m == 0 else 1


def _nbytes(tree) -> int:
    from repro_torch.interop import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def modeled_collectives(cfg: ModelConfig, shape: InputShape, mesh, plan) -> list:
    """The dense layers' GSPMD collectives in the rules' layout, one record
    a term (``count`` the times it runs a step), named."""
    sizes = axis_sizes(mesh)
    m, dp = sizes.get("model", 1), data_shards(mesh)
    B = shape.global_batch
    b_loc = max(B // dp, 1)
    S = 1 if shape.kind == "decode" else shape.seq_len
    dtype = torch_dtype(plan.meta["compute_dtype"])
    layers = lm.layer_sequence(cfg)
    mixers = len(layers)
    ffns = sum(1 for s in layers if s.ffn and not s.moe)
    if shape.kind != "train":
        return [
            {"name": "mixer output all-reduce over model", "kind": "all-reduce",
             "dtype": dtype, "shape": (b_loc, S, cfg.d_model), "group": m, "count": mixers},
            {"name": "dense FFN output all-reduce over model", "kind": "all-reduce",
             "dtype": dtype, "shape": (b_loc, S, cfg.d_model), "group": m, "count": ffns},
        ]
    mb = max(int(plan.meta.get("num_microbatches", 1)), 1)
    b_mb = max(b_loc // mb, 1)
    params = plan.args[0]
    layer_elems = (_nbytes({"p": params["pattern"], "r": params["remainder"]}) // 4
                   // max(len(layers), 1))
    passes = 3  # forward, remat recompute, backward
    return [
        {"name": "mixer output all-reduce over model (forward, recompute, backward)",
         "kind": "all-reduce", "dtype": dtype, "shape": (b_mb, S, cfg.d_model), "group": m,
         "count": mixers * passes * mb},
        {"name": "dense FFN output all-reduce over model (forward, recompute, backward)",
         "kind": "all-reduce", "dtype": dtype, "shape": (b_mb, S, cfg.d_model), "group": m,
         "count": ffns * passes * mb},
        {"name": "fsdp all-gather of each layer's params over data (forward, recompute)",
         "kind": "all-gather", "dtype": torch.float32, "shape": (layer_elems // m,),
         "group": dp, "count": len(layers) * 2 * mb},
        {"name": "gradient reduce-scatter of each layer over data", "kind": "reduce-scatter",
         "dtype": torch.float32, "shape": (layer_elems // (m * dp),), "group": dp,
         "count": len(layers) * mb},
    ]


def summarize(rec: StepRecorder, cfg: ModelConfig, shape: InputShape, mesh, plan) -> Dict:
    """``counted_rank0`` and ``modeled`` cost columns, the collectives of
    each, and the modeled memory."""
    sizes = axis_sizes(mesh)
    m, dp = sizes.get("model", 1), data_shards(mesh)
    B = shape.global_batch
    bdiv = B / max(B // dp, 1)  # batch shards that hold rows
    train = shape.kind == "train"
    memory = modeled_memory(cfg, shape, mesh, plan.meta)
    param_div = dp * m if train else m
    cache_div = 1.0
    if shape.kind == "decode" and memory["cache_bytes"]:
        cache_div = _nbytes(plan.args[1]) / memory["cache_bytes"]
    hq = _shards(cfg.n_heads, m)
    hkv = _shards(cfg.n_kv_heads * plan.meta.get("kv_repeat", 1), m)
    hs = _shards(cfg.ssm_heads, m)
    kernel_div = {  # (flops, bytes) divisors of each kernel's cost
        "flash_attention": (bdiv * hq, bdiv * hkv),
        "decode_attention": (bdiv * hq, cache_div),
        "ssd_scan": (bdiv * hs, bdiv * hs),
        "overlay_patch": (1.0, 1.0),
    }

    flops = nbytes = 0.0
    for (scope, _), (_, f, pb, cb, ab, sb) in rec.ops.items():
        if scope == "region":
            flops, nbytes = flops + f, nbytes + pb + cb + ab + sb
        elif scope == "global":
            flops += f / (bdiv * m)
            nbytes += pb / param_div + cb / cache_div + ab / bdiv + sb / (bdiv * m)
    for (scope, name), (_, f, b) in rec.kernels.items():
        fd, bd = kernel_div[name] if scope == "global" else (1.0, 1.0)
        flops += f / fd
        nbytes += b / bd

    counted = rec.totals()
    edge = rec.totals(("edge",))
    records = rec.collectives
    region = [r for r in records if not r["view"]]
    terms = modeled_collectives(cfg, shape, mesh, plan)
    return {
        "memory": memory,
        "counted_rank0": {
            "flops": counted["flops"], "bytes": counted["bytes"],
            **{k: v for k, v in counted.items() if k.endswith("_bytes") and k != "kernel_bytes"},
            "kernel_flops": counted["kernel_flops"], "kernel_bytes": counted["kernel_bytes"],
            "aten_ops": counted["ops"], "kernel_calls": rec.kernel_calls(),
            "edge_bytes": edge["bytes"],
        },
        "modeled": {"flops": flops, "bytes": nbytes, "param_div": param_div,
                    "cache_div": cache_div, "batch_div": bdiv, "model_div": m},
        "collectives_counted_rank0": collective_bytes(records),
        "collectives_view": collective_bytes(records, view=True),
        "collectives": collective_bytes(region + terms),
        "modeled_terms": [{**t, "dtype": str(t["dtype"]), "shape": list(t["shape"])}
                          for t in terms],
    }


def _cell_id(arch: str, shape_name: str, multi_pod: bool, tag: str = "") -> str:
    cell_id = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    return f"{cell_id}.{tag}" if tag else cell_id


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides=None, tag="",
             save_ops=False, shape: Optional[InputShape] = None,
             results: Path = RESULTS) -> dict:
    """Trace one cell on the production mesh of a fake group; ``shape``
    overrides ``SHAPES[shape_name]`` (a cell cut to one card keeps its
    name).  ``save_ops`` writes the op record to ``results``."""
    cell_id = _cell_id(arch, shape_name, multi_pod, tag)
    out = {"cell": cell_id, "arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}

    skip = cell_skip_reason(arch, shape_name)
    if skip:
        out["skipped"] = skip
        return out

    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]
    with fake_group(multi_pod) as mesh:
        t0 = time.time()
        plan, rec = trace_cell(arch, shape_name, mesh, multi_pod, overrides, shape=shape, cfg=cfg)
        trace_s = round(time.time() - t0, 2)
        n_chips = mesh.size()
        s = summarize(rec, cfg, shape, mesh, plan)
    if save_ops:
        results.mkdir(parents=True, exist_ok=True)
        ops = {"ops": {f"{sc} {name}": r for (sc, name), r in sorted(rec.ops.items())},
               "kernels": {f"{sc} {name}": r for (sc, name), r in sorted(rec.kernels.items())},
               "collectives": [{**c, "dtype": str(c["dtype"])} for c in rec.collectives],
               "histogram": op_histogram(rec)}
        (results / f"{cell_id}.ops.json").write_text(json.dumps(ops, indent=1))
    cost = {"flops": s["modeled"]["flops"], "bytes accessed": s["modeled"]["bytes"]}
    out.update(
        meta=plan.meta,
        trace_s=trace_s,
        n_chips=n_chips,
        memory={"modeled": s["memory"], "fits_hbm": s["memory"]["fits_hbm"]},
        cost={
            "flops_per_device": s["modeled"]["flops"],
            "bytes_per_device": s["modeled"]["bytes"],
            "measure_points": "eager: every layer counted",
            "counted_rank0": s["counted_rank0"],
            "modeled": s["modeled"],
        },
        collectives=s["collectives"],
        modeled_terms=s["modeled_terms"],
        collectives_counted_rank0=s["collectives_counted_rank0"],
        collectives_view=s["collectives_view"],
        roofline=roofline(cost, s["collectives"], n_chips, cfg, shape),
    )
    return out


def iter_cells(args):
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                yield arch, shape, mp


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-ops", action="store_true",
                    help="write each cell's op record to <cell>.ops.json")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="step overrides, e.g. --set kv_dtype=int8")
    ap.add_argument("--results", type=Path, default=RESULTS,
                    help=f"directory of the cells' JSON (default {RESULTS})")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    overrides = {}
    for kv in args.overrides:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            pass
        overrides[k] = v

    args.results.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch, shape, mp in iter_cells(args):
        cell_id = _cell_id(arch, shape, mp, args.tag)
        path = args.results / f"{cell_id}.json"
        if path.exists() and not args.force:
            print(f"[skip-cached] {cell_id}")
            continue
        print(f"[run] {cell_id} ...", flush=True)
        t0 = time.time()
        try:
            res = run_cell(arch, shape, mp, overrides or None, args.tag, args.save_ops,
                           results=args.results)
        except Exception as e:  # record failures: they are bugs in the system
            failures += 1
            res = {"cell": cell_id, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            print(f"[FAIL] {cell_id}: {e}")
        path.write_text(json.dumps(res, indent=2))
        status = "skipped" if "skipped" in res else ("FAILED" if "error" in res else "ok")
        if status == "ok":
            r = res["roofline"]
            print(
                f"[done {time.time()-t0:6.1f}s] {cell_id}: {status} "
                f"dominant={r['dominant']} fit={res['memory']['fits_hbm']} "
                f"useful={r['useful_flop_ratio']:.2f} roofline={r['roofline_fraction']:.2f} "
                f"compute_s={r['compute_s']:.4g} memory_s={r['memory_s']:.4g} "
                f"collective_s={r['collective_s']:.4g}",
                flush=True,
            )
        else:
            print(f"[done {time.time()-t0:6.1f}s] {cell_id}: {status}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
