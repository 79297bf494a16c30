#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. Builds the hand-written kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a) and prints the build time.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and times kernel, plain version and one PyTorch call
   for the same function where there is one (a yardstick the port never
   calls).
4. Runs the main path at full width: qwen1.5-0.5b unreduced, f32, random
   weights from seed 0.  A ``BaseImage`` of the weights goes into the node's
   cache; ``fn-base`` is published against it, and a fine-tune ``fn-ft``
   too; each is cold-started (Spice restore, fused install through the
   overlay-patch kernel, layer-gated generation through the attention
   kernels) a few times, then served warm once.  Every request's tokens
   must equal the port's generation on the CPU over the same weights, which
   runs the plain versions.
5. Prints one JSON line with every kernel's launches on the main path, its
   error against the plain version and its times, then the result line.

Exits non-zero on any failure, without a CUDA device, and when the port's
sources are not beside it.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

ARCH = "qwen1.5-0.5b"
SEED = 0
BATCH, PROMPT_LEN, MAX_NEW = 2, 16, 8
COLD_REPEATS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM, f32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "int8": 2e-4}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    """(least time in ms, what bounds it) on an H100 SXM."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels
def check_overlay_patch(torch, rng, dev):
    from repro_torch.kernels.overlay_patch.ops import overlay_patch, overlay_patch_plain

    page_bytes = 64 << 10
    worst = 0.0
    cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        elems = page_bytes // torch.empty((), dtype=dtype).element_size()
        # an MLP matrix of the path (1024 x 2816 f32 = 176 pages), a
        # no-private tensor and a single page, each with mixed kinds
        for n_pages, n_priv in ((176, 40), (176, 0), (1, 1)):
            kinds = rng.integers(0, 3, n_pages).astype("int32")
            if n_priv == 0:
                kinds[kinds == 2] = 1
            src = rng.integers(-2, n_priv + 2, n_pages).astype("int32")
            if dtype == torch.int8:
                base = torch.randint(-128, 128, (n_pages, elems), dtype=torch.int8, device=dev)
                priv = torch.randint(-128, 128, (n_priv, elems), dtype=torch.int8, device=dev)
            else:
                base = torch.randn(n_pages, elems, device=dev).to(dtype)
                priv = torch.randn(n_priv, elems, device=dev).to(dtype)
            k_t = torch.from_numpy(kinds).to(dev)
            s_t = torch.from_numpy(src).to(dev)
            got = overlay_patch(base, priv, k_t, s_t)
            want = overlay_patch_plain(base, priv, k_t, s_t)
            torch.cuda.synchronize()
            exact = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            err = (got.float() - want.float()).abs().max().item()
            cases.append(f"{str(dtype)[6:]} pages={n_pages} priv={n_priv} exact={exact}")
            check(exact, f"overlay_patch not bit-exact: {cases[-1]}")
            worst = max(worst, err)
    # time at the path's largest fused tensor: the tied embedding
    # (151936 x 1024 f32 = 9496 pages), all BASE but every 64th page PRIVATE
    n_pages, elems = 9496, (64 << 10) // 4
    kinds = torch.ones(n_pages, dtype=torch.int32, device=dev)
    kinds[::64] = 2
    n_priv = int((kinds == 2).sum())
    src = torch.cumsum((kinds == 2).int(), 0).int() - 1
    base = torch.randn(n_pages, elems, device=dev)
    priv = torch.randn(n_priv, elems, device=dev)
    ms = time_ms(lambda: overlay_patch(base, priv, kinds, src), iters=20)
    plain_ms = time_ms(lambda: overlay_patch_plain(base, priv, kinds, src), iters=5)
    moved = base.nbytes * 2  # every page written once, read once (BASE/PRIVATE)
    b_ms, b_by = bound(moved, 0)
    for c in cases:
        print(f"  overlay_patch {c}")
    print(f"  overlay_patch embed-size: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" bound {b_ms:.4f} ms ({moved / ms / 1e6:.1f} GB/s)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_flash_attention(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    H, hd = 16, 64
    worst = 0.0
    # (B, kvH, S, window, dtype): the path's prefill, ragged S, GQA, window, bf16
    for B, kvH, S, window, dtype in (
        (BATCH, H, PROMPT_LEN, None, torch.float32),
        (BATCH, H, 5, None, torch.float32),
        (BATCH, H, 12, None, torch.float32),
        (BATCH, 4, PROMPT_LEN, None, torch.float32),
        (BATCH, H, 40, 8, torch.float32),
        (BATCH, H, PROMPT_LEN, None, torch.bfloat16),
    ):
        q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
        k = torch.randn(B, kvH, S, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(B, kvH, S, hd, generator=g, device=dev).to(dtype)
        got = flash_attention(q, k, v, window=window)
        want = flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        name = str(dtype)[6:]
        print(f"  flash_attention B={B} H={H} kvH={kvH} S={S} window={window}"
              f" {name}: max abs err {err:.3e}")
        check(err <= TOL[name], f"flash_attention error {err} > {TOL[name]}")
        if dtype == torch.float32:
            worst = max(worst, err)
    B, S = BATCH, PROMPT_LEN
    q = torch.randn(B, H, S, hd, generator=g, device=dev)
    k = torch.randn(B, H, S, hd, generator=g, device=dev)
    v = torch.randn(B, H, S, hd, generator=g, device=dev)
    ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    nbytes = 4 * q.nbytes  # q, k, v read, o written
    flops = 4 * hd * (S * (S + 1) // 2) * B * H  # QK^T and PV, causal half
    b_ms, b_by = bound(nbytes, flops)
    print(f"  flash_attention path shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_decode_attention(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.models.attention import quantize_kv

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    H, hd, Sc = 16, 64, PROMPT_LEN
    worst = 0.0
    # (kvH, pos, kv dtype): the path's decode (the cache never grows past
    # the prompt, so pos >= Sc: every slot valid), a partial cache, GQA,
    # int8 with per-slot scales, bf16
    for kvH, pos, kv in (
        (H, PROMPT_LEN + 3, "float32"),
        (H, 9, "float32"),
        (4, 11, "float32"),
        (H, PROMPT_LEN, "int8"),
        (H, 7, "bfloat16"),
    ):
        q = torch.randn(BATCH, H, hd, generator=g, device=dev)
        k = torch.randn(BATCH, kvH, Sc, hd, generator=g, device=dev)
        v = torch.randn(BATCH, kvH, Sc, hd, generator=g, device=dev)
        ks = vs = None
        if kv == "int8":
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
        elif kv == "bfloat16":
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got = decode_attention(q, k, v, pos, ks, vs)
        want = decode_attention_plain(q, k, v, pos, ks, vs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"  decode_attention H={H} kvH={kvH} Sc={Sc} pos={pos} {kv}:"
              f" max abs err {err:.3e}")
        check(err <= TOL[kv], f"decode_attention error {err} > {TOL[kv]}")
        if kv == "float32":
            worst = max(worst, err)
    q = torch.randn(BATCH, H, hd, generator=g, device=dev)
    k = torch.randn(BATCH, H, Sc, hd, generator=g, device=dev)
    v = torch.randn(BATCH, H, Sc, hd, generator=g, device=dev)
    pos = PROMPT_LEN + 3
    ms = time_ms(lambda: decode_attention(q, k, v, pos))
    plain_ms = time_ms(lambda: decode_attention_plain(q, k, v, pos))
    q4 = q[:, :, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k, v))
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    flops = 4 * hd * Sc * BATCH * H
    b_ms, b_by = bound(nbytes, flops)
    print(f"  decode_attention path shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


# -------------------------------------------------------------- main path
def fine_tune(params, cfg):
    """Perturb one 64 KiB page of every layer's attention output matrix and
    the final norm: the rest of the image stays identical to the base."""
    rows = (64 << 10) // (cfg.d_model * 4)
    wo = params["pattern"][0]["attn"]["wo"].clone()
    wo[:, :rows, :] += 0.01
    attn = dict(params["pattern"][0]["attn"], wo=wo)
    layer = dict(params["pattern"][0], attn=attn)
    return dict(params, pattern=(layer,), final_norm=params["final_norm"] + 0.01)


def profile_cold_start(torch, np, node, cfg, prompt, want):
    """One more cold start of fn-ft under torch.profiler: the device's busy
    share of the request and the kernels that take its device time."""
    from torch.profiler import ProfilerActivity, profile

    node.evict()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        r = node.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(r.tokens, want), "profiled cold start: tokens differ")

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if not events:
        print("  profiled cold start: the profiler saw no device time (not measured)")
        return
    print(f"  profiled cold start fn-ft: wall {wall_ms:.1f} ms (ttft {r.ttft_s * 1e3:.1f} ms),"
          f" device busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of the request")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:80]}")


def main_path(torch, np, dev, counters):
    from repro_torch.configs import get_config
    from repro_torch.core import BaseImage, BufferPool
    from repro_torch.interop import tree_leaves
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServerlessNode, generate, layerwise_state

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=dev)
    tuned = fine_tune(params, cfg)
    image_bytes = sum(t.nbytes for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads, vocab {cfg.vocab_size};"
          f" image {image_bytes / 1e9:.3f} GB f32 (init {time.perf_counter() - t0:.1f} s)")
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)

    # CPU references first (plain versions), over the same layerwise state
    t0 = time.perf_counter()
    host_base = layerwise_state(cfg, params)
    host_ft = layerwise_state(cfg, tuned)
    ref = {
        "fn-base": generate(cfg, None, host_base, prompt, MAX_NEW, device="cpu")[0],
        "fn-ft": generate(cfg, None, host_ft, prompt, MAX_NEW, device="cpu")[0],
    }
    del host_ft
    print(f"  CPU reference tokens in {time.perf_counter() - t0:.1f} s")

    # one ledger charges host and device bytes alike: the host base image,
    # its device copy in the DeviceImageCache, the restored instance and the
    # publish scratch reach 3 images at once; the 2 GiB default refuses even
    # one restore at full width
    budget = 4 * image_bytes
    node = ServerlessNode(
        device=dev, install="fused", pool=BufferPool(capacity_bytes=image_bytes),
        memory_budget_bytes=budget,
    )
    d = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        node.node_cache.put(BaseImage.from_state("qwen-base", host_base), evictable=False)
        del host_base
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t_path = time.perf_counter()
        for fname, p in (("fn-base", params), ("fn-ft", tuned)):
            t0 = time.perf_counter()
            spec = node.publish(fname, cfg, p, d, base_name="qwen-base",
                                formats=("jif",), warm_ttl_s=600.0)
            st = node.catalog.publish_stats(fname)
            print(f"  publish {fname}: {time.perf_counter() - t0:.2f} s, jif "
                  f"{os.path.getsize(spec.jif_path)} B, private "
                  f"{st.private_bytes} B of {st.total_bytes} B")
        plan = [(f, "cold") for f in ("fn-base", "fn-ft") for _ in range(COLD_REPEATS)]
        plan.append(("fn-ft", "warm"))
        for fname, kind in plan:
            if kind == "cold":
                node.evict()
            r = node.invoke(fname, prompt, MAX_NEW, mode="spice", cfg=cfg)
            check(r.cold == (kind == "cold"), f"{fname}: expected a {kind} start")
            same = np.array_equal(r.tokens, ref[fname])
            check(same, f"{fname} {kind}: tokens {r.tokens.tolist()} != CPU "
                        f"plain path {ref[fname].tolist()}")
            s = r.stats or {}
            row = {"function": fname, "start": kind, "ttft_ms": r.ttft_s * 1e3,
                   "total_ms": r.total_s * 1e3}
            for key in ("metadata_s", "first_tensor_s", "total_s", "bytes_read",
                        "base_bytes", "uploaded_bytes", "patched_on_device_bytes",
                        "upload_s"):
                if key in s:
                    row[key] = s[key].item() if hasattr(s[key], "item") else s[key]
            print("  request " + json.dumps(row))
        path_s = time.perf_counter() - t_path
        launches = {n: c.count for n, c in counters.items()}
        print(f"  main path {path_s:.1f} s; launches {launches}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        hw = node.memory.high_water()
        print(f"  ledger high water {hw['total'] / image_bytes:.2f} images of a "
              f"{budget / image_bytes:.0f}-image budget: "
              + ", ".join(f"{k} {v / image_bytes:.2f}" for k, v in hw.items() if v))
        print(f"  device image cache {node.scheduler.device_images.snapshot_stats()}")
        print(f"  upload stream {node.scheduler.upload_stream.snapshot_stats()}")
        profile_cold_start(torch, np, node, cfg, prompt, ref["fn-ft"])
        node.memory.audit()
        check(node.scheduler.upload_stream.snapshot_stats()["failures"] == 0,
              "upload failures")
        for name, n in launches.items():
            check(n > 0, f"kernel {name} was not launched on the main path")
        return launches
    finally:
        node.close()
        shutil.rmtree(d, ignore_errors=True)


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's sources are not beside this script ({SRC}/repro_torch)")
    sys.path.insert(0, SRC)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from repro_torch.device import resolve_device
    from repro_torch.kernels import launch_counters, native

    dev = resolve_device("cuda")
    print("== build")
    t0 = time.perf_counter()
    native.library()
    info = native.build_info()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s -> {info['path']}")
    for line in str(info["log"]).splitlines():
        if "registers" in line or "error" in line or line.startswith("---"):
            print("  " + line.strip())

    print("== kernels against their plain versions")
    rng = np.random.default_rng(SEED)
    measured = {
        "overlay_patch": check_overlay_patch(torch, rng, dev),
        "flash_attention": check_flash_attention(torch, dev),
        "decode_attention": check_decode_attention(torch, dev),
    }

    print("== main path: publish, Spice restore, fused install, generate")
    counters = launch_counters()
    launches = main_path(torch, np, dev, counters)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    check(not leaked, f"the port imported the JAX side: {leaked[:5]}")

    meta = {
        "overlay_patch": ("src/repro_torch/csrc/overlay_patch.cu",
                          "src/repro/kernels/overlay_patch/kernel.py:39"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:68"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:60"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        m = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
