#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. Builds the hand-written kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a) and prints the build time.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and times kernel, plain version and one PyTorch call
   for the same function where there is one (a yardstick the port never
   calls).  The SSD-scan kernel is timed at the path shape, S 1024 and
   S 4096, with each of its kernels' device time at S 1024 from the
   profiler.  K2 and K3 are also checked and timed at head dim 168, the
   repo's gemma3-27b config (d_model / n_heads; zero-padded to their
   compiled 192): at that path's own shapes and at long ones.
4. Runs the two main paths at full width, f32, random weights from seed 0:
   qwen1.5-0.5b (attention) and mamba2-780m (SSD).  For each, a
   ``BaseImage`` of the weights goes into the node's cache; a base function
   is published against it, and a fine-tune too; each is cold-started
   (Spice restore, fused install through the overlay-patch kernel,
   layer-gated generation through the attention kernels or the SSD-scan
   kernel) a few times, then served warm once.  Every request's tokens
   must equal the port's generation on the CPU over the same weights, which
   runs the plain versions.  Then gemma3-27b generates at full width with
   its depth cut to one local and one global layer (tokens and every
   step's logits against the CPU path), and the serving policies run on
   qwen1.5-0.5b's fine-tune: a ``ServerlessNode`` with a ``PrewarmPolicy``
   and a ``PrewarmEngine`` over six arrivals on a virtual clock, the
   policy's TTLs deciding every eviction; a warm handoff of a tree with one
   dirty page between two nodes on the card (its restore's time split on
   the host and the device) and an ``AutoScaler`` drain that hands it
   back; a ``RolloutController`` canary of a v2, its gate, promote and
   rollback.  The launch counts are set to 0 just before each path and
   read just after it.
5. Prints one JSON line with every kernel's launches on the main paths, its
   error against the plain version and its times, then the result line.

Exits non-zero on any failure, without a CUDA device, and when the port's
sources are not beside it.
"""
import contextlib
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
SSM_ARCH = "mamba2-780m"
GEMMA_ARCH = "gemma3-27b"
SEED = 0
BATCH, PROMPT_LEN, MAX_NEW = 2, 16, 8
# the repo's gemma3-27b config: H, kvH and hd.  The config sets no
# head_dim, so hd is d_model / n_heads = 5376 / 32 = 168, as the JAX package
# computes it (the config's source is marked unverified)
GEMMA_HEADS = (32, 16, 168)
COLD_REPEATS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM, f32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM, bf16 dense on the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "int8": 2e-4}
REL_RMS_BF16 = 1e-2  # bf16 is also held to rel_rms(got, want) <= this
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # tests/test_kernels.py::test_ssd_scan


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one call through its wrapper, from CUDA events around
    ``iters`` calls issued back to back (at small shapes the host's cost
    per call, not the device's, sets it)."""
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


def rel_rms(got, want) -> float:
    """rms(got - want) / rms(want): the bf16 checks' measure, which scales
    with the outputs (averages over thousands of keys are small)."""
    d = got.float() - want.float()
    return (d.pow(2).mean() / want.float().pow(2).mean()).sqrt().item()


def host_us(*fns, iters: int = 200, rounds: int = 5):
    """Host time of one call in microseconds: ``time.perf_counter`` over
    ``iters`` calls with no synchronize between them (one after), the least
    of ``rounds`` such runs, the functions' rounds taking turns."""
    import torch

    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            best[i] = min(best[i], (t1 - t0) / iters * 1e6)
    return best[0] if len(fns) == 1 else best


def device_us(fn, launches: int = 20, replays: int = 10):
    """(device microseconds per call, method): ``launches`` calls captured
    in one CUDA graph and replayed between CUDA events, so the host is out
    of the time.  Where capture fails, the profiler's device time per call
    (method "profiler")."""
    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) * 1e3 / (replays * launches), "cuda graph"
    except Exception as e:  # noqa: BLE001 - report and fall back to the profiler
        print(f"    (graph capture failed: {type(e).__name__}: {e}; profiler time instead)")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages())
    return total / launches, "profiler"


def bound(nbytes: float, flops: float, dtype: str = "float32"):
    """(least time in ms, what bounds it) on an H100 SXM: bytes over the
    memory rate; operations over the tensor cores' rate in bf16, the CUDA
    cores' in f32."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_shape(label, kernel, plain, library, nbytes, flops, dtype):
    """Every number of one timed shape: through the wrapper (CUDA events),
    on the host and on the device (CUDA graph), for the kernel and for the
    library call (None where no PyTorch call computes the function) in
    turns; the plain version's ms; the bound."""
    row = {"shape": label, "ms": time_ms(kernel), "library_ms": None,
           "library_host_us": None, "library_device_us": None}
    method = lib = ""
    if library is None:
        row["host_us"] = host_us(kernel)
        row["device_us"], method = device_us(kernel)
        lib = "; no library call"
    else:
        row["library_ms"] = time_ms(library)
        row["host_us"], row["library_host_us"] = host_us(kernel, library)
        row["device_us"], method = device_us(kernel)
        row["library_device_us"], lib_method = device_us(library)
        method += "" if lib_method == method else f" / library {lib_method}"
        lib = (f"; sdpa {row['library_ms']:.4f} ms, {row['library_device_us']:.2f} us device,"
               f" {row['library_host_us']:.2f} us host")
    row["plain_ms"] = time_ms(plain)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    row["device_time_by"] = method
    print(f"  {label}: kernel {row['ms']:.4f} ms, {row['device_us']:.2f} us device ({method}),"
          f" {row['host_us']:.2f} us host{lib}; plain {row['plain_ms']:.4f} ms;"
          f" bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
    return row


def ptxas_report(log: str) -> list:
    """Print ``-Xptxas -v``'s registers, stack frame and spills of every
    kernel; return the attention and SSD-scan kernels (K2, K3, K4) that
    keep a stack frame or spill (an array in local memory cost K4 a factor
    of 2 before)."""
    import re

    kernels, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = kernels.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)), spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    if not kernels:
        print("  (no compiler report: the library was built before this process)")
        return []
    names = list(kernels)
    filt = shutil.which("c++filt")
    if filt:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    bad = []
    for (mangled, r), name in zip(kernels.items(), names):
        if "stack" not in r:  # a device function's properties, not a kernel's
            continue
        print(f"  ptxas {name[:100]}: {r.get('registers', '?')} registers, {r['stack']} bytes"
              f" stack frame, {r['spill_st']} / {r['spill_ld']} bytes spill stores / loads")
        if any(k in mangled for k in ("flash_", "decode_", "ssd_")) and (
                r["stack"] or r["spill_st"] or r["spill_ld"]):
            bad.append(name)
    return bad


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
    dev_us, method = device_us(lambda: overlay_patch(base, priv, kinds, src))
    plain_ms = time_ms(lambda: overlay_patch_plain(base, priv, kinds, src), iters=5)
    moved = base.nbytes * 2  # every page written once, read once (BASE/PRIVATE)
    b_ms, b_by = bound(moved, 0)
    for c in cases:
        print(f"  overlay_patch {c}")
    print(f"  overlay_patch embed-size: kernel {ms:.4f} ms, {dev_us:.2f} us device ({method}),"
          f" plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({moved / ms / 1e6:.1f} GB/s)")
    row = {"shape": "embed-size: 9496 f32 pages of 64 KiB, 1 in 64 PRIVATE", "ms": ms,
           "device_us": dev_us, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "library_device_us": None, "device_time_by": method}
    return summary(worst, [row])


def flash_case(torch, g, dev, B, H, kvH, S, hd, dtype, strided=False):
    """q, k, v (and an ``out`` view) of one flash-attention call; strided
    as ``attn_full`` makes them: (B, S, heads, hd) tensors seen as
    (B, heads, S, hd)."""
    if strided:
        q, k, v, out = (torch.randn(B, S, h, hd, generator=g, device=dev).to(dtype)
                        for h in (H, kvH, kvH, H))
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), out.transpose(1, 2)
    q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, kvH, S, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, kvH, S, hd, generator=g, device=dev).to(dtype)
    return q, k, v, None


def check_flash_attention(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    H, hd = 16, 64
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, H, kvH, S, hd, window, causal, dtype, strided): the path's prefill
    # (as attn_full calls it: strided views and out=), ragged S, GQA,
    # windows, bf16, long and ragged prompts, both head dims of each dtype
    # (every compiled variant), and head dims that run zero-padded (16, the
    # reduced configurations' that the serving CLI runs by default; 96)
    cases = [
        (BATCH, H, H, PROMPT_LEN, hd, None, True, f32, True),
        (BATCH, H, H, PROMPT_LEN, hd, None, True, f32, False),
        (BATCH, H, H, 5, hd, None, True, f32, False),
        (BATCH, H, H, 12, hd, None, True, f32, False),
        (BATCH, H, 4, PROMPT_LEN, hd, None, True, f32, False),
        (BATCH, H, H, 40, hd, 8, True, f32, False),
        (BATCH, H, H, PROMPT_LEN, hd, None, True, bf16, False),
        (BATCH, H, H, PROMPT_LEN, hd, None, True, bf16, True),
        (BATCH, H, H, 300, hd, None, True, f32, False),
        (BATCH, H, H, 300, hd, None, True, bf16, False),
        (1, H, H, 2048, hd, 1024, True, f32, False),
        (1, H, 4, 2048, hd, 1024, True, bf16, False),
        (1, 8, 2, 300, 128, None, True, f32, True),
        (1, 8, 2, 300, 128, None, True, bf16, True),
        (1, 8, 8, 130, 128, 40, True, f32, False),
        (1, 8, 8, 130, 128, None, False, bf16, False),
        (2, 4, 4, 77, hd, None, False, f32, False),
        (BATCH, 4, 2, PROMPT_LEN, 16, None, True, f32, True),
        (BATCH, 4, 2, PROMPT_LEN, 16, None, True, bf16, True),
        (1, 8, 4, 130, 96, 40, True, f32, False),
        # the wide instances (hd 192 and 256: f32 32-key tiles, bf16 Q read
        # again at each tile) and head dims that run zero-padded to them
        (1, 8, 4, 300, 192, None, True, f32, True),
        (1, 8, 4, 300, 192, 100, True, bf16, True),
        (1, 8, 2, 300, 256, 100, True, f32, False),
        (1, 8, 2, 300, 256, None, True, bf16, True),
        (1, 8, 8, 130, 256, None, False, f32, False),
        (1, 8, 8, 130, 192, None, False, bf16, False),
        (2, 4, 2, 77, 136, 40, True, f32, False),
        (2, 4, 2, 77, 200, None, True, bf16, True),
        # the gemma3-27b path's prefill, as attn_full calls it: its local
        # layer (window 1024, wider than the prompt) and its global layer
        (BATCH, *GEMMA_HEADS[:2], PROMPT_LEN, GEMMA_HEADS[2], 1024, True, f32, True),
        (BATCH, *GEMMA_HEADS[:2], PROMPT_LEN, GEMMA_HEADS[2], None, True, f32, True),
    ]
    for B, h, kvH, S, d, window, causal, dtype, strided in cases:
        q, k, v, out = flash_case(torch, g, dev, B, h, kvH, S, d, dtype, strided)
        got = flash_attention(q, k, v, causal=causal, window=window, out=out)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(out is None or got is out, "flash_attention did not write into out=")
        err = (got.float() - want.float()).abs().max().item()
        name = str(dtype)[6:]
        rel = f", rel rms {rel_rms(got, want):.3e}" if dtype == bf16 else ""
        print(f"  flash_attention B={B} H={h} kvH={kvH} S={S} hd={d} window={window}"
              f" causal={causal} {name}{' strided' if strided else ''}: max abs err"
              f" {err:.3e}{rel}")
        check(err <= TOL[name], f"flash_attention error {err} > {TOL[name]}")
        if dtype == f32:
            worst = max(worst, err)
        else:
            check(rel_rms(got, want) <= REL_RMS_BF16,
                  f"flash_attention bf16 rel rms {rel_rms(got, want)} > {REL_RMS_BF16}")
        if (S, window, dtype) == (2048, 1024, bf16):
            # the bf16 check against a planted fault: the kernel run with
            # its window one 64-key tile short drops each row's oldest tile
            fault = flash_attention(q, k, v, causal=causal, window=window - 64)
            rr = rel_rms(fault, want)
            print(f"    planted fault (window {window - 64}, one tile dropped): max abs err"
                  f" {(fault.float() - want.float()).abs().max().item():.3e}, rel rms {rr:.3e}")
            check(rr > REL_RMS_BF16, "the bf16 check would not catch a dropped tile")

    shapes = []
    for what, B, h, kvH, S, d, dtype in (
        ("path shape", BATCH, H, H, PROMPT_LEN, hd, f32),
        ("long", 1, H, H, 2048, hd, f32),
        ("long", 1, H, H, 2048, hd, bf16),
        ("gemma3-27b path shape", BATCH, *GEMMA_HEADS[:2], PROMPT_LEN, GEMMA_HEADS[2], f32),
    ):
        name = str(dtype)[6:]
        path = S == PROMPT_LEN  # time the path's call as attn_full makes it
        q, k, v, out = flash_case(torch, g, dev, B, h, kvH, S, d, dtype, strided=path)
        nbytes = 2 * q.nbytes + 2 * k.nbytes  # q, k, v read, o written
        flops = 4 * d * (S * (S + 1) // 2) * B * h  # QK^T and PV, causal half
        gqa = kvH != h
        label = (f"flash_attention {what} B={B} H={h}{f' kvH={kvH}' if gqa else ''} S={S}"
                 f" hd={d} {name}{' strided' if path else ''}")
        shapes.append(timed_shape(
            label, lambda: flash_attention(q, k, v, out=out),
            lambda: flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=gqa),
            nbytes, flops, name))
    return summary(worst, shapes)


def summary(worst, shapes):
    """The kernels-line entry: the path shape's numbers, the others in
    ``shapes``."""
    first = shapes[0]
    return {"max_abs_err": worst, "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "device_us": first["device_us"],
            "library_device_us": first["library_device_us"], "shapes": shapes}


def check_decode_attention(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        TILE,
        decode_attention,
        decode_attention_plain,
        sm_count,
        split_plan,
    )
    from repro_torch.models.attention import quantize_kv

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    H, hd = 16, 64
    worst = 0.0
    n_sm = sm_count(dev)

    def case(B, h, kvH, Sc, d, pos, q_dtype, kv):
        q = torch.randn(B, h, d, generator=g, device=dev).to(getattr(torch, q_dtype))
        k = torch.randn(B, kvH, Sc, d, generator=g, device=dev)
        v = torch.randn(B, kvH, Sc, d, generator=g, device=dev)
        ks = vs = None
        if kv == "int8":
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
        else:
            k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
        return q, k, v, ks, vs

    # (B, H, kvH, Sc, hd, pos, q dtype, kv dtype): the path's decode (the
    # cache never grows past the prompt, so pos >= Sc: every slot valid), a
    # partial cache, GQA, int8, bf16; long caches with a partial last split
    # and with pos >= Sc; qwen3-32b's GQA shape; head dims that run
    # zero-padded (16, the reduced configurations', and 96); then every
    # compiled variant
    # (kv dtype, head dim, group rounded up to 1, 2, 4, 8, 16; G = 3 and 9
    # run with idle padding heads) with one split and with several, the
    # query in f32 and in bf16 by turns
    cases = [
        (BATCH, H, H, PROMPT_LEN, hd, PROMPT_LEN + 3, "float32", "float32"),
        (BATCH, H, H, PROMPT_LEN, hd, 9, "float32", "float32"),
        (BATCH, H, 4, PROMPT_LEN, hd, 11, "float32", "float32"),
        (BATCH, H, H, PROMPT_LEN, hd, PROMPT_LEN, "float32", "int8"),
        (BATCH, H, H, PROMPT_LEN, hd, 7, "bfloat16", "bfloat16"),
        (BATCH, H, H, 4096, hd, 2999, "float32", "float32"),
        (BATCH, H, H, 4096, hd, 5000, "float32", "float32"),
        (1, 64, 8, 4096, 128, 4095, "bfloat16", "bfloat16"),
        (1, 64, 8, 4096, 128, 3000, "bfloat16", "int8"),
        (1, 64, 8, 4096, 128, 4095, "float32", "int8"),
        (BATCH, 4, 2, PROMPT_LEN, 16, PROMPT_LEN + 3, "float32", "float32"),
        (BATCH, 4, 2, PROMPT_LEN, 16, 9, "bfloat16", "int8"),
        (BATCH, 4, 2, 300, 16, 299, "bfloat16", "bfloat16"),
        (1, 8, 4, 300, 96, 250, "float32", "float32"),
        (1, 8, 4, 300, 136, 250, "float32", "int8"),
        (1, 8, 2, 300, 200, 299, "bfloat16", "bfloat16"),
        # the gemma3-27b path's decode: its first and its last step
        (BATCH, *GEMMA_HEADS[:2], PROMPT_LEN, GEMMA_HEADS[2], PROMPT_LEN, "float32", "float32"),
        (BATCH, *GEMMA_HEADS[:2], PROMPT_LEN, GEMMA_HEADS[2], PROMPT_LEN + MAX_NEW - 2,
         "float32", "float32"),
    ]
    turn = 0
    for d in (64, 128, 192, 256):
        for kv in ("float32", "bfloat16", "int8"):
            for h, kvH in ((8, 8), (8, 4), (12, 4), (8, 1), (9, 1), (16, 1)):
                for Sc, pos in ((100, 99), (300, 250)):
                    turn += 1
                    cases.append((1, h, kvH, Sc, d, pos, ("float32", "bfloat16")[turn % 2], kv))
    seen_splits = set()
    for B, h, kvH, Sc, d, pos, qd, kv in cases:
        q, k, v, ks, vs = case(B, h, kvH, Sc, d, pos, qd, kv)
        splits = split_plan(B, kvH, min(Sc, pos + 1), n_sm)
        seen_splits.add(splits[0] > 1)
        got = decode_attention(q, k, v, pos, ks, vs)
        want = decode_attention_plain(q, k, v, pos, ks, vs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        bf16 = "bfloat16" in (qd, kv)
        tol = TOL["bfloat16" if bf16 else kv]
        rel = f", rel rms {rel_rms(got, want):.3e}" if bf16 else ""
        print(f"  decode_attention B={B} H={h} kvH={kvH} Sc={Sc} hd={d} pos={pos} q {qd}"
              f" kv {kv}: splits {splits[0]} x {splits[1]} tiles, max abs err {err:.3e}{rel}")
        check(err <= tol, f"decode_attention error {err} > {tol}")
        if (qd, kv) == ("float32", "float32"):
            worst = max(worst, err)
        if bf16:
            check(rel_rms(got, want) <= REL_RMS_BF16,
                  f"decode_attention bf16 rel rms {rel_rms(got, want)} > {REL_RMS_BF16}")
        if (B, h, Sc, pos, qd, kv) == (1, 64, 4096, 4095, "bfloat16", "bfloat16"):
            # the bf16 check against planted faults: the kernel run on a
            # prefix one split (or one 64-slot tile) short of the valid one
            for what, cut in (("split", splits[1] * TILE), ("tile", TILE)):
                fault = decode_attention(q, k, v, pos - cut, ks, vs)
                rr = rel_rms(fault, want)
                print(f"    planted fault (last {what} dropped): max abs err"
                      f" {(fault.float() - want.float()).abs().max().item():.3e},"
                      f" rel rms {rr:.3e}")
                check(rr > REL_RMS_BF16, f"the bf16 check would not catch a dropped {what}")
    check(seen_splits == {False, True}, "decode_attention: one split and several not both checked")

    shapes = []
    for what, B, h, kvH, Sc, d, pos, kv in (
        ("path shape", BATCH, H, H, PROMPT_LEN, hd, PROMPT_LEN + 3, "float32"),
        ("long", BATCH, H, H, 4096, hd, 4095, "float32"),
        ("long", 1, 64, 8, 4096, 128, 4095, "bfloat16"),
        ("gemma3-27b path shape", BATCH, *GEMMA_HEADS[:2], PROMPT_LEN, GEMMA_HEADS[2],
         PROMPT_LEN + 3, "float32"),
    ):
        q, k, v, _, _ = case(B, h, kvH, Sc, d, pos, kv, kv)
        n_valid = min(Sc, pos + 1)
        nbytes = 2 * q.nbytes + (k.nbytes + v.nbytes) * n_valid // Sc
        flops = 4 * d * n_valid * B * h
        splits = split_plan(B, kvH, n_valid, n_sm)
        q4 = q[:, :, None]
        label = (f"decode_attention {what} B={B} H={h} kvH={kvH} Sc={Sc} hd={d} pos={pos} {kv}"
                 f" (splits {splits[0]})")
        # every slot is valid at these shapes, so SDPA needs no mask
        shapes.append(timed_shape(
            label, lambda: decode_attention(q, k, v, pos),
            lambda: decode_attention_plain(q, k, v, pos),
            lambda: F.scaled_dot_product_attention(q4, k, v, enable_gqa=kvH != h),
            nbytes, flops, kv))
    return summary(worst, shapes)


def check_wide_head_dim(torch, dev):
    """K2 and K3 at long shapes with the head dim of the repo's gemma3-27b
    config, 168, which runs zero-padded to the kernels' 192: K2 at S 2048,
    global and with the local layers' window 1024, in f32 and bf16; K3 at
    Sc 4096 in f32, bf16 and int8.  Each is
    checked against its plain version and timed; the bounds count the
    function's own work at hd 168.  Returns (K2 rows, K3 rows, K2 worst f32
    error, K3 worst f32 error)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        decode_attention_plain,
        sm_count,
        split_plan,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.models.attention import quantize_kv

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    B, (H, kvH, hd) = 1, GEMMA_HEADS
    S, Sc, local = 2048, 4096, 1024
    flash_rows, decode_rows, worst, profiled = [], [], [0.0, 0.0], []
    pos_q = torch.arange(S, device=dev)[:, None]
    pos_k = torch.arange(S, device=dev)[None, :]
    for window in (None, local):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            q, k, v, _ = flash_case(torch, g, dev, B, H, kvH, S, hd, dtype)
            got = flash_attention(q, k, v, window=window)
            want = flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rel = rel_rms(got, want)
            label = (f"flash_attention long, gemma3-27b config heads B={B} H={H} kvH={kvH}"
                     f" S={S} hd={hd} window={window} {name}")
            print(f"  {label}: max abs err {err:.3e}, rel rms {rel:.3e}")
            check(err <= TOL[name], f"{label}: error {err} > {TOL[name]}")
            if dtype == torch.bfloat16:
                check(rel <= REL_RMS_BF16, f"{label}: rel rms {rel} > {REL_RMS_BF16}")
            else:
                worst[0] = max(worst[0], err)
            pairs = sum(min(i + 1, window or S) for i in range(S))  # (q, key) pairs computed
            mask = (pos_k <= pos_q) & (pos_q - pos_k < (window or S))
            library = (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True)) \
                if window is None else (lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True))
            profiled.append(lambda q=q, k=k, v=v, w=window: flash_attention(q, k, v, window=w))
            flash_rows.append(timed_shape(
                label, lambda: flash_attention(q, k, v, window=window),
                lambda: flash_attention_plain(q, k, v, window=window), library,
                2 * q.nbytes + 2 * k.nbytes, 4 * hd * pairs * B * H, name))
    for kv in ("float32", "bfloat16", "int8"):
        qd = torch.bfloat16 if kv == "bfloat16" else torch.float32
        q = torch.randn(B, H, hd, generator=g, device=dev).to(qd)
        k = torch.randn(B, kvH, Sc, hd, generator=g, device=dev)
        v = torch.randn(B, kvH, Sc, hd, generator=g, device=dev)
        ks = vs = None
        if kv == "int8":
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
        else:
            k, v = k.to(qd), v.to(qd)
        pos = Sc - 1
        got = decode_attention(q, k, v, pos, ks, vs)
        want = decode_attention_plain(q, k, v, pos, ks, vs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        splits = split_plan(B, kvH, Sc, sm_count(dev))
        label = (f"decode_attention long, gemma3-27b config heads B={B} H={H} kvH={kvH}"
                 f" Sc={Sc} hd={hd} pos={pos} {kv} (splits {splits[0]})")
        rel = rel_rms(got, want)
        print(f"  {label}: max abs err {err:.3e}, rel rms {rel:.3e}")
        check(err <= TOL[kv], f"{label}: error {err} > {TOL[kv]}")
        if kv == "bfloat16":
            check(rel <= REL_RMS_BF16, f"{label}: rel rms {rel} > {REL_RMS_BF16}")
        elif kv == "float32":
            worst[1] = max(worst[1], err)
        scales = 0 if ks is None else ks.nbytes + vs.nbytes
        q4 = q[:, :, None]
        # no PyTorch call attends over an int8 cache with per-slot scales
        library = None if kv == "int8" else (
            lambda: F.scaled_dot_product_attention(q4, k, v, enable_gqa=True))
        profiled.append(lambda q=q, k=k, v=v, ks=ks, vs=vs: decode_attention(q, k, v, pos, ks, vs))
        decode_rows.append(timed_shape(
            label, lambda: decode_attention(q, k, v, pos, ks, vs),
            lambda: decode_attention_plain(q, k, v, pos, ks, vs), library,
            2 * q.nbytes + k.nbytes + v.nbytes + scales, 4 * hd * Sc * B * H,
            "bfloat16" if kv == "bfloat16" else "float32"))
    for row, fn in zip(flash_rows + decode_rows, profiled):
        # the padded call's own kernels: the zero-pad copies beside K2 / K3
        row["kernels_us"] = kernel_device_us(torch, fn)
        print(f"  {row['shape']}: device us by kernel (profiler)")
        for k, v in sorted(row["kernels_us"].items(), key=lambda kv: -kv[1]["us"]):
            print(f"    {v['us']:8.2f} us, {v['launches']:.0f} launches a call  {k[:90]}")
    return flash_rows, decode_rows, worst[0], worst[1]


def ssd_inputs(torch, g, dev, B, S, H, G, P, N, dtype, strided=False):
    """The distributions of tests/test_kernels.py::test_ssd_scan: x, B, C
    ~ 0.5 N(0, 1), a = -0.3 softplus(N(0, 1)).  ``strided``: B and C as
    slices of one conv output and ``a`` a transposed (B, S, H) tensor, as
    ``mamba_full`` passes them."""
    import torch.nn.functional as F

    x = (torch.randn(B, S, H, P, generator=g, device=dev) * 0.5).to(dtype)
    if strided:
        a = (-F.softplus(torch.randn(B, S, H, generator=g, device=dev)) * 0.3).transpose(1, 2)
        conv = (torch.randn(B, S, H * P + 2 * G * N, generator=g, device=dev) * 0.5).to(dtype)
        Bm = conv[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = conv[..., H * P + G * N:].reshape(B, S, G, N)
        return x, a, Bm, Cm
    a = -F.softplus(torch.randn(B, H, S, generator=g, device=dev)) * 0.3
    Bm = (torch.randn(B, S, G, N, generator=g, device=dev) * 0.5).to(dtype)
    Cm = (torch.randn(B, S, G, N, generator=g, device=dev) * 0.5).to(dtype)
    return x, a, Bm, Cm


def ssd_bound(x, a, Bm, Cm):
    """x, y, a, B, C read or written once and the f32 state written; the
    recurrence's 4 B S H P N operations, the least the function needs."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    state_bytes = B * H * P * N * 4
    nbytes = 2 * x.nbytes + a.nbytes + Bm.nbytes + Cm.nbytes + state_bytes
    return bound(nbytes, 4 * B * S * H * P * N)


def kernel_device_us(torch, fn, calls: int = 10) -> dict:
    """Each device kernel's own microseconds and launches per call of
    ``fn``, from torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            out[e.key] = {"us": t / calls, "launches": e.count / calls}
    return out


def check_ssd_scan(torch, dev):
    from repro_torch.kernels.ssd_scan.ops import KERNEL_CHUNK, ssd_scan, ssd_scan_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    H, P, N, chunk = 48, 64, 128, 256  # mamba2-780m's heads and chunk
    worst = 0.0
    # (B, S, H, G, P, N, chunk, dtype, strided): the main path's prefill
    # (strided as mamba_full passes it, and contiguous); S 96 (a short last
    # kernel chunk) with G = 2; the head shape at S 512-4096 (one sequential
    # pass over 8-64 kernel chunks); N 256 (eight n slabs); odd P and N; the
    # shapes of tests/test_kernels.py (G = 2 among them)
    f32, bf16 = "float32", "bfloat16"
    cases = [(BATCH, PROMPT_LEN, H, 1, P, N, chunk, d, True) for d in (f32, bf16)]
    cases += [(BATCH, PROMPT_LEN, H, 1, P, N, chunk, f32, False)]
    cases += [(2, 96, 8, 2, P, 64, chunk, d, s) for d in (f32, bf16) for s in (False, True)]
    cases += [(1, S, H, 1, P, N, chunk, f32, False) for S in (512, 1024, 2048, 4096)]
    cases += [(1, 512, H, 1, P, N, chunk, bf16, False), (2, 1024, H, 1, P, N, chunk, f32, True)]
    cases += [(1, 1024, H, 1, P, 256, chunk, f32, False), (2, 96, 8, 2, P, 256, chunk, bf16, False)]
    # P and N that are not multiples of 4: 4-byte copies, one state value a
    # thread in the state pass
    cases += [(2, 96, 8, 2, 61, 63, chunk, d, s) for d, s in ((f32, True), (bf16, False))]
    # one chunk (the one-launch path): N 256 (its ring turns), a full 64-token
    # chunk with odd P and N, a 1-token prompt
    cases += [(BATCH, PROMPT_LEN, 8, 2, P, 256, chunk, bf16, False),
              (1, 64, 8, 1, 61, 63, 64, f32, True), (BATCH, 1, H, 1, P, N, chunk, f32, False)]
    cases += [(*shape, d, False) for shape in ((1, 256, 4, 1, 64, 32, 64), (2, 128, 8, 2, 32, 16, 32),
                                               (1, 512, 2, 1, 64, 64, 128))
              for d in (f32, bf16)]
    for B, S, h, G, p, n, c, name, strided in cases:
        x, a, Bm, Cm = ssd_inputs(torch, g, dev, B, S, h, G, p, n, getattr(torch, name), strided)
        y, st = ssd_scan(x, a, Bm, Cm, chunk=c)
        # the plain version on the same values in f32, y rounded to x's
        # type: the kernel widens bf16 inputs the same way, while the plain
        # version in bf16 rounds its einsums' intermediates to bf16 and
        # alone strays past 5e-2 at N 256
        wy, wst = ssd_scan_plain(x.float(), a, Bm.float(), Cm.float(), c)
        wy = wy.to(x.dtype)
        torch.cuda.synchronize()
        tol = SSD_TOL[name]
        errs = []
        label = (f"ssd_scan B={B} S={S} H={h} G={G} P={p} N={n} chunk={c} {name}"
                 f"{' strided' if strided else ''}")
        for got, want in ((y, wy), (st, wst)):
            d = (got.float() - want.float()).abs()
            errs.append(d.max().item())
            # allclose, as the tests hold it: |d| <= tol + tol * |want|
            excess = (d - tol * (1 + want.float().abs())).max().item()
            check(excess <= 0, f"{label}: error {errs[-1]} beyond rtol=atol={tol}")
        own = ""
        if name == bf16:
            by, _ = ssd_scan_plain(x, a, Bm, Cm, c)
            own = f" (the plain version in bf16: y {(by.float() - wy.float()).abs().max().item():.3e})"
        print(f"  {label} ({-(-S // KERNEL_CHUNK)} kernel chunks): max abs err y {errs[0]:.3e},"
              f" state {errs[1]:.3e}{own}")
        if name == f32:
            worst = max(worst, *errs)
    return summary(worst, time_ssd_scan(torch, dev))


def time_ssd_scan(torch, dev) -> list:
    """K4 through its wrapper at the path shape, S 1024 and S 4096 (f32,
    mamba2-780m's heads, contiguous inputs), and each of its kernels at S
    1024 under the profiler.  Uses whichever ``repro_torch`` comes first on
    ``sys.path``, so it also times a parent commit's kernel:
    ``python3 -c "import sys; sys.path[:0] = ['PARENT/src', '.']; import torch,
    chip_smoke; chip_smoke.time_ssd_scan(torch, torch.device('cuda'))"``."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    H, P, N, chunk = 48, 64, 128, 256
    shapes = []
    for label, (B, S) in (("path shape", (BATCH, PROMPT_LEN)), ("S=1024", (1, 1024)),
                          ("S=4096", (1, 4096))):
        x, a, Bm, Cm = ssd_inputs(torch, g, dev, B, S, H, 1, P, N, torch.float32)
        ms = time_ms(lambda: ssd_scan(x, a, Bm, Cm, chunk=chunk), iters=20)
        dev_us, method = device_us(lambda: ssd_scan(x, a, Bm, Cm, chunk=chunk))
        plain_ms = time_ms(lambda: ssd_scan_plain(x, a, Bm, Cm, chunk), iters=20)
        b_ms, b_by = ssd_bound(x, a, Bm, Cm)
        print(f"  ssd_scan {label} (B={B}, S={S}, H={H}, P={P}, N={N}, f32): kernel"
              f" {ms:.4f} ms, {dev_us:.2f} us device ({method}), plain {plain_ms:.4f} ms,"
              f" bound {b_ms:.6f} ms ({b_by})")
        row = {"shape": f"{label}: B={B} S={S} H={H} P={P} N={N} f32", "ms": ms,
               "device_us": dev_us, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None, "library_device_us": None,
               "device_time_by": method}
        if S == 1024:  # each of K4's kernels on its own
            row["kernels_us"] = kernel_device_us(torch, lambda: ssd_scan(x, a, Bm, Cm, chunk=chunk))
            for k, v in row["kernels_us"].items():
                print(f"    profiler: {v['us']:8.2f} us, {v['launches']:.0f} launches a call  {k[:90]}")
        shapes.append(row)
    return shapes


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


def py_rnn_fine_tune(params, cfg):
    """The bench zoo's ``py-rnn`` fine-tune (function index 4 of
    benchmarks/common.py: build_zoo): every stacked leaf from layer
    int(0.6 * reps) on scaled by 1.10, the unembedding by 1.05, the final
    norm + 0.05."""
    from repro_torch.interop import tree_map

    cut = int(cfg.pattern_reps * 0.6)

    def bump(a):
        if a.ndim >= 1 and a.shape[0] == cfg.pattern_reps:
            a = a.clone()
            a[cut:] *= 1.10
        return a

    embed = dict(params["embed"], unembed=params["embed"]["unembed"] * 1.05)
    return dict(params, embed=embed, final_norm=params["final_norm"] + 0.05,
                pattern=tuple(tree_map(bump, p) for p in params["pattern"]))


def profile_cold_start(torch, np, node, cfg, fname, prompt, want):
    """One more cold start of ``fname`` under torch.profiler: the device's
    busy share of the request and the kernels that take its device time."""
    from torch.profiler import ProfilerActivity, profile

    node.evict()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        r = node.invoke(fname, prompt, MAX_NEW, mode="spice", cfg=cfg)
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
    print(f"  profiled cold start {fname}: wall {wall_ms:.1f} ms (ttft {r.ttft_s * 1e3:.1f} ms,"
          f" restore {r.stats['total_s'] * 1e3:.1f} ms, upload {r.stats['upload_s'] * 1e3:.1f} ms),"
          f" device busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of the request")
    ranked = sorted(events, key=dev_us, reverse=True)
    # the ten largest, and the port's own kernels wherever they rank
    for rank, e in enumerate(ranked):
        if rank < 10 or "_kernel<" in e.key and "anonymous namespace" in e.key:
            print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:80]}")


def reset(counters) -> None:
    for c in counters.values():
        c.reset()


def counts(counters) -> dict:
    return {n: c.count for n, c in counters.items()}


def main_path(torch, np, dev, counters, arch, base_name, fns, per_request):
    """Publish a base function and a fine-tune (``fns``: name -> params
    maker) against a ``BaseImage`` of the seed weights, cold-start each
    ``COLD_REPEATS`` times and serve the last one warm.  ``per_request``
    names kernels with the launches every request must make.  Returns the
    path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import BaseImage, BufferPool
    from repro_torch.interop import tree_leaves
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServerlessNode, generate, layerwise_state

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=dev)
    made = {name: make(params, cfg) for name, make in fns.items()}
    image_bytes = sum(t.nbytes for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers ({cfg.pattern[0].kind}), d_model"
          f" {cfg.d_model}, vocab {cfg.vocab_size}; {sum(t.numel() for t in tree_leaves(params))}"
          f" params, image {image_bytes / 1e9:.3f} GB f32 (init {time.perf_counter() - t0:.1f} s)")
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)

    # CPU references first (plain versions), over the same layerwise state.
    # On some CPUs the first vectorized torch.exp of a fresh process was
    # seen off in the fourth significant digit; one warm-up call keeps the
    # reference exact.
    torch.exp(torch.full((1 << 15,), -0.3))
    t0 = time.perf_counter()
    host_base = layerwise_state(cfg, params)
    ref = {}
    for name, p in made.items():
        host = host_base if p is params else layerwise_state(cfg, p)
        ref[name] = generate(cfg, None, host, prompt, MAX_NEW, device="cpu")[0]
        del host
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
        node.node_cache.put(BaseImage.from_state(base_name, host_base), evictable=False)
        del host_base
        reset(counters)
        torch.cuda.reset_peak_memory_stats(dev)
        t_path = time.perf_counter()
        for fname, p in made.items():
            t0 = time.perf_counter()
            spec = node.publish(fname, cfg, p, d, base_name=base_name,
                                formats=("jif",), warm_ttl_s=600.0)
            st = node.catalog.publish_stats(fname)
            print(f"  publish {fname}: {time.perf_counter() - t0:.2f} s, jif "
                  f"{os.path.getsize(spec.jif_path)} B, private "
                  f"{st.private_bytes} B of {st.total_bytes} B")
        names = list(made)
        plan = [(f, "cold") for f in names for _ in range(COLD_REPEATS)]
        plan.append((names[-1], "warm"))
        for fname, kind in plan:
            if kind == "cold":
                node.evict()
            before = {k: counters[k].count for k in per_request}
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
            row["launches"] = {k: counters[k].count - before[k] for k in per_request}
            print("  request " + json.dumps(row))
            for k, n in per_request.items():
                check(row["launches"][k] == n,
                      f"{fname} {kind}: {row['launches'][k]} {k} launches, expected {n}")
        path_s = time.perf_counter() - t_path
        launches = counts(counters)
        print(f"  main path {path_s:.1f} s; launches {launches}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        hw = node.memory.high_water()
        print(f"  ledger high water {hw['total'] / image_bytes:.2f} images of a "
              f"{budget / image_bytes:.0f}-image budget: "
              + ", ".join(f"{k} {v / image_bytes:.2f}" for k, v in hw.items() if v))
        print(f"  device image cache {node.scheduler.device_images.snapshot_stats()}")
        print(f"  upload stream {node.scheduler.upload_stream.snapshot_stats()}")
        profile_cold_start(torch, np, node, cfg, names[-1], prompt, ref[names[-1]])
        node.memory.audit()
        check(node.scheduler.upload_stream.snapshot_stats()["failures"] == 0,
              "upload failures")
        return launches
    finally:
        node.close()
        shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------ serving policies
# prewarm: a function called every 10 minutes on a virtual clock (the
# arrival times given to the engine), past any keep-alive worth paying for
PREWARM_PERIOD_S = 600.0
PREWARM_LEAD_S = 10.0  # the engine ticks this long before the predicted arrival
PREWARM_ARRIVALS = 6
# what the schedule gives on either package's node: three demand cold
# starts while the histogram learns (2 gaps needed), then before each
# later arrival a speculative restore, and a warm hit at the arrival
PREWARM_MODES = ["cold", "cold", "cold", "prewarm", "warm", "prewarm", "warm", "prewarm",
                 "warm"]
# and what the policy evicts: nothing is kept after the first two arrivals
# (TTL 0 before two gaps are known); arrivals 2-4 are kept for the 60 s
# tail TTL (gaps of 600 s pass the 300 s cap) and reaped when it ends
PREWARM_REAPED = [(2, 60.0, 1), (3, 60.0, 1), (4, 60.0, 1)]


def prewarm_parts(ArrivalTracker, PrewarmPolicy, PrewarmEngine):
    """The keep-alive policy and engine of the prewarm schedule, from
    either package's classes: no TTL without history, a 60 s tail TTL for
    a function whose gaps pass 300 s, speculation 30 s ahead at most; the
    engine ticks only when called."""
    tracker = ArrivalTracker()
    policy = PrewarmPolicy(tracker, default_ttl_s=0.0, max_ttl_s=300.0, tail_ttl_s=60.0,
                           min_observations=2)
    engine = PrewarmEngine(tracker, horizon_s=30.0, interval_s=None, min_observations=2)
    return policy, engine


def prewarm_schedule(node, engine, fname, prompt, max_new, cfg):
    """Serve PREWARM_ARRIVALS arrivals of ``fname`` PREWARM_PERIOD_S apart
    on a virtual clock through ``node`` (a ``ServerlessNode`` of either
    package whose router carries ``engine`` and whose keep-alive is the
    ``PrewarmPolicy`` of ``prewarm_parts``).  Each arrival goes to the
    engine with its explicit time (``on_arrival(now=...)``) and is served
    by the node's scheduler, which the one-node router fronts, so that no
    wall-clock time enters the histogram.  The policy decides every
    eviction: while the histogram is short its TTL is 0 and a restored
    instance is not kept; later each instance gets the tail TTL, and the
    node's reaper runs at its last use plus that TTL (the 600 s gap outlives
    it), after a reap one second earlier has kept it.  Then the engine
    ticks PREWARM_LEAD_S before the next predicted arrival.  Returns
    ([(kind, InvokeResult)] in order, kind "cold" / "warm" for a demand
    request and "prewarm" for a speculation; [(arrival, TTL s, evictions)]
    of every arrival that ended warm)."""
    sched = node.scheduler
    spec = []
    sched.on_result = lambda r: spec.append(r) if r.mode == "prewarm" else None
    events, reaped = [], []
    try:
        for i in range(PREWARM_ARRIVALS):
            now = i * PREWARM_PERIOD_S
            engine.on_arrival(fname, now=now)
            r = sched.invoke(fname, prompt, max_new, mode="spice", cfg=cfg)
            events.append(("cold" if r.cold else "warm", r))
            if i == PREWARM_ARRIVALS - 1:
                break
            inst = sched.instance(fname)
            ttl = sched.keepalive.ttl_for(sched.registry.get(fname))
            if inst.state.name == "WARM":
                check(ttl > 0, f"prewarm: arrival {i} kept warm with TTL {ttl}")
                check(sched.reap_expired(now=inst.last_used + ttl - 1.0) == 0,
                      f"prewarm: arrival {i} reaped before its TTL of {ttl} s")
                n = sched.reap_expired(now=inst.last_used + ttl)
                check(n == 1 and inst.state.name == "EVICTED",
                      f"prewarm: arrival {i} not reaped at its TTL of {ttl} s")
                reaped.append((i, ttl, n))
            else:
                check(ttl == 0 and inst.state.name != "RESTORING",
                      f"prewarm: arrival {i} dropped ({inst.state.name}) with TTL {ttl}")
            n = engine.tick(now=now + PREWARM_PERIOD_S - PREWARM_LEAD_S)
            check(engine.drain(120.0), "prewarm: a speculation did not finish")
            deadline = time.monotonic() + 10.0
            while len(spec) < n and time.monotonic() < deadline:  # its on_result hook
                time.sleep(0.001)
            events.extend(("prewarm", spec.pop(0)) for _ in range(n))
    finally:
        sched.on_result = None
    return events, reaped


def prewarm_path(torch, np, dev, counters, cfg, v1, host, ref, prompt, budget, d):
    """A ``ServerlessNode`` with ``PrewarmPolicy`` and ``PrewarmEngine`` (as
    ``python -m repro_torch.launch.serve --prewarm`` builds it), fused
    install, ``fn-ft`` published against a base image: the prewarm
    schedule's modes, every demand request's tokens against the CPU path."""
    from repro_torch.core import BaseImage, BufferPool
    from repro_torch.serve.engine import (
        ArrivalTracker,
        PrewarmEngine,
        PrewarmPolicy,
        ServerlessNode,
    )

    policy, engine = prewarm_parts(ArrivalTracker, PrewarmPolicy, PrewarmEngine)
    node = ServerlessNode(device=dev, install="fused", pool=BufferPool(capacity_bytes=budget // 4),
                          memory_budget_bytes=budget, keepalive=policy, prewarm=engine)
    try:
        node.node_cache.put(BaseImage.from_state("qwen-base", host["base"]), evictable=False)
        node.publish("fn-ft", cfg, v1, d, base_name="qwen-base", formats=("jif",))
        reset(counters)
        events, reaped = prewarm_schedule(node, engine, "fn-ft", prompt, MAX_NEW, cfg)
        launches = counts(counters)
        for kind, r in events:
            print(f"  prewarm {kind:7s} ttft {r.ttft_s * 1e3:8.2f} ms,"
                  f" total {r.total_s * 1e3:8.2f} ms")
            if kind != "prewarm":
                check(np.array_equal(r.tokens, ref["v1"]), f"prewarm {kind}: tokens differ")
        st = node.scheduler.stats
        kinds = [k for k, _ in events]
        print(f"  prewarm modes {kinds}; node cold_starts {st['cold_starts']}, speculative_restores"
              f" {st['speculative_restores']}, prewarm_redundant {st['prewarm_redundant']};"
              f" engine {dict((k, v) for k, v in engine.stats.items() if v)}; launches {launches}")
        print(f"  the policy's evictions (arrival, TTL s, reaped): {reaped}; node ttl_evictions"
              f" {st['ttl_evictions']}")
        check(kinds == PREWARM_MODES, f"prewarm modes {kinds} != {PREWARM_MODES}")
        check((st["cold_starts"], st["speculative_restores"], st["prewarm_redundant"]) == (3, 3, 0),
              "prewarm: node counts")
        check(reaped == PREWARM_REAPED and st["ttl_evictions"] == len(PREWARM_REAPED),
              f"prewarm: the policy's evictions {reaped} != {PREWARM_REAPED}")
        node.memory.audit()
        return launches
    finally:
        node.close()


@contextlib.contextmanager
def call_times(targets: dict):
    """{label: [calls, seconds]} spent in each ``(class, method name)`` of
    ``targets`` while the block runs, on any thread (restores run on the
    node's workers).  A classmethod stays one."""
    import threading

    spent = {label: [0, 0.0] for label in targets}
    lock = threading.Lock()
    saved = []
    for label, (cls, name) in targets.items():
        raw = cls.__dict__[name]
        fn = raw.__func__ if isinstance(raw, classmethod) else raw

        def timed(*args, _fn=fn, _label=label, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                with lock:
                    spent[_label][0] += 1
                    spent[_label][1] += time.perf_counter() - t0

        setattr(cls, name, classmethod(timed) if isinstance(raw, classmethod) else timed)
        saved.append((cls, name, raw))
    try:
        yield spent
    finally:
        for cls, name, raw in saved:
            setattr(cls, name, raw)


def profiled_handoff(torch, router, fname, src, dst, d, cfg):
    """``handoff_warm`` of ``fname`` from ``src`` to ``dst``, its restore's
    time split: on the host, the bootstrap of a base image from the
    handoff image's parent JIF (``BaseImage.from_jif``: its own restore of
    the parent, then ``from_state``'s host copy and page digests) and the
    device copies of that base's pages (``DeviceImageCache.get_pages``);
    on the device, from torch.profiler, the copies each way, K1 and the
    rest, over the whole handoff (the source's ``warm_state`` copies its
    tree to the host first).  Returns the ``HandoffStats``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cache import BaseImage
    from repro_torch.core.lifecycle import parent_cache_key
    from repro_torch.core.upload import DeviceImageCache
    from repro_torch.serve.handoff import handoff_warm

    targets = {"bootstrap": (BaseImage, "from_jif"),
               "host copy + digests": (BaseImage, "from_state"),
               "device base pages": (DeviceImageCache, "get_pages")}
    torch.cuda.synchronize()
    with call_times(targets) as spent, profile(activities=[ProfilerActivity.CUDA]) as prof:
        hs = handoff_warm(router, fname, src, dst, handoff_dir=d, cfg=cfg)
        torch.cuda.synchronize()
    boot, digest, pages = (spent[k] for k in targets)
    dev_ms = {"device-to-host copies": 0.0, "host-to-device copies": 0.0, "overlay_patch": 0.0,
              "other": 0.0}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
        key = ("device-to-host copies" if "DtoH" in e.key else
               "host-to-device copies" if "HtoD" in e.key else
               "overlay_patch" if "overlay_patch" in e.key else "other")
        dev_ms[key] += t
    base = router.node(dst).node_cache.get(
        parent_cache_key(router.catalog.registry.get(fname).jif_path))
    print(f"  handoff {src} -> {dst} restore_s {hs.restore_s:.3f}: base bootstrap from the"
          f" function's JIF {boot[1]:.3f} s in {boot[0]} call(s) ({base.nbytes if base else 0} B;"
          f" of it host copy + page digests {digest[1]:.3f} s), device base pages"
          f" {pages[1]:.3f} s over {pages[0]} tensors, the rest"
          f" {hs.restore_s - boot[1] - pages[1]:.3f} s; device ms over the whole handoff (the"
          f" source's copy to the host included)"
          f" {dict((k, round(v, 3)) for k, v in dev_ms.items())}")
    return hs


def handoff_path(torch, np, dev, counters, cfg, v1, ref, prompt, budget, d):
    """``fn-ft`` warm on one ``NodeScheduler`` of a two-node ``ClusterRouter``
    on the one card (fused install, 3600 s TTL) is handed to the other
    (``handoff_warm``), then ``AutoScaler.drain_node`` drains the node that
    holds it, which must hand it back.  Serving writes nothing into a warm
    tree, so the phase dirties the first page of the source's embedding
    (as a function that keeps state in its memory would): that page is the
    whole delta, the destination reads exactly it, and the state it ends
    with must equal the source's.  The page is put back after the drain.
    Returns (launches, router, catalog): the deploy path goes on with the
    node that is left."""
    from repro_torch.core import BufferPool
    from repro_torch.core.overlay import DEFAULT_PAGE
    from repro_torch.interop import tree_leaves
    from repro_torch.serve.autoscale import AutoScaler
    from repro_torch.serve.engine import (
        ClusterRouter,
        FixedTTLPolicy,
        FunctionCatalog,
        NodeScheduler,
    )
    from repro_torch.serve.handoff import wait_idle_warm

    catalog = FunctionCatalog(device=dev)
    nodes = [NodeScheduler(registry=catalog.registry, keepalive=FixedTTLPolicy(3600.0),
                           install="fused", pool=BufferPool(capacity_bytes=budget // 4),
                           memory_budget_bytes=budget, device=dev) for _ in range(2)]
    router = ClusterRouter(catalog, nodes)
    catalog.publish("fn-ft", cfg, v1, d, warm_ttl_s=3600.0, formats=("jif",))
    held = {n.name: n.memory.held_bytes() for n in nodes}
    reset(counters)
    r = router.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(r.cold and np.array_equal(r.tokens, ref["v1"]), "handoff: the first request")
    a = r.node
    b = next(n.name for n in router.nodes if n.name != a)
    check(wait_idle_warm(router.node(a), "fn-ft"), "handoff: the source never went warm")
    tok = router.node(a).instance("fn-ft").tree["embed"]["tok"]
    check(tok.nbytes >= DEFAULT_PAGE, "handoff: the embedding is smaller than a page")
    clean = tok.view(-1)[:16].clone()
    tok.view(-1)[:16] += 0.5  # 64 bytes of the first 64 KiB page
    dirty = router.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(not dirty.cold and dirty.node == a, "handoff: the dirty request was not warm on A")
    want = [t.clone() for t in tree_leaves(router.node(a).instance("fn-ft").tree)]
    k1 = counters["overlay_patch"].count
    hs = profiled_handoff(torch, router, "fn-ft", a, b, d, cfg)
    k1 = counters["overlay_patch"].count - k1
    print(f"  handoff {a} -> {b}: ok {hs.ok} {hs.reason}; delta_bytes {hs.delta_bytes},"
          f" total_bytes {hs.total_bytes}, restore_read_bytes {hs.restore_read_bytes},"
          f" snapshot_s {hs.snapshot_s:.3f}, restore_s {hs.restore_s:.3f}, wait_s {hs.wait_s:.3f};"
          f" overlay_patch launches in the restore {k1}")
    check(hs.ok, f"handoff failed: {hs.reason}")
    check(hs.delta_bytes == hs.restore_read_bytes == DEFAULT_PAGE,
          f"handoff: one dirty page, but delta {hs.delta_bytes} B and read"
          f" {hs.restore_read_bytes} B")
    check(hs.delta_bytes < hs.total_bytes, "handoff: the delta is not smaller than the state")
    check(k1 > 0, "handoff: the destination's restore launched no overlay_patch")
    got = tree_leaves(router.node(b).instance("fn-ft").tree)
    check(len(got) == len(want) and all(torch.equal(x, y) for x, y in zip(got, want)),
          "handoff: the destination's state is not the source's")
    r2 = router.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(not r2.cold and r2.node == b and np.array_equal(r2.tokens, dirty.tokens),
          "handoff: the next request is not warm on the destination with the source's tokens")
    src = router.node(a)
    src.drain_residual()
    src.memory.reclaim(1 << 40)
    check(src.memory.held_bytes() == held[a],
          f"handoff: {a} holds {src.memory.held_bytes()} B, {held[a]} B before the restore")
    src.memory.audit()
    print(f"  {a} ledger back to {held[a]} B; {b}'s state and tokens equal {a}'s")
    scaler = AutoScaler(router, [], handoff_dir=d, min_nodes=1)
    scaler.drain_node(b)
    hd = scaler.handoffs[-1]
    print(f"  drain {b}: {dict((k, v) for k, v in scaler.stats.items() if v)}; handoff"
          f" {hd.src} -> {hd.dst} delta_bytes {hd.delta_bytes}, restore_read_bytes"
          f" {hd.restore_read_bytes}, restore_s {hd.restore_s:.3f}")
    check(scaler.stats["handoffs_ok"] == 1 and scaler.stats["drain_evictions"] == 0,
          "drain: not a handoff")
    check(hd.delta_bytes == hd.restore_read_bytes == DEFAULT_PAGE, "drain: the delta")
    r3 = router.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(not r3.cold and r3.node == a and np.array_equal(r3.tokens, dirty.tokens),
          "drain: the next request is not warm on the node that is left")
    router.node(a).instance("fn-ft").tree["embed"]["tok"].view(-1)[:16] = clean
    r4 = router.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(np.array_equal(r4.tokens, ref["v1"]), "handoff: the page put back, tokens differ")
    router.audit()
    return counts(counters), router, catalog


def canary_split(np, seed, version, name, fraction, n):
    """The versions ``RolloutController.resolve`` picks for ``n`` requests,
    from its definition: a numpy generator seeded with (seed, version,
    crc32(name)), canary where a draw is below ``fraction``."""
    import zlib

    rng = np.random.default_rng([seed, version, zlib.crc32(name.encode())])
    return [float(rng.random()) < fraction for _ in range(n)]


def deploy_path(torch, np, dev, counters, cfg, v2, ref, prompt, router, catalog, d):
    """``RolloutController`` on the router the drain left: publish v2 of
    ``fn-ft`` (``fine_tune`` once more), a 0.5 canary over 8 requests, the
    token health gate (which promotes), then a rollback."""
    from repro_torch.serve.engine import RolloutController, TokenHealthGate

    deploy = RolloutController(catalog, seed=SEED, dirpath=d).attach(router)
    deploy.track("fn-ft")
    reset(counters)
    rec = deploy.publish_version("fn-ft", cfg, v2)
    print(f"  deploy: {rec.name} private {rec.private_bytes} B of {rec.total_bytes} B")
    check(0 < rec.private_bytes < rec.total_bytes, "deploy: v2 is not a delta")
    deploy.begin_canary("fn-ft", rec.version, fraction=0.5)
    served = []
    for _ in range(8):
        r = router.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
        canary = r.function == rec.name
        served.append(canary)
        check(np.array_equal(r.tokens, ref["v2" if canary else "v1"]),
              f"deploy: {r.function} tokens differ")
    want = canary_split(np, SEED, rec.version, "fn-ft", 0.5, 8)
    print(f"  deploy canary: v2 took requests {[i for i, c in enumerate(served) if c]} of 8"
          f" (the split's own definition: {[i for i, c in enumerate(want) if c]})")
    check(served == want and any(served) and not all(served), "deploy: canary split")
    ok = deploy.evaluate_canary("fn-ft", prompt, gate=TokenHealthGate(vocab_size=cfg.vocab_size),
                                n_probes=2, max_new_tokens=MAX_NEW, cfg=cfg)
    check(ok and deploy.current("fn-ft").version == rec.version, "deploy: the gate did not promote")
    r = router.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(r.function == rec.name and np.array_equal(r.tokens, ref["v2"]), "deploy: after promote")
    back = deploy.rollback("fn-ft")
    r = router.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(back.version == 1 and r.function == "fn-ft" and not r.cold
          and np.array_equal(r.tokens, ref["v1"]), "deploy: after rollback")
    launches = counts(counters)
    print(f"  deploy: promoted v{rec.version}, rolled back to v{back.version} (warm);"
          f" stats {dict((k, v) for k, v in deploy.stats.items() if v)}; launches {launches}")
    check(launches["overlay_patch"] > 0, "deploy: v2's restore launched no overlay_patch")
    router.audit()
    return launches


def policy_paths(torch, np, dev, counters, cfg):
    """The serving policies on ``cfg`` (qwen1.5-0.5b at full width on the
    card), f32, weights from the seed: prewarm, handoff and drain, deploy.
    ``fn-ft`` (v1) is ``fine_tune`` of the seed weights, v2 ``fine_tune`` of
    v1.  Returns {path: launch counts}."""
    from repro_torch.interop import tree_leaves
    from repro_torch.models import lm
    from repro_torch.serve.engine import generate, layerwise_state

    params = lm.init_params(cfg, seed=SEED, device=dev)
    v1 = fine_tune(params, cfg)
    v2 = fine_tune(v1, cfg)
    image_bytes = sum(t.nbytes for t in tree_leaves(params))
    # a node's ledger holds a host base, its device copy, two warm versions
    # and the publish scratch at once
    budget = 6 * image_bytes
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    torch.exp(torch.full((1 << 15,), -0.3))  # see main_path
    host = {"base": layerwise_state(cfg, params)}
    ref = {k: generate(cfg, None, layerwise_state(cfg, p), prompt, MAX_NEW, device="cpu")[0]
           for k, p in (("v1", v1), ("v2", v2))}
    d = tempfile.mkdtemp(prefix="chip-smoke-policies-")
    paths = {}
    router = None
    try:
        print("== prewarm (qwen1.5-0.5b fn-ft): PrewarmPolicy + PrewarmEngine")
        paths["prewarm"] = prewarm_path(torch, np, dev, counters, cfg, v1, host, ref, prompt,
                                        budget, d)
        print("== handoff and drain (qwen1.5-0.5b fn-ft): two nodes on the card")
        paths["handoff"], router, catalog = handoff_path(torch, np, dev, counters, cfg, v1, ref,
                                                         prompt, budget, d)
        print("== deploy (qwen1.5-0.5b fn-ft): v2, canary, gate, promote, rollback")
        paths["deploy"] = deploy_path(torch, np, dev, counters, cfg, v2, ref, prompt, router,
                                      catalog, d)
        return paths
    finally:
        if router is not None:
            router.close()
        shutil.rmtree(d, ignore_errors=True)


@contextlib.contextmanager
def recorded_logits(into: list):
    """Record the last-position logits (on the host) of every head that
    ``generate`` computes while the block runs, by wrapping the unembedding
    its module calls."""
    from repro_torch.serve import instance

    real = instance.unembed

    def unembed(cfg, p, x, compute_dtype):
        logits = real(cfg, p, x, compute_dtype)
        into.append(logits[:, -1].float().cpu())
        return logits

    instance.unembed = unembed
    try:
        yield into
    finally:
        instance.unembed = real


LOGITS_REL_TOL = 1e-4  # max |card - CPU| over max |CPU| of the f32 logits


def gemma_path(torch, np, dev, counters):
    """gemma3-27b as the repo configures it (no head_dim, so hd = 5376 / 32
    = 168, which K2 and K3 run zero-padded to 192) at full width, its depth
    cut to one local layer (window 1024) and one global layer; random
    weights from the seed.  Greedy tokens from the card must equal the CPU
    path's on the same weights, and so must the logits of every step, to
    LOGITS_REL_TOL of their largest magnitude (random tied weights can
    repeat one token at every step, which the tokens alone would not
    notice).  Returns the path's launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.models import lm
    from repro_torch.serve.engine import generate, layerwise_state

    full = get_config(GEMMA_ARCH)
    local, glob = full.pattern[0], full.pattern[-1]
    cfg = dataclasses.replace(full, n_layers=2, pattern=(local, glob), pattern_reps=1,
                              remainder=())
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cpu")
    n_params = sum(t.numel() for t in tree_leaves(params))
    state = layerwise_state(cfg, params)
    del params
    print(f"  {cfg.name} cut to 2 of {full.n_layers} layers: pattern=(LOCAL window"
          f" {local.window}, GLOBAL), pattern_reps=1, remainder=(); d_model {cfg.d_model},"
          f" heads {cfg.n_heads} / {cfg.n_kv_heads}, hd {cfg.hd} (no head_dim in the config),"
          f" d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} params,"
          f" {n_params * 4 / 1e9:.3f} GB f32 (init {time.perf_counter() - t0:.1f} s)")
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    torch.exp(torch.full((1 << 15,), -0.3))  # see main_path
    t0 = time.perf_counter()
    with recorded_logits([]) as want_logits:
        want, _ = generate(cfg, None, state, prompt, MAX_NEW, device="cpu")
    print(f"  CPU reference tokens in {time.perf_counter() - t0:.1f} s")
    reset(counters)
    t0 = time.perf_counter()
    with recorded_logits([]) as got_logits:
        got, ttft = generate(cfg, None, state, prompt, MAX_NEW, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(counters)
    print(f"  generate on the card: {wall * 1e3:.1f} ms (ttft {ttft * 1e3:.1f} ms, the"
          f" state's host-to-device copy and the logits' copies to the host included);"
          f" tokens {got.tolist()}; last prompt tokens {prompt[:, -1].tolist()};"
          f" launches {launches}")
    check(np.array_equal(got, want), f"{cfg.name}: tokens {got.tolist()} != CPU path "
                                     f"{want.tolist()}")
    check(len(got_logits) == len(want_logits) == MAX_NEW, f"{cfg.name}: logits not recorded")
    errs = [(g - w).abs().max().item() / w.abs().max().item()
            for g, w in zip(got_logits, want_logits)]
    print(f"  logits against the CPU path, max |err| / max |logit| by step:"
          f" {', '.join(f'{e:.2e}' for e in errs)} (bound {LOGITS_REL_TOL:.0e})")
    check(max(errs) <= LOGITS_REL_TOL, f"{cfg.name}: logits differ from the CPU path")
    check(launches["flash_attention"] == cfg.n_layers
          and launches["decode_attention"] == cfg.n_layers * (MAX_NEW - 1),
          f"{cfg.name}: launches {launches}")
    return launches


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

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import launch_counters, native

    dev = resolve_device("cuda")
    print("== build")
    t0 = time.perf_counter()
    native.library()
    info = native.build_info()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s -> {info['path']}")
    # a spill fails the run at its end, after every phase has printed
    spilled = ptxas_report(str(info["log"]))

    print("== kernels against their plain versions")
    rng = np.random.default_rng(SEED)
    measured = {
        "overlay_patch": check_overlay_patch(torch, rng, dev),
        "flash_attention": check_flash_attention(torch, dev),
        "decode_attention": check_decode_attention(torch, dev),
        "ssd_scan": check_ssd_scan(torch, dev),
    }
    print("== K2 and K3 at head dim 168 (the repo's gemma3-27b config), long shapes")
    wide_flash, wide_decode, flash_err, decode_err = check_wide_head_dim(torch, dev)
    for name, rows, err in (("flash_attention", wide_flash, flash_err),
                            ("decode_attention", wide_decode, decode_err)):
        measured[name]["shapes"] += rows
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)

    # every request prefills once (one attention or SSD-scan launch per
    # layer) and decodes MAX_NEW - 1 tokens (the scan never runs there)
    qwen, ssm = get_config(ARCH), get_config(SSM_ARCH)
    counters = launch_counters()
    paths = {}
    for arch, base_name, fns, per_request in (
        (ARCH, "qwen-base", {"fn-base": lambda p, c: p, "fn-ft": fine_tune},
         {"flash_attention": qwen.n_layers, "decode_attention": qwen.n_layers * (MAX_NEW - 1)}),
        (SSM_ARCH, "rnn-base", {"fn-rnn-base": lambda p, c: p, "fn-rnn": py_rnn_fine_tune},
         {"ssd_scan": ssm.n_layers}),
    ):
        print(f"== main path {arch}: publish, Spice restore, fused install, generate")
        paths[arch] = main_path(torch, np, dev, counters, arch, base_name, fns, per_request)
        for name in ("overlay_patch", *per_request):
            check(paths[arch][name] > 0, f"kernel {name} was not launched on the {arch} path")
    print(f"== {GEMMA_ARCH} generate at full width, depth cut")
    paths[GEMMA_ARCH] = gemma_path(torch, np, dev, counters)
    paths.update(policy_paths(torch, np, dev, counters, qwen))
    for name in ("prewarm", "handoff", "deploy"):
        check(paths[name]["overlay_patch"] > 0, f"kernel overlay_patch was not launched on {name}")
    launches = {name: sum(p[name] for p in paths.values()) for name in counters}
    print(f"  launches per path: {json.dumps(paths)}")

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
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:71"),
    }
    check(not spilled, f"stack frame or spills in K2-K4 kernels: {spilled}")
    kernels = []
    for name, (source, replaces) in meta.items():
        m = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "device_us": m["device_us"], "library_device_us": m["library_device_us"],
            "shapes": m["shapes"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
