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
   compiled 192): at that path's own shapes and at long ones.  Every
   later path's attention and SSD shapes are checked too, and K2, K3 at
   qwen2-vl-7b's (G 7, S 288), qwen3-32b's (G 8) and starcoder2-7b's (G
   9) and K4 at jamba-v0.1-52b's (N 16) timed; K2 and K3 also at
   starcoder2-7b's heads at long shapes (S 2048; Sc 4096 over f32, bf16
   and int8 caches, K3's 16-head instance with 7 idle heads).
   K2 and K3 past head dim 256 run their generic instances: checked and
   timed at hd 257, 320 and 512.
   The grouped expert MLP kernel (K5) is checked and timed at
   granite-4.0-h-small's widths (d 4096, experts of 768, 9 held of 72,
   top 10), at the benchmark cell's prefill (2 x 1,024 tokens) and at a
   decode step (2 tokens).
4. Runs the two main paths at full width, f32, random weights from seed 0:
   qwen1.5-0.5b (attention) and mamba2-780m (SSD).  For each, a
   ``BaseImage`` of the weights goes into the node's cache; a base function
   is published against it, and a fine-tune too; each is cold-started
   (Spice restore, fused install through the overlay-patch kernel,
   layer-gated generation through the attention kernels or the SSD-scan
   kernel) a few times, then served warm once.  Every request's tokens
   must equal the port's generation on the CPU over the same weights, which
   runs the plain versions.  On the qwen path's node the fine-tune is then
   republished in every format (the JIF, CRIU*'s file per tensor, the
   monolith) and cold-started three times under each restore mode
   (``spice``, ``spice_sync``, ``criu_star``, ``reap_star``,
   ``faasnap_star``; reads through the page cache): the CPU's tokens, K2
   and K3 as under ``spice``, K1 under the Spice modes only; one cold
   start of each baseline profiled, each mode's median TTFT and total and
   its ratio to ``spice`` printed.  On the same node the invocation plane
   then runs under contention (``concurrent_path``): three more
   fine-tunes of the base, each a different page of every ``wo``,
   published in the JIF and the monolith; the four cold-started at once
   through ``node.submit``, three spice rounds on a 7-image budget (the
   first builds the device base) and one ``faasnap_star`` round; six
   invocations of one cold function riding one restore; a cancel after
   the first upload has landed, with deadlines and a warm request beside
   it; the four at once twice on the 4-image budget.  Every result holds
   the CPU's tokens, the ledger audits clean and the card's memory
   returns to its level after every eviction.  Then qwen1.5-0.5b runs
   again with its seed weights cast to bf16, at full width and depth, with ``import
   ml_dtypes`` made to fail for the phase (it ships with JAX, which the
   port does without): a base and a fine-tune published, each cold-started
   three times through the fused install (the overlay-patch kernel on bf16
   pages), the fine-tune served warm, the CPU's tokens every time, and a
   ``CheckpointManager`` save of the bf16 state restored bit for bit.
   Next, each ``examples/torch_*.py`` runs
   its ``main()`` in this process on the card, its output holding the
   reference example's narrative.  Then gemma3-27b generates at full width with
   its depth cut to one local and one global layer (tokens and every
   step's logits against the CPU path); olmoe-1b-7b (64 experts, top-8)
   cold-starts at full width with its depth cut to 2 of 16 layers, the
   prefill's routing and dropped pairs on the card equal to the CPU path's
   and the MoE FFN's device time taken from the cold start's profile;
   qwen2-vl-7b (2 of 28 layers: patch embeddings over a 16 x 16 grid and
   M-RoPE positions) and musicgen-large (2 of 48 layers: frame embeddings
   in place of tokens) through the stacked ``lm.prefill`` and
   ``lm.decode_step``, and jamba-v0.1-52b (block positions 3 and 4: Mamba2
   with the MoE FFN, then attention) through ``generate``, each against
   the CPU path (tokens, every step's logits, jamba's prefill routing) and
   profiled once more.  The last three configurations follow, at full
   width with their depth cut to 2 layers: starcoder2-7b (G 9, untied
   head) cold-starts through the main path's publish, Spice restore and
   fused install; qwen3-32b (qk-norm with its norm weights drawn off 1, G
   8, H * hd 8192 on d_model 5120) and phi3.5-moe-42b (16 experts, top-2;
   the prefill's routing against the CPU's) generate against the CPU path,
   and granite-4.0-h-small as the benchmark runs it (layers 4 and 5 of
   10: Mamba-2 and NoPE attention, each with the dropless MoE through K5
   and the shared expert) generates against the CPU path, which runs K5's
   plain version.
   The generate and stacked phases draw their weights on the card from
   the seed.  Then the serving policies run on
   qwen1.5-0.5b's fine-tune: a ``ServerlessNode`` with a ``PrewarmPolicy``
   and a ``PrewarmEngine`` over six arrivals on a virtual clock, the
   policy's TTLs deciding every eviction; a warm handoff of a tree with one
   dirty page between two nodes on the card (its restore's time split on
   the host and the device) and an ``AutoScaler`` drain that hands it
   back; a ``RolloutController`` canary of a v2, its gate, promote and
   rollback.  Last, training on qwen1.5-0.5b at full width, its depth
   cut to 8 of 24 layers (``examples/train_ft.py``'s flow): one f32 step against the CPU path
   (depth cut to 2 layers), 6 bf16 steps straight and again with a crash
   at step 4 and a resume from the JIF checkpoint (final params equal),
   steps at a fine-tune's size (8 x 2048 tokens) timed and profiled, the
   stacked ``lm.prefill`` / ``lm.decode_step`` against the CPU, then the
   trained params published and a fine-tune whose every checkpoint becomes
   a canary version, served (each request's tree holding its own
   version's weights), gated, rolled back.  Then the sharded serve
   steps on a one-rank NCCL group and the 1 x 1 host mesh: qwen1.5-0.5b's
   ``build_cell`` prefill and decode steps at full width and depth, at
   2 x 16 tokens in f32 against the CPU path (f32 and int8 caches), then
   the prefill_32k / decode_32k cells cut to 8 x 4096 in bf16, at the
   bf16 cache ``kv_policy`` picks and at an int8 cache (K3's int8
   instance), timed and profiled; the cost harness (``launch/dryrun.py``)
   counting one more step of each on the card and on meta, held equal, and
   each step's share of its roofline; its CLI over qwen's production cells
   in a process of its own; and the train phase's restored params
   resharded onto ``plan_mesh(1, 16)``'s mesh, bit for bit.  The launch
   counts are set to 0 just before each path and read just after it.
5. Prints one JSON line with every kernel's launches on the main paths, its
   error against the plain version and its times, then the result line.

Exits non-zero on any failure, without a CUDA device, and when the port's
sources are not beside it.
"""
import contextlib
import functools
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
MOE_ARCH = "olmoe-1b-7b"
MOE_RANGE = "moe_ffn"  # the profiler range around each MoE FFN call of the olmoe phase
SEED = 0
BATCH, PROMPT_LEN, MAX_NEW = 2, 16, 8
# the repo's gemma3-27b config: H, kvH and hd.  The config sets no
# head_dim, so hd is d_model / n_heads = 5376 / 32 = 168, as the JAX package
# computes it (the config's source is marked unverified)
GEMMA_HEADS = (32, 16, 168)
# the repo's olmoe-1b-7b config: H, kvH and hd (2048 / 16)
MOE_HEADS = (16, 16, 128)
VL_ARCH = "qwen2-vl-7b"
AUDIO_ARCH = "musicgen-large"
HYBRID_ARCH = "jamba-v0.1-52b"
# H, kvH and hd of qwen2-vl-7b (3584 / 28), musicgen-large (2048 / 32) and
# jamba-v0.1-52b (4096 / 32); jamba's SSM heads, head dim and state
VL_HEADS = (28, 4, 128)
AUDIO_HEADS = (32, 32, 64)
HYBRID_HEADS = (32, 8, 128)
HYBRID_SSM = (128, 64, 16)
# the last three configurations: qwen3-32b (qk-norm, G 8, H * hd 8192 !=
# d_model 5120), starcoder2-7b (G 9: K3's 16-head instance with 7 idle
# heads) and phi3.5-moe-42b (16 experts, top-2; its heads are jamba's)
QWEN3_ARCH = "qwen3-32b"
CODER_ARCH = "starcoder2-7b"
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
QWEN3_HEADS = (64, 8, 128)
CODER_HEADS = (36, 4, 128)
QK_NORM_SPREAD = 0.1  # qwen3's q_norm / k_norm drawn as 1 + N(0, this), off their init of 1
VL_TEXT = 32  # text tokens after qwen2-vl's 256 patch positions (a 16 x 16 grid)
VL_SEQ = 256 + VL_TEXT
COLD_REPEATS = 3
BUDGET_IMAGES = 4  # main_path's node: host and device bytes on one ledger of this many images
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "int8": 2e-4}
REL_RMS_BF16 = 1e-2  # bf16 is also held to rel_rms(got, want) <= this
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # tests/test_kernels.py::test_ssd_scan
# granite-4.0-h-small as the benchmark runs it (coldbench/configs/<this>.json):
# d_model, expert width, experts held, the router's width and top-k that K5
# is checked and timed at, and the cell's prompts (2 x 1,024 tokens)
GRANITE_CONFIG = "granite-4.0-h-small"
GRANITE_MOE = (4096, 768, 9, 72, 10)
GRANITE_PREFILL = 2 * 1024
MOE_EXPERTS_TOL = 1e-5  # K5 against its plain path: |d| <= tol + tol * |want|


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


def bound(work, dtype: str = "float32"):
    """(least time in ms, what bounds it) on an H100 SXM for ``work``, a
    kernel's ``cost(...)`` (flops, bytes; ``kernels/*/ops.py``), from the
    port's data-sheet constants (``repro_torch.launch.hw``): bytes over the
    memory rate; operations over the tensor cores' rate in bf16, the CUDA
    cores' in f32."""
    from repro_torch.launch import hw

    flops, nbytes = work
    return hw.bound_ms(nbytes, flops, dtype)


def timed_shape(label, kernel, plain, library, work, dtype):
    """Every number of one timed shape: through the wrapper (CUDA events),
    on the host and on the device (CUDA graph), for the kernel and for the
    library call (None where no PyTorch call computes the function) in
    turns; the plain version's ms; the bound of ``work``, the kernel's
    ``cost(...)``."""
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
    row["bound_ms"], row["bound_by"] = bound(work, dtype)
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
    from repro_torch.kernels.overlay_patch.ops import cost, overlay_patch, overlay_patch_plain

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
    work = cost(base, priv, kinds, src)
    b_ms, b_by = bound(work)
    for c in cases:
        print(f"  overlay_patch {c}")
    print(f"  overlay_patch embed-size: kernel {ms:.4f} ms, {dev_us:.2f} us device ({method}),"
          f" plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({work[1] / ms / 1e6:.1f} GB/s)")
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

    from repro_torch.kernels.flash_attention.ops import (
        cost,
        flash_attention,
        flash_attention_plain,
    )

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
        # the olmoe-1b-7b path's prefill, as attn_full calls it
        (BATCH, *MOE_HEADS[:2], PROMPT_LEN, MOE_HEADS[2], None, True, f32, True),
        # the prefills of the qwen2-vl-7b (G 7), musicgen-large and
        # jamba-v0.1-52b paths, as attn_full calls them
        (BATCH, *VL_HEADS[:2], VL_SEQ, VL_HEADS[2], None, True, f32, True),
        (BATCH, *AUDIO_HEADS[:2], PROMPT_LEN, AUDIO_HEADS[2], None, True, f32, True),
        (BATCH, *HYBRID_HEADS[:2], PROMPT_LEN, HYBRID_HEADS[2], None, True, f32, True),
        # the prefills of the qwen3-32b (G 8) and starcoder2-7b (G 9) paths,
        # as attn_full calls them (phi3.5-moe-42b's heads are jamba's)
        (BATCH, *QWEN3_HEADS[:2], PROMPT_LEN, QWEN3_HEADS[2], None, True, f32, True),
        (BATCH, *CODER_HEADS[:2], PROMPT_LEN, CODER_HEADS[2], None, True, f32, True),
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
        ("olmoe-1b-7b path shape", BATCH, *MOE_HEADS[:2], PROMPT_LEN, MOE_HEADS[2], f32),
        ("qwen2-vl-7b path shape", BATCH, *VL_HEADS[:2], VL_SEQ, VL_HEADS[2], f32),
        ("qwen3-32b path shape", BATCH, *QWEN3_HEADS[:2], PROMPT_LEN, QWEN3_HEADS[2], f32),
        ("starcoder2-7b path shape", BATCH, *CODER_HEADS[:2], PROMPT_LEN, CODER_HEADS[2], f32),
    ):
        name = str(dtype)[6:]
        path = "path" in what  # time the path's call as attn_full makes it
        q, k, v, out = flash_case(torch, g, dev, B, h, kvH, S, d, dtype, strided=path)
        gqa = kvH != h
        label = (f"flash_attention {what} B={B} H={h}{f' kvH={kvH}' if gqa else ''} S={S}"
                 f" hd={d} {name}{' strided' if path else ''}")
        shapes.append(timed_shape(
            label, lambda: flash_attention(q, k, v, out=out),
            lambda: flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=gqa),
            cost(q, k, v), name))
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
        cost,
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
    # and with pos >= Sc; qwen3-32b's GQA shape; every later path's decode
    # (first and last step); head dims that run
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
        # the olmoe-1b-7b path's decode: its first and its last step
        (BATCH, *MOE_HEADS[:2], PROMPT_LEN, MOE_HEADS[2], PROMPT_LEN, "float32", "float32"),
        (BATCH, *MOE_HEADS[:2], PROMPT_LEN, MOE_HEADS[2], PROMPT_LEN + MAX_NEW - 2,
         "float32", "float32"),
        # the decodes of the qwen2-vl-7b (G 7), musicgen-large and
        # jamba-v0.1-52b paths: first and last step
        *((BATCH, *heads[:2], S, heads[2], pos, "float32", "float32")
          for heads, S in ((VL_HEADS, VL_SEQ), (AUDIO_HEADS, PROMPT_LEN),
                           (HYBRID_HEADS, PROMPT_LEN), (QWEN3_HEADS, PROMPT_LEN),
                           (CODER_HEADS, PROMPT_LEN))
          for pos in (S, S + MAX_NEW - 2)),
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
        ("olmoe-1b-7b path shape", BATCH, *MOE_HEADS[:2], PROMPT_LEN, MOE_HEADS[2],
         PROMPT_LEN + 3, "float32"),
        ("qwen2-vl-7b path shape", BATCH, *VL_HEADS[:2], VL_SEQ, VL_HEADS[2], VL_SEQ + 3,
         "float32"),
        ("qwen3-32b path shape", BATCH, *QWEN3_HEADS[:2], PROMPT_LEN, QWEN3_HEADS[2],
         PROMPT_LEN + 3, "float32"),
        ("starcoder2-7b path shape", BATCH, *CODER_HEADS[:2], PROMPT_LEN, CODER_HEADS[2],
         PROMPT_LEN + 3, "float32"),
    ):
        q, k, v, _, _ = case(B, h, kvH, Sc, d, pos, kv, kv)
        splits = split_plan(B, kvH, min(Sc, pos + 1), n_sm)
        q4 = q[:, :, None]
        label = (f"decode_attention {what} B={B} H={h} kvH={kvH} Sc={Sc} hd={d} pos={pos} {kv}"
                 f" (splits {splits[0]})")
        # every slot is valid at these shapes, so SDPA needs no mask
        shapes.append(timed_shape(
            label, lambda: decode_attention(q, k, v, pos),
            lambda: decode_attention_plain(q, k, v, pos),
            lambda: F.scaled_dot_product_attention(q4, k, v, enable_gqa=kvH != h),
            cost(q, k, v, pos), kv))
    return summary(worst, shapes)


def check_long_shapes(torch, dev, heads, what, windows=(None,), seed=SEED + 4):
    """K2 and K3 at long shapes with ``heads`` (H, kvH, hd): K2 at S 2048
    with each of ``windows`` (None: global) in f32 and bf16; K3 at Sc 4096
    in f32, bf16 and int8 (SDPA over the cache dequantized beforehand as
    the int8 row's library call).  Each is checked against its plain
    version and timed; the bounds count the function's own work at ``hd``.
    A head dim the kernels run zero-padded (the gemma3-27b config's 168,
    padded to 192) also gets each call's kernels from the profiler, the pad
    copies among them.  Returns (K2 rows, K3 rows, K2 worst f32 error, K3
    worst f32 error)."""
    import torch.nn.functional as F

    from repro_torch.kernels import native
    from repro_torch.kernels.decode_attention import ops as k3
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        decode_attention_plain,
        sm_count,
        split_plan,
    )
    from repro_torch.kernels.flash_attention import ops as k2
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.models.attention import dequantize_kv, quantize_kv

    g = torch.Generator(device=dev).manual_seed(seed)
    B, (H, kvH, hd) = 1, heads
    S, Sc = 2048, 4096
    flash_rows, decode_rows, worst, profiled = [], [], [0.0, 0.0], []
    gqa = kvH != H
    pos_q = torch.arange(S, device=dev)[:, None]
    pos_k = torch.arange(S, device=dev)[None, :]
    for window in windows:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            q, k, v, _ = flash_case(torch, g, dev, B, H, kvH, S, hd, dtype)
            got = flash_attention(q, k, v, window=window)
            want = flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rel = rel_rms(got, want)
            label = (f"flash_attention long, {what} B={B} H={H} kvH={kvH}"
                     f" S={S} hd={hd} window={window} {name}")
            print(f"  {label}: max abs err {err:.3e}, rel rms {rel:.3e}")
            check(err <= TOL[name], f"{label}: error {err} > {TOL[name]}")
            if dtype == torch.bfloat16:
                check(rel <= REL_RMS_BF16, f"{label}: rel rms {rel} > {REL_RMS_BF16}")
            else:
                worst[0] = max(worst[0], err)
            mask = (pos_k <= pos_q) & (pos_q - pos_k < (window or S))
            library = (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=gqa)) \
                if window is None else (lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=gqa))
            profiled.append(lambda q=q, k=k, v=v, w=window: flash_attention(q, k, v, window=w))
            flash_rows.append(timed_shape(
                label, lambda: flash_attention(q, k, v, window=window),
                lambda: flash_attention_plain(q, k, v, window=window), library,
                k2.cost(q, k, v, window=window), name))
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
        label = (f"decode_attention long, {what} B={B} H={H} kvH={kvH}"
                 f" Sc={Sc} hd={hd} pos={pos} {kv} (splits {splits[0]})")
        rel = rel_rms(got, want)
        print(f"  {label}: max abs err {err:.3e}, rel rms {rel:.3e}")
        check(err <= TOL[kv], f"{label}: error {err} > {TOL[kv]}")
        if kv == "bfloat16":
            check(rel <= REL_RMS_BF16, f"{label}: rel rms {rel} > {REL_RMS_BF16}")
        elif kv == "float32":
            worst[1] = max(worst[1], err)
        q4 = q[:, :, None]
        kd, vd = (dequantize_kv(k, ks, qd), dequantize_kv(v, vs, qd)) if kv == "int8" else (k, v)
        profiled.append(lambda q=q, k=k, v=v, ks=ks, vs=vs: decode_attention(q, k, v, pos, ks, vs))
        decode_rows.append(timed_shape(
            label + (" (library: sdpa over the dequantized cache)" if kv == "int8" else ""),
            lambda: decode_attention(q, k, v, pos, ks, vs),
            lambda: decode_attention_plain(q, k, v, pos, ks, vs),
            lambda: F.scaled_dot_product_attention(q4, kd, vd, enable_gqa=gqa),
            k3.cost(q, k, v, pos, ks, vs), "bfloat16" if kv == "bfloat16" else "float32"))
    if hd not in native.ATTENTION_HEAD_DIMS:
        for row, fn in zip(flash_rows + decode_rows, profiled):
            # the padded call's own kernels: the zero-pad copies beside K2 / K3
            row["kernels_us"] = kernel_device_us(torch, fn)
            print(f"  {row['shape']}: device us by kernel (profiler)")
            for name, v in sorted(row["kernels_us"].items(), key=lambda kv: -kv[1]["us"]):
                print(f"    {v['us']:8.2f} us, {v['launches']:.0f} launches a call  {name[:90]}")
    return flash_rows, decode_rows, worst[0], worst[1]


GENERIC_HEAD_DIMS = (257, 320, 512)  # past 256: K2's and K3's generic instances


def check_generic_head_dim(torch, dev):
    """K2 and K3 past head dim 256, on their generic instances (the head dim
    a runtime argument): at each of GENERIC_HEAD_DIMS checked against the
    plain versions (K2 f32 causal and windowed and bf16, ragged S 300, GQA;
    K3 over f32, bf16 and int8 caches, GQA, a partial cache), then timed:
    K2 at S 1024 (f32, and bf16 at hd 512), K3 at Sc 4096 (f32, and bf16
    and int8 at hd 512; SDPA over the dequantized cache as the int8 row's
    library call).  Returns (K2 rows, K3 rows, K2 worst f32 error, K3 worst
    f32 error)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as k3
    from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_plain
    from repro_torch.kernels.flash_attention import ops as k2
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.models.attention import dequantize_kv, quantize_kv

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = [0.0, 0.0]

    def decode_case(B, H, kvH, Sc, hd, kv):
        qd = bf16 if kv == "bfloat16" else f32
        q = torch.randn(B, H, hd, generator=g, device=dev).to(qd)
        k = torch.randn(B, kvH, Sc, hd, generator=g, device=dev)
        v = torch.randn(B, kvH, Sc, hd, generator=g, device=dev)
        if kv == "int8":
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            return q, k, v, ks, vs
        return q, k.to(qd), v.to(qd), None, None

    for hd in GENERIC_HEAD_DIMS:
        for dtype, window in ((f32, None), (f32, 100), (bf16, None)):
            name = str(dtype)[6:]
            q, k, v, _ = flash_case(torch, g, dev, 1, 8, 2, 300, hd, dtype)
            got = flash_attention(q, k, v, window=window)
            want = flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rel = rel_rms(got, want)
            print(f"  flash_attention generic B=1 H=8 kvH=2 S=300 hd={hd} window={window}"
                  f" {name}: max abs err {err:.3e}, rel rms {rel:.3e}")
            check(err <= TOL[name], f"generic flash_attention hd {hd}: error {err}")
            if dtype == bf16:
                check(rel <= REL_RMS_BF16, f"generic flash_attention hd {hd}: rel rms {rel}")
            else:
                worst[0] = max(worst[0], err)
        for kv in ("float32", "bfloat16", "int8"):
            q, k, v, ks, vs = decode_case(2, 8, 2, 1000, hd, kv)
            got = decode_attention(q, k, v, 900, ks, vs)
            want = decode_attention_plain(q, k, v, 900, ks, vs)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            print(f"  decode_attention generic B=2 H=8 kvH=2 Sc=1000 hd={hd} pos=900 {kv}:"
                  f" max abs err {err:.3e}")
            check(err <= TOL[kv], f"generic decode_attention hd {hd} {kv}: error {err}")
            if kv == "bfloat16":
                check(rel_rms(got, want) <= REL_RMS_BF16, f"generic decode hd {hd}: rel rms")
            elif kv == "float32":
                worst[1] = max(worst[1], err)

    flash_rows, decode_rows = [], []
    B, H, kvH, S, Sc = 1, 8, 2, 1024, 4096
    for hd, dtype in ((257, f32), (320, f32), (512, f32), (512, bf16)):
        name = str(dtype)[6:]
        q, k, v, _ = flash_case(torch, g, dev, B, H, kvH, S, hd, dtype)
        flash_rows.append(timed_shape(
            f"flash_attention generic B={B} H={H} kvH={kvH} S={S} hd={hd} {name}",
            lambda: flash_attention(q, k, v), lambda: flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            k2.cost(q, k, v), name))
    for hd, kv in ((257, "float32"), (320, "float32"), (512, "float32"), (512, "bfloat16"),
                   (512, "int8")):
        q, k, v, ks, vs = decode_case(B, H, kvH, Sc, hd, kv)
        pos = Sc - 1
        q4 = q[:, :, None]
        if kv == "int8":  # SDPA over the cache dequantized beforehand
            kd, vd = dequantize_kv(k, ks, f32), dequantize_kv(v, vs, f32)
            library = (lambda: F.scaled_dot_product_attention(q4, kd, vd, enable_gqa=True))
        else:
            library = (lambda: F.scaled_dot_product_attention(q4, k, v, enable_gqa=True))
        decode_rows.append(timed_shape(
            f"decode_attention generic B={B} H={H} kvH={kvH} Sc={Sc} hd={hd} pos={pos} {kv}"
            + (" (library: sdpa over the dequantized cache)" if kv == "int8" else ""),
            lambda: decode_attention(q, k, v, pos, ks, vs),
            lambda: decode_attention_plain(q, k, v, pos, ks, vs), library,
            k3.cost(q, k, v, pos, ks, vs), "bfloat16" if kv == "bfloat16" else "float32"))
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
    # jamba-v0.1-52b's heads (H 128, P 64, N 16, one group): its path's
    # prefill as mamba_full passes it, then S 1024 (16 kernel chunks)
    jh, jp, jn = HYBRID_SSM
    cases += [(BATCH, PROMPT_LEN, jh, 1, jp, jn, chunk, d, True) for d in (f32, bf16)]
    cases += [(BATCH, PROMPT_LEN, jh, 1, jp, jn, chunk, f32, False)]
    cases += [(1, 1024, jh, 1, jp, jn, chunk, d, s) for d, s in ((f32, False), (bf16, True))]
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
    1024 under the profiler; then at the jamba-v0.1-52b path's shape (H
    128, N 16) and at S 1024 there.  Uses whichever ``repro_torch`` comes
    first on ``sys.path``, so it also times a parent commit's kernel:
    ``python3 -c "import sys; sys.path[:0] = ['PARENT/src', '.']; import torch,
    chip_smoke; chip_smoke.time_ssd_scan(torch, torch.device('cuda'))"``."""
    from repro_torch.kernels.ssd_scan.ops import cost, ssd_scan, ssd_scan_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    chunk = 256
    mamba2 = (48, 64, 128)  # mamba2-780m's H, P, N
    shapes = []
    for label, (B, S), (H, P, N) in (
        ("path shape", (BATCH, PROMPT_LEN), mamba2), ("S=1024", (1, 1024), mamba2),
        ("S=4096", (1, 4096), mamba2),
        ("jamba-v0.1-52b path shape", (BATCH, PROMPT_LEN), HYBRID_SSM),
        ("jamba-v0.1-52b S=1024", (1, 1024), HYBRID_SSM),
    ):
        x, a, Bm, Cm = ssd_inputs(torch, g, dev, B, S, H, 1, P, N, torch.float32)
        ms = time_ms(lambda: ssd_scan(x, a, Bm, Cm, chunk=chunk), iters=20)
        dev_us, method = device_us(lambda: ssd_scan(x, a, Bm, Cm, chunk=chunk))
        plain_ms = time_ms(lambda: ssd_scan_plain(x, a, Bm, Cm, chunk), iters=20)
        b_ms, b_by = bound(cost(x, a, Bm, Cm, chunk=chunk))
        print(f"  ssd_scan {label} (B={B}, S={S}, H={H}, P={P}, N={N}, f32): kernel"
              f" {ms:.4f} ms, {dev_us:.2f} us device ({method}), plain {plain_ms:.4f} ms,"
              f" bound {b_ms:.6f} ms ({b_by})")
        row = {"shape": f"{label}: B={B} S={S} H={H} P={P} N={N} f32", "ms": ms,
               "device_us": dev_us, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None, "library_device_us": None,
               "device_time_by": method}
        if label == "S=1024":  # each of K4's kernels on its own
            row["kernels_us"] = kernel_device_us(torch, lambda: ssd_scan(x, a, Bm, Cm, chunk=chunk))
            for k, v in row["kernels_us"].items():
                print(f"    profiler: {v['us']:8.2f} us, {v['launches']:.0f} launches a call  {k[:90]}")
        shapes.append(row)
    return shapes


def granite_config():
    """granite-4.0-h-small as the benchmark runs it: the ``program`` group of
    ``coldbench/configs/granite-4.0-h-small.json`` as the port's
    ``ModelConfig`` (10 layers, 9 of 72 experts held)."""
    from coldbench import spec

    return spec.program_config(spec.config(GRANITE_CONFIG))


def check_moe_experts(torch, dev):
    """K5 against its plain version at granite-4.0-h-small's widths (d
    4096, experts of 768, 9 held of a router over 72, top 10) at the
    cell's prefill (2 x 1,024 tokens) and a decode step (2 tokens): the
    pairs sorted by ``models.moe._sort_pairs`` from a random router's
    top 10, ``out`` starting at a shared expert's stand-in.  One launch a
    call; then each shape timed through ``timed_shape`` against the
    port's ``cost`` of that routing.  The decode step's routing is drawn
    until it holds 2 or more pairs (at the cell's shape it holds 2.5 on
    average), so that its time is of work done."""
    from repro_torch.kernels.moe_experts.ops import (
        LAUNCHES, cost, moe_experts, moe_experts_plain)
    from repro_torch.models.moe import _sort_pairs

    cfg = granite_config()
    d, f, E, R, k = shape = (cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.routed_experts, cfg.top_k)
    check(shape == GRANITE_MOE, f"{cfg.name}: MoE widths {shape}, not {GRANITE_MOE}")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    ws = [torch.randn(E, d, f, generator=g, device=dev) * d ** -0.5,
          torch.randn(E, d, f, generator=g, device=dev) * d ** -0.5,
          torch.randn(E, f, d, generator=g, device=dev) * f ** -0.5]
    worst, shapes = 0.0, []
    for label, T in (("granite prefill", GRANITE_PREFILL), ("granite decode", BATCH)):
        # a decode step's 2 tokens send 2.5 pairs to the held experts on
        # average, and none one step in about 18: redraw until there are 2
        for _ in range(100):
            x = torch.randn(T, d, generator=g, device=dev)
            router = torch.randn(d, R, generator=g, device=dev) * d ** -0.5
            top, idx = torch.topk(x @ router, k, dim=-1)
            tok, gate, offsets = _sort_pairs(cfg, idx, torch.softmax(top, dim=-1))
            if int(offsets[-1]) >= 2:
                break
        out = torch.randn(T, d, generator=g, device=dev)
        before = LAUNCHES.count
        got = moe_experts(x, tok, gate, offsets, *ws, out.clone())
        launches = LAUNCHES.count - before
        want = moe_experts_plain(x, tok, gate, offsets, *ws, out.clone())
        torch.cuda.synchronize()
        held = int(offsets[-1])
        diff = (got - want).abs()
        excess = (diff - MOE_EXPERTS_TOL * (1 + want.abs())).max().item()
        worst = max(worst, diff.max().item())
        name = (f"moe_experts {label}: T={T} d={d} f={f} E={E} of {R} top-{k}, {held} held"
                f" pairs, f32")
        print(f"  {name}: {launches} launch, max abs err {diff.max().item():.3e}")
        check(launches == 1, f"{name}: {launches} launches, not 1")
        check(excess <= 0, f"{name}: error beyond rtol=atol={MOE_EXPERTS_TOL}")
        acc = out.clone()
        shapes.append(timed_shape(
            name, lambda: moe_experts(x, tok, gate, offsets, *ws, acc),
            lambda: moe_experts_plain(x, tok, gate, offsets, *ws, acc), None,
            cost(x, tok, gate, offsets, *ws, acc), "float32"))
    return summary(worst, shapes)


# -------------------------------------------------------------- main path
def fine_tune(params, cfg, page: int = 0):
    """Perturb one 64 KiB page of every layer's attention output matrix
    (the ``page``-th: rows offset by ``page`` pages) and add ``0.01 * (page
    + 1)`` to the final norm: the rest of the image stays identical to the
    base.  Fine-tunes at other pages have disjoint private pages."""
    wo = params["pattern"][0]["attn"]["wo"].clone()
    rows = (64 << 10) // (cfg.d_model * wo.element_size())
    wo[:, page * rows:(page + 1) * rows, :] += 0.01
    attn = dict(params["pattern"][0]["attn"], wo=wo)
    layer = dict(params["pattern"][0], attn=attn)
    return dict(params, pattern=(layer,), final_norm=params["final_norm"] + 0.01 * (page + 1))


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


def event_device_us(e) -> float:
    """A profiler event's own device time in microseconds."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def device_events(prof) -> list:
    """The profile's device-side events (kernels, copies, fills) that took
    device time.  A host op reports its kernels' time as its own device
    time too, so host events are left out: counting both counts it twice.
    So are the device spans of ``record_function`` ranges."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and event_device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def range_kernels(prof, name: str):
    """The calls of the ``record_function`` range ``name`` in a profile and
    the device time (µs) of the kernels launched inside them, by kernel."""
    from torch.autograd import DeviceType

    spans = [e for e in prof.events() if e.name == name and e.device_type == DeviceType.CPU]
    by_kernel = {}

    def walk(e):
        for k in e.kernels:
            by_kernel[k.name] = by_kernel.get(k.name, 0.0) + k.duration
        for c in e.cpu_children:
            walk(c)

    for e in spans:
        walk(e)
    return len(spans), by_kernel


def profile_cold_start(torch, np, node, cfg, fname, prompt, want, ranges=(), mode="spice"):
    """One more cold start of ``fname`` (restore ``mode``) under
    torch.profiler: the device's busy share of the request and the kernels
    that take its device time; for each ``record_function`` range named in
    ``ranges``, the device ms of the kernels inside it."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    node.evict()
    torch.cuda.synchronize()
    # the node serves on its worker threads: a range there is seen only
    # when the profiler records every thread's host ops
    kw = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)} if ranges else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True, **kw) as prof:
        t0 = time.perf_counter()
        r = node.invoke(fname, prompt, MAX_NEW, mode=mode, cfg=cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(r.tokens, want), f"profiled {mode} cold start: tokens differ")
    # a baseline's stats (core/baselines.py BaselineStats) have no upload
    upload = f", upload {r.stats['upload_s'] * 1e3:.1f} ms" if "upload_s" in r.stats else ""
    report_profile(prof, f"{mode} cold start {fname}", wall_ms,
                   f"ttft {r.ttft_s * 1e3:.1f} ms, restore {r.stats['total_s'] * 1e3:.1f} ms"
                   + upload, ranges)


def report_profile(prof, label, wall_ms, detail, ranges=()):
    """Print a profiled run's device busy share, the kernels that take its
    device time and, for each ``record_function`` range in ``ranges``, the
    device ms of the kernels inside it."""
    dev_us = event_device_us
    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if not events:
        print(f"  profiled {label}: the profiler saw no device time (not measured)")
        return
    print(f"  profiled {label}: wall {wall_ms:.1f} ms ({detail}),"
          f" device busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of the run")
    ranked = sorted(events, key=dev_us, reverse=True)
    # the ten largest, and the port's own kernels wherever they rank
    for rank, e in enumerate(ranked):
        if rank < 10 or "_kernel<" in e.key and "anonymous namespace" in e.key:
            print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:80]}")
    for name in ranges:
        calls, by_kernel = range_kernels(prof, name)
        if not calls:
            print(f"  device ms in {name}: the profiler saw no such range (not measured)")
            continue
        total = sum(by_kernel.values()) / 1e3
        print(f"  device ms in {name} ({calls} calls): {total:.3f} ms = "
              f"{100 * total / busy_ms:.1f}% of device busy (the port's kernels are"
              f" in the ranked list above)")
        for kname, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {us / 1e3:9.3f} ms  {kname[:90]}")


def reset(counters) -> None:
    for c in counters.values():
        c.reset()


def counts(counters) -> dict:
    return {n: c.count for n, c in counters.items()}


def request_plan(names):
    """``main_path``'s requests in order: each function cold
    ``COLD_REPEATS`` times, then the last one warm (its profiled cold start
    of the last function follows them)."""
    return [(f, "cold") for f in names for _ in range(COLD_REPEATS)] + [(names[-1], "warm")]


# a Spice restore's RestoreStats keys that each request prints
RESTORE_KEYS = ("metadata_s", "first_tensor_s", "total_s", "bytes_read", "base_bytes",
                "uploaded_bytes", "patched_on_device_bytes", "upload_s")


def main_path(torch, np, dev, counters, cfg, base_name, fns, per_request, ranges=(),
              after=None, params=None):
    """Publish a base function and a fine-tune (``fns``: name -> params
    maker) against a ``BaseImage`` of the seed weights of ``cfg`` (or of
    ``params`` where given), cold-start each ``COLD_REPEATS`` times and
    serve the last one warm.  ``per_request`` names kernels with the
    launches every request must make; ``ranges`` names profiler ranges to
    report from the profiled cold start.  Returns a dict: the path's launch
    counts (``"launches"``), the image's bytes (``"image_bytes"``), each
    function's publish sizes (``"publish"``), each request's row
    (``"requests"``) and, when ``after`` is given, what
    ``after(node, d, made, ref, prompt)`` returns (``"after"``): a later
    phase on the same node, its functions' params and their CPU tokens."""
    from repro_torch.core import BaseImage, BufferPool
    from repro_torch.interop import dtype_name, tree_leaves
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServerlessNode, generate, layerwise_state

    t0 = time.perf_counter()
    if params is None:
        params = lm.init_params(cfg, seed=SEED, device=dev)
    made = {name: make(params, cfg) for name, make in fns.items()}
    image_bytes = sum(t.nbytes for t in tree_leaves(params))
    dtypes = "/".join(sorted({dtype_name(t.dtype) for t in tree_leaves(params)}))
    layer = cfg.pattern[0].kind + (" + MoE" if cfg.pattern[0].moe else "")
    print(f"  {cfg.name}: {cfg.n_layers} layers ({layer}), d_model"
          f" {cfg.d_model}, vocab {cfg.vocab_size}; {sum(t.numel() for t in tree_leaves(params))}"
          f" params, image {image_bytes / 1e9:.3f} GB {dtypes} (init {time.perf_counter() - t0:.1f} s)")
    run = {"image_bytes": image_bytes, "publish": {}, "requests": []}
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
    budget = BUDGET_IMAGES * image_bytes
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
            run["publish"][fname] = {"jif_bytes": os.path.getsize(spec.jif_path),
                                        "private_bytes": st.private_bytes,
                                        "total_bytes": st.total_bytes}
            print(f"  publish {fname}: {time.perf_counter() - t0:.2f} s, jif "
                  f"{os.path.getsize(spec.jif_path)} B, private "
                  f"{st.private_bytes} B of {st.total_bytes} B")
        names = list(made)
        for fname, kind in request_plan(names):
            if kind == "cold":
                node.evict()
            before = counts(counters)
            r = node.invoke(fname, prompt, MAX_NEW, mode="spice", cfg=cfg)
            check(r.cold == (kind == "cold"), f"{fname}: expected a {kind} start")
            same = np.array_equal(r.tokens, ref[fname])
            check(same, f"{fname} {kind}: tokens {r.tokens.tolist()} != CPU "
                        f"plain path {ref[fname].tolist()}")
            s = r.stats or {}
            row = {"function": fname, "start": kind, "ttft_ms": r.ttft_s * 1e3,
                   "total_ms": r.total_s * 1e3}
            for key in RESTORE_KEYS:
                if key in s:
                    row[key] = s[key].item() if hasattr(s[key], "item") else s[key]
            row["launches"] = {k: c.count - before[k] for k, c in counters.items()
                               if k in per_request or c.count > before[k]}
            run["requests"].append(row)
            print("  request " + json.dumps(row))
            for k, n in per_request.items():
                check(row["launches"][k] == n,
                      f"{fname} {kind}: {row['launches'][k]} {k} launches, expected {n}")
        path_s = time.perf_counter() - t_path
        run["launches"] = launches = counts(counters)
        print(f"  main path {path_s:.1f} s; launches {launches}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        hw = node.memory.high_water()
        print(f"  ledger high water {hw['total'] / image_bytes:.2f} images of a "
              f"{budget / image_bytes:.0f}-image budget: "
              + ", ".join(f"{k} {v / image_bytes:.2f}" for k, v in hw.items() if v))
        print(f"  device image cache {node.scheduler.device_images.snapshot_stats()}")
        print(f"  upload stream {node.scheduler.upload_stream.snapshot_stats()}")
        profile_cold_start(torch, np, node, cfg, names[-1], prompt, ref[names[-1]], ranges)
        node.memory.audit()
        check(node.scheduler.upload_stream.snapshot_stats()["failures"] == 0,
              "upload failures")
        if after is not None:
            run["after"] = after(node, d, made, ref, prompt)
        return run
    finally:
        node.close()
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------- bf16 path
@contextlib.contextmanager
def without_ml_dtypes():
    """``import ml_dtypes`` fails inside the block, as on a machine without
    JAX; whatever ``sys.modules`` held for it comes back after."""
    held = sys.modules.get("ml_dtypes")
    sys.modules["ml_dtypes"] = None
    try:
        yield
    finally:
        if held is None:
            sys.modules.pop("ml_dtypes", None)
        else:
            sys.modules["ml_dtypes"] = held


def bf16_path(torch, np, dev, counters, cfg, per_request, f32):
    """qwen1.5-0.5b at full width and depth with bf16 weights, with
    ``ml_dtypes`` unimportable throughout: the seed weights cast to bf16
    published as ``qwen-bf16`` and the fine-tune ``fn-ft-bf16`` (one 64 KiB
    page of each ``wo`` and the final norm) against a base image of them,
    each cold-started ``COLD_REPEATS`` times (Spice restore, fused install:
    K1 patches bf16 pages; K2 / K3 run the f32 compute) and the fine-tune
    served warm once, every request's tokens equal to the CPU path's on the
    same bf16 weights; then a ``CheckpointManager`` save of the bf16 state
    on the card, restored and held bit for bit.  ``f32`` is what
    ``main_path`` returned for the f32 qwen path, printed beside this one's.
    Returns the path's launch counts."""
    import statistics

    from repro_torch.core.treeutil import flatten_state, leaf_bytes
    from repro_torch.ft.manager import CheckpointManager
    from repro_torch.interop import tree_leaves, tree_map

    probe = subprocess.run([sys.executable, "-c", "import ml_dtypes"], capture_output=True,
                           text=True, timeout=60)
    print(f"  outside the phase `import ml_dtypes` {'succeeds' if probe.returncode == 0 else 'fails'}"
          " on this machine; inside it, it fails")
    check("ml_dtypes" not in sys.modules, "ml_dtypes was loaded before the bf16 phase")
    with without_ml_dtypes():
        params = tree_map(lambda t: t.to(dev, torch.bfloat16), seeded_params(cfg, dev))
        rec = main_path(torch, np, dev, counters, cfg, "qwen-bf16-image",
                        {"qwen-bf16": lambda p, c: p, "fn-ft-bf16": fine_tune},
                        per_request, params=params)
        launches = rec["launches"]
        check(launches["overlay_patch"] > 0, "K1 was not launched on the bf16 path")
        cold = [r for r in rec["requests"] if r["function"] == "fn-ft-bf16" and r["start"] == "cold"]
        warm = [r for r in rec["requests"] if r["start"] == "warm"]
        f32_cold = [r for r in f32["requests"] if r["function"] == "fn-ft" and r["start"] == "cold"]
        for label, r in (("bf16", rec), ("f32", f32)):
            ft = r["publish"]["fn-ft-bf16" if label == "bf16" else "fn-ft"]
            print(f"  {label} fine-tune: image {r['image_bytes']} B, jif {ft['jif_bytes']} B,"
                  f" private {ft['private_bytes']} B of {ft['total_bytes']} B")
        for label, rows in (("bf16 fn-ft-bf16", cold), ("f32 fn-ft", f32_cold)):
            print(f"  {label} cold: ttft ms {[round(r['ttft_ms'], 2) for r in rows]}"
                  f" (median {statistics.median(r['ttft_ms'] for r in rows):.2f}), bytes_read"
                  f" {rows[0]['bytes_read']}, uploaded {rows[0]['uploaded_bytes']}, patched on"
                  f" device {rows[0]['patched_on_device_bytes']}, K1 launches"
                  f" {[r['launches'].get('overlay_patch', 0) for r in rows]}")
        print(f"  bf16 fn-ft-bf16 warm: ttft {warm[0]['ttft_ms']:.2f} ms, total"
              f" {warm[0]['total_ms']:.2f} ms")

        d = tempfile.mkdtemp(prefix="chip-smoke-bf16-ckpt-")
        try:
            state = {"params": params}
            mgr = CheckpointManager(d, async_save=False)
            t0 = time.perf_counter()
            mgr.save(0, state, blocking=True)
            h = mgr.history[-1]
            print(f"  checkpoint save (blocking, device -> host -> JIF): {time.perf_counter() - t0:.2f}"
                  f" s, save_s {h['save_s']:.2f}, bytes_written {h['bytes_written']} of"
                  f" {h['total_bytes']} B")
            t0 = time.perf_counter()
            restored, step = mgr.restore()
            print(f"  checkpoint restore: {time.perf_counter() - t0:.2f} s, step {step}")
            want, got = dict(flatten_state(state)[0]), dict(flatten_state(restored)[0])
            check(sorted(want) == sorted(got), "bf16 checkpoint: leaves differ")
            for name, a in want.items():
                b = got[name]
                check(isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
                      and tuple(b.shape) == tuple(a.shape)
                      and np.array_equal(leaf_bytes(b), leaf_bytes(a)),
                      f"bf16 checkpoint: {name} did not restore bit for bit")
            print(f"  checkpoint: {len(want)} bf16 leaves restored bit for bit"
                  f" ({sum(t.nbytes for t in tree_leaves(restored))} B)")
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return launches


# ------------------------------------------------------- restore modes
MODES = ("spice", "spice_sync", "criu_star", "reap_star", "faasnap_star")
SPICE_MODES = ("spice", "spice_sync")  # the fused install (and so K1) runs under these only
# core/baselines.py BaselineStats
BASELINE_KEYS = ("metadata_s", "total_s", "bytes_read", "io_ops", "restore_ops", "major_faults")


def modes_path(torch, np, counters, cfg, fname, per_request, node, d, made, ref, prompt):
    """``main_path``'s fine-tune ``fname`` republished on its node in the
    reference's default formats (the JIF, CRIU*'s file per tensor, the
    monolith) and cold-started ``COLD_REPEATS`` times under each restore
    mode: every request's tokens against the CPU plain path, K2 and K3
    launching as ``per_request`` says in every mode, K1 under the Spice
    modes only (the baselines install each leaf with a copy of its own, no
    patch).  Reads go through the page cache, as the reference benchmark's
    do.  One cold start of each baseline is profiled.  Returns the phase's
    launch counts."""
    import statistics

    print(f"== restore modes on {cfg.name} {fname}: {', '.join(MODES)}")
    reset(counters)
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    spec = node.publish(fname, cfg, made[fname], d, base_name=node.registry.get(fname).base_image,
                        formats=("jif", "criu", "monolith"), warm_ttl_s=600.0)
    criu = spec.jif_path.replace(".jif", ".criu")
    criu_bytes = sum(os.path.getsize(os.path.join(criu, f)) for f in os.listdir(criu))
    print(f"  publish {fname} in every format: {time.perf_counter() - t0:.2f} s; jif"
          f" {os.path.getsize(spec.jif_path)} B, criu {len(os.listdir(criu)) - 1} files"
          f" {criu_bytes} B, monolith {os.path.getsize(spec.jif_path.replace('.jif', '.mono'))} B")
    kernels = ("overlay_patch", *per_request)
    times = {}
    for mode in MODES:
        for _ in range(COLD_REPEATS):
            node.evict()
            before = counts(counters)
            r = node.invoke(fname, prompt, MAX_NEW, mode=mode, cfg=cfg)
            check(r.cold, f"{mode}: expected a cold start")
            check(np.array_equal(r.tokens, ref[fname]),
                  f"{mode}: tokens {r.tokens.tolist()} != CPU plain path {ref[fname].tolist()}")
            row = {"mode": mode, "ttft_ms": r.ttft_s * 1e3, "total_ms": r.total_s * 1e3}
            for key in RESTORE_KEYS if mode in SPICE_MODES else BASELINE_KEYS:
                v = r.stats[key]
                row[key] = v.item() if hasattr(v, "item") else v
            row["charged"] = node.scheduler.instance(fname).ws_region is not None
            row["launches"] = {k: counters[k].count - before[k] for k in kernels}
            print("  request " + json.dumps(row))
            for k, n in per_request.items():
                check(row["launches"][k] == n,
                      f"{mode}: {row['launches'][k]} {k} launches, expected {n} as under spice")
            k1 = row["launches"]["overlay_patch"]
            check(k1 > 0 if mode in SPICE_MODES else k1 == 0,
                  f"{mode}: {k1} overlay_patch launches")
            times.setdefault(mode, []).append((row["ttft_ms"], row["total_ms"]))
        node.memory.audit()
        check(node.scheduler.upload_stream.snapshot_stats()["failures"] == 0,
              f"{mode}: upload failures")
    launches = counts(counters)
    print(f"  modes path {time.perf_counter() - t_path:.1f} s; launches {launches}")
    for mode in MODES:
        if mode not in SPICE_MODES:
            profile_cold_start(torch, np, node, cfg, fname, prompt, ref[fname], mode=mode)
    node.memory.audit()
    med = {m: {"ttft_ms": statistics.median(t for t, _ in v),
               "total_ms": statistics.median(t for _, t in v)} for m, v in times.items()}
    for m in MODES:
        med[m]["ttft_x_spice"] = med[m]["ttft_ms"] / med["spice"]["ttft_ms"]
        med[m]["total_x_spice"] = med[m]["total_ms"] / med["spice"]["total_ms"]
    print("  modes median " + json.dumps(med))
    return launches


# ------------------------------------------------- concurrent invocations
CONCURRENT_FNS = ("fn-ft", "fn-ft-1", "fn-ft-2", "fn-ft-3")  # fine_tune pages 0-3 of one base
CONCURRENT_IMAGES = 7  # the ledger budget, in images, that admits all four restores at once
CONCURRENT_ROUNDS = 3  # spice rounds of the multi-tenant regime: the first builds the device
# base, the last runs under the profiler
BURST = 6  # invocations of one cold function submitted at once
WORKERS = 8  # NodeScheduler's default max_workers, in both packages
RESTORE_S = 1.0  # the cancel / deadline regime slows its restores' reads to last about this long
OWN_DEADLINE_S = 0.3  # a slowed restore's own deadline: it passes mid-restore
LATE_DEADLINE_S = 0.01  # a queued invocation's deadline: it passes while every worker is busy
WAIT_S = 120.0  # the bound on every wait of the concurrent regimes
# invocation timeline events (serve/invocation.py EVT_*, the same strings in both packages)
EVT_RESTORING, EVT_WS_READY, EVT_DONE = "RESTORING", "WS_READY", "DONE"


def wait_until(cond, what: str) -> None:
    """Poll ``cond`` every 2 ms; fail after ``WAIT_S`` seconds."""
    end = time.monotonic() + WAIT_S
    while not cond():
        check(time.monotonic() < end, f"timed out waiting for {what}")
        time.sleep(0.002)


def outcome(mod, handle):
    """A handle's ``InvokeResult``, or the class name of the typed outcome
    it raised (``InvocationCancelled``, ``DeadlineExceeded``,
    ``Overloaded`` of ``mod``, either package's ``serve.engine``); any
    other error propagates."""
    try:
        return handle.result(WAIT_S)
    except (mod.InvocationCancelled, mod.DeadlineExceeded, mod.Overloaded) as e:
        return type(e).__name__


def multi_tenant(node, fnames, prompt, max_new, mode, cfg):
    """The reference benchmark's ``_multi_tenant`` (benchmarks/concurrency.py)
    on a ``ServerlessNode`` of either package, its reads through the page
    cache: every function evicted, then each of ``fnames`` cold-started at
    once through ``node.submit``.  Returns (results by function, wall s,
    aggregate read bytes/s as the reference computes it, demand boosts)."""
    node.evict()
    before = node.iosched.snapshot_stats()
    t0 = time.perf_counter()
    handles = [node.submit(f, prompt, max_new, mode=mode, cfg=cfg) for f in fnames]
    results = [h.result(WAIT_S) for h in handles]
    wall = time.perf_counter() - t0
    after = node.iosched.snapshot_stats()
    read = after["bytes_read"] - before["bytes_read"]
    if read == 0:  # faasnap* reads on streams of its own, past the arbiter
        read = sum((r.stats or {}).get("bytes_read", 0) for r in results)
    return ({r.function: r for r in results}, wall, read / wall,
            after["demand_boosts"] - before["demand_boosts"])


def burst(node, fname, prompt, max_new, cfg, n, simulate_read_bw=None):
    """The reference benchmark's ``_burst``: every function evicted, then
    ``n`` invocations of ``fname`` submitted at once; one restores, the
    others ride its restore.  Returns the results in submission order."""
    node.evict()
    handles = [node.submit(fname, prompt, max_new, mode="spice", cfg=cfg,
                           simulate_read_bw=simulate_read_bw) for _ in range(n)]
    return [h.result(WAIT_S) for h in handles]


def cancel_deadline(mod, node, cfg, prompt, max_new, warm, doomed, late, slow_bw):
    """A cancel and deadlines with uploads in flight, on ``node`` (a fused
    ``ServerlessNode`` of either package with ``WORKERS`` invoke workers;
    ``mod`` its ``serve.engine``), where ``warm`` is warm and ``doomed`` and
    ``late`` are cold:

    - ``doomed`` cold-starts with its reads slowed to ``slow_bw``;
    - ``late`` cold-starts the same way with a deadline ``OWN_DEADLINE_S``
      ahead, which passes during its restore, and ``WORKERS - 2`` more
      invocations of ``late`` ride that restore: every worker is busy;
    - once each of them shows RESTORING and ``doomed``'s first upload has
      landed, one more invocation of ``late``, with a deadline
      ``LATE_DEADLINE_S`` ahead, and one of ``warm`` are queued; once that
      deadline has passed, ``doomed`` is cancelled.  Its worker then claims
      the queued ``late`` (both packages check a deadline at submit and at
      claim only) and serves ``warm`` while ``late``'s restore is in flight.

    Returns each handle's ``outcome`` (``"riders"`` a list) and
    ``"accepted"`` (what ``cancel()`` returned), ``"own_restoring"`` (the
    deadline of the slowed ``late`` passed after its RESTORING) and
    ``"warm_first"`` (``warm`` was done before the slowed ``late``)."""
    sched = node.scheduler
    inv = mod.Invocation
    held = sched.instance(doomed)
    stale = held.restore_stats if held is not None else None  # an earlier restore's

    def landed() -> bool:
        inst = sched.instance(doomed)
        st = inst.restore_stats if inst is not None else None
        return st is not None and st is not stale and (
            st.patched_on_device_bytes + st.uploaded_bytes > 0)

    doomed_h = node.submit_invocation(inv(doomed, prompt, max_new, cfg=cfg,
                                          simulate_read_bw=slow_bw))
    own = node.submit_invocation(inv(late, prompt, max_new, cfg=cfg, simulate_read_bw=slow_bw,
                                     deadline_s=mod.deadline_in(OWN_DEADLINE_S)))
    riders = [node.submit_invocation(inv(late, prompt, max_new, cfg=cfg))
              for _ in range(WORKERS - 2)]
    wait_until(lambda: landed() and all(h.event_ts(EVT_RESTORING) is not None
                                        for h in (doomed_h, own, *riders)),
               f"every worker restoring and {doomed}'s first upload")
    late_h = node.submit_invocation(inv(late, prompt, max_new, cfg=cfg,
                                        deadline_s=mod.deadline_in(LATE_DEADLINE_S)))
    warm_h = node.submit_invocation(inv(warm, prompt, max_new, cfg=cfg))
    wait_until(lambda: time.monotonic() >= late_h.invocation.deadline_s,
               f"the queued {late}'s deadline")
    check(doomed_h.event_ts(EVT_WS_READY) is None,
          f"{doomed}'s working set landed before the cancel: slow its reads further")
    out = {"accepted": doomed_h.cancel(), "doomed": outcome(mod, doomed_h),
           "late": outcome(mod, late_h), "warm": outcome(mod, warm_h),
           "own": outcome(mod, own), "riders": [outcome(mod, h) for h in riders]}
    out["own_restoring"] = own.event_ts(EVT_RESTORING) < own.invocation.deadline_s
    out["warm_first"] = warm_h.event_ts(EVT_DONE) < own.event_ts(EVT_DONE)
    return out


def live_blocks(torch) -> dict:
    """Every block allocated on the card (``torch.cuda.memory_snapshot``) by
    address."""
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                blocks[addr] = b
            addr += b["size"]
    return blocks


def concurrent_path(torch, np, counters, cfg, per_request, node, d, made, ref, prompt):
    """The invocation plane under contention on ``main_path``'s qwen node,
    after ``modes_path`` (which wrote ``fn-ft``'s monolith): ``fn-ft-1..3``
    (``fine_tune`` pages 1-3 of the same base) published in the JIF and the
    monolith and their CPU tokens taken; one sequential cold start of
    ``fn-ft-2`` with the base's device pages not built (the comparator),
    then, all through ``node.submit`` / ``submit_invocation``:

    A. the four fine-tunes cold-started at once, ``CONCURRENT_ROUNDS``
       spice rounds on a ``CONCURRENT_IMAGES``-image budget (the first
       builds the device base, the others share it, the last runs under
       the profiler), then one round in ``faasnap_star``;
    B. ``BURST`` invocations of cold ``fn-ft-2``: one restore, the rest ride it;
    C. ``cancel_deadline`` with ``fn-ft`` warm, ``fn-ft-3`` cancelled after
       its first upload and ``fn-ft-1``'s deadlines, then ``fn-ft-3`` again;
    D. the four cold-started at once, twice, on ``main_path``'s
       ``BUDGET_IMAGES``-image budget: a result or a typed outcome each.

    Every result holds the CPU's tokens and the ledger audits clean after
    each regime.  After every eviction the bytes allocated on the card are
    those of one of two levels, taken once each of the ``WORKERS`` invoke
    workers has served a request: with the device image cache empty, and
    holding the whole base (round 1 of A leaves the cache's entries and
    nothing else).  Returns the phase's launch counts (``"launches"``) and
    K1's launches in the sequential cold start (``"k1_cold"``)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.interop import tree_leaves
    from repro_torch.serve import engine as mod
    from repro_torch.serve.engine import generate, layerwise_state

    print(f"== concurrent invocations on {cfg.name}: {', '.join(CONCURRENT_FNS)} (fine-tunes of"
          f" one base), multi-tenant, burst, cancel and deadlines, pressure")
    dev, sched = node.device, node.scheduler
    images, uploads = sched.device_images, sched.upload_stream
    base = made["fn-base"]
    image_bytes = sum(t.nbytes for t in tree_leaves(base))
    fns = CONCURRENT_FNS
    reset(counters)
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    want = {"fn-ft": ref["fn-ft"]}
    for f in fns[1:]:
        p = fine_tune(base, cfg, page=int(f[-1]))
        want[f] = generate(cfg, None, layerwise_state(cfg, p), prompt, MAX_NEW, device="cpu")[0]
        node.publish(f, cfg, p, d, base_name=sched.registry.get("fn-ft").base_image,
                     formats=("jif", "monolith"), warm_ttl_s=600.0)
        del p
    private = {f: node.catalog.publish_stats(f).private_bytes for f in fns}
    print(f"  CPU tokens and publish of {', '.join(fns[1:])} in {time.perf_counter() - t0:.1f} s;"
          f" private bytes {private}")

    def settle():
        """Every upload landed, garbage collected, the card synchronized:
        the bytes allocated on the card and the live blocks by address."""
        check(uploads.flush(WAIT_S), "the upload stream did not drain")
        gc.collect()
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_allocated(dev), live_blocks(torch)

    def moved(level, what: str):
        """The bytes allocated now, the blocks live now and not at
        ``level`` and those gone since; printed when the bytes differ."""
        got, blocks = settle()
        came = [b for a, b in blocks.items() if a not in level[1]]
        gone = [b for a, b in level[1].items() if a not in blocks]
        if got != level[0]:
            for label, bs in (("live now, not then", came), ("live then, not now", gone)):
                sizes = sorted((b["size"] for b in bs), reverse=True)
                print(f"  {what}: {len(bs)} blocks {label}, {sum(sizes)} B; the largest {sizes[:8]}")
        return got, came, gone

    def held(level, what: str) -> None:
        got = moved(level, what)[0]
        check(got == level[0], f"{what}: {got} B allocated on the card, {level[0]} B at the"
                               f" level it is held to")

    def tokens(r, f, what: str) -> None:
        check(not isinstance(r, str), f"{what}: {f} ended {r}")
        check(np.array_equal(r.tokens, want[f]),
              f"{what}: {f} tokens {r.tokens.tolist()} != CPU plain path {want[f].tolist()}")

    def launched(before) -> dict:
        return {k: c.count - before[k] for k, c in counters.items()}

    def clean(what: str) -> None:
        node.memory.audit()
        check(uploads.snapshot_stats()["failures"] == 0, f"{what}: upload failures")

    node.evict()
    images.reclaim(images.resident_bytes())
    torch.cuda.reset_peak_memory_stats(dev)
    before = counts(counters)
    seq = node.invoke("fn-ft-2", prompt, MAX_NEW, mode="spice", cfg=cfg)
    seq_peak = torch.cuda.max_memory_allocated(dev)
    k1_cold = launched(before)["overlay_patch"]
    check(seq.cold, "sequential fn-ft-2: expected a cold start")
    tokens(seq, "fn-ft-2", "sequential")
    check(seq.stats["uploaded_bytes"] == private["fn-ft-2"],
          f"sequential fn-ft-2: uploaded {seq.stats['uploaded_bytes']} B, private {private['fn-ft-2']}")
    print(f"  sequential cold fn-ft-2, device base built: ttft {seq.ttft_s * 1e3:.2f} ms, total"
          f" {seq.total_s * 1e3:.2f} ms, bytes_read {seq.stats['bytes_read']}, K1 {k1_cold},"
          f" peak device memory {seq_peak / 1e9:.3f} GB")
    # every invoke worker serves a request before the levels are taken: a
    # thread's first device work may allocate what then stays with the
    # thread (its cuBLAS workspace)
    rs = [h.result(WAIT_S) for h in [node.submit("fn-ft-2", prompt, MAX_NEW, mode="spice",
                                                 cfg=cfg) for _ in range(WORKERS)]]
    for r in rs:
        tokens(r, "fn-ft-2", "warm beside every worker")
    node.evict()
    images.reclaim(images.resident_bytes())
    # two levels the card's memory returns to after every eviction: with
    # the device image cache empty (here), and holding the whole base
    # (after the first multi-tenant round)
    empty = settle()
    print(f"  {empty[0]} B allocated on the card with the node's instances evicted and its"
          f" device image cache empty ({len(empty[1])} blocks)")

    # A. multi-tenant
    # the last spice round runs under the profiler as profile_cold_start's
    # does: the card's busy share while four requests share the node (the
    # workers' host ops are left out, as they take longer to analyse than
    # the round; their kernels are in)
    sched.memory_budget = CONCURRENT_IMAGES * image_bytes
    spice_max = {}
    for rnd in [*range(1, CONCURRENT_ROUNDS + 1), "faasnap_star"]:
        mode = "spice" if isinstance(rnd, int) else rnd
        profiled = rnd == CONCURRENT_ROUNDS
        torch.cuda.reset_peak_memory_stats(dev)
        before, cache0 = counts(counters), images.snapshot_stats()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)
              if profiled else contextlib.nullcontext()) as prof:
            res, wall, bw, boosts = multi_tenant(node, fns, prompt, MAX_NEW, mode, cfg)
            torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        k = launched(before)
        for f in fns:
            r = res[f]
            tokens(r, f, f"multi-tenant {rnd}")
            check(r.cold and not r.joined, f"multi-tenant {rnd}: {f} was not a restore of its own")
            if mode == "spice":
                check(r.stats["uploaded_bytes"] == private[f],
                      f"multi-tenant {rnd}: {f} uploaded {r.stats['uploaded_bytes']} B, its"
                      f" private pages {private[f]} B")
        k1 = len(fns) * k1_cold if mode == "spice" else 0
        check(k["overlay_patch"] == k1,
              f"multi-tenant {rnd}: {k['overlay_patch']} K1 launches, expected {k1}")
        for name, n in per_request.items():
            check(k[name] == len(fns) * n,
                  f"multi-tenant {rnd}: {k[name]} {name} launches, expected {len(fns)} x {n}")
        clean(f"multi-tenant {rnd}")
        cache = images.snapshot_stats()
        row = {"round": rnd, "ttft_ms": {f: res[f].ttft_s * 1e3 for f in fns},
               "total_ms": {f: res[f].total_s * 1e3 for f in fns},
               "max_total_ms": max(r.total_s for r in res.values()) * 1e3, "wall_s": wall,
               "agg_read_gb_s": bw / 1e9, "demand_boosts": boosts,
               "device_image_cache": {key: cache[key] - cache0[key] for key in cache},
               "peak_gb": peak / 1e9, "launches": k}
        print("  multi-tenant " + json.dumps(row))
        if rnd == 1:
            print(f"  round 1 (device base built) peak {peak / 1e9:.3f} GB against the sequential"
                  f" cold start's {seq_peak / 1e9:.3f} GB: {(peak - seq_peak) / image_bytes:.3f}"
                  f" images more")
        if profiled:
            report_profile(prof, f"multi-tenant round {rnd}", wall * 1e3,
                           f"max total {row['max_total_ms']:.1f} ms")
        if mode == "spice":
            spice_max[rnd] = row["max_total_ms"]
        else:  # against the last round with the device base cached and no profiler
            ref_rnd = CONCURRENT_ROUNDS - 1
            print(f"  concurrency_multi/{len(fns)}/faasnap_vs_spice"
                  f" {row['max_total_ms'] / spice_max[ref_rnd]:.4f} (max total"
                  f" {row['max_total_ms']:.2f} ms against spice round {ref_rnd}'s"
                  f" {spice_max[ref_rnd]:.2f})")
        node.evict()
        if rnd == 1:
            # what round 1 left on the card is the cache's entries, each in
            # a block of its own (the allocator rounds a large one up to 2 MiB)
            got, came, gone = moved(empty, "after multi-tenant 1")
            entries = images.resident_entries()
            check(not gone and len(came) == entries
                  and 0 <= got - empty[0] - images.resident_bytes() < entries << 21,
                  f"after multi-tenant 1: {len(came)} blocks ({got - empty[0]} B) more on the"
                  f" card and {len(gone)} fewer; the device image cache holds {entries}"
                  f" entries ({images.resident_bytes()} B)")
            full = settle()
            print(f"  {full[0]} B allocated on the card with the device base cached:"
                  f" {entries} entries, {images.resident_bytes()} B")
        else:
            held(full, f"after multi-tenant {rnd}")
    print(f"  device image cache since the node was built {images.snapshot_stats()}")

    # B. burst
    cold0 = sched.stats["cold_starts"]
    before = counts(counters)
    rs = burst(node, "fn-ft-2", prompt, MAX_NEW, cfg, BURST)
    k = launched(before)
    owners = [r for r in rs if r.cold and not r.joined]
    riders = [r for r in rs if r.joined]
    check(len(owners) == 1 and len(riders) == BURST - 1,
          f"burst: {len(owners)} restores and {len(riders)} riders of {BURST} invocations")
    check(sched.stats["cold_starts"] == cold0 + 1,
          f"burst: {sched.stats['cold_starts'] - cold0} cold starts counted")
    check(owners[0].stats["bytes_read"] == seq.stats["bytes_read"],
          f"burst: the restore read {owners[0].stats['bytes_read']} B, a sequential cold start"
          f" {seq.stats['bytes_read']} B")
    for r in rs:
        tokens(r, "fn-ft-2", "burst")
    check(k["overlay_patch"] == k1_cold, f"burst: {k['overlay_patch']} K1 launches")
    for name, n in per_request.items():
        check(k[name] == BURST * n, f"burst: {k[name]} {name} launches, expected {BURST} x {n}")
    clean("burst")
    print("  burst " + json.dumps({
        "invocations": BURST, "max_total_ms": max(r.total_s for r in rs) * 1e3,
        "restore_ttft_ms": owners[0].ttft_s * 1e3,
        "rider_ttft_ms": [r.ttft_s * 1e3 for r in riders], "bytes_read": owners[0].stats["bytes_read"],
        "launches": k}))
    node.evict()
    held(full, "after the burst")

    # C. a cancel and deadlines with uploads in flight
    r = node.invoke("fn-ft", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(r.cold, "fn-ft before the cancel: expected a cold start")
    tokens(r, "fn-ft", "fn-ft before the cancel")
    kinds0, warm_level = node.memory.kind_bytes(), settle()
    slow_bw = seq.stats["bytes_read"] / RESTORE_S
    t0 = time.perf_counter()
    out = cancel_deadline(mod, node, cfg, prompt, MAX_NEW, "fn-ft", "fn-ft-3", "fn-ft-1", slow_bw)
    c_s = time.perf_counter() - t0
    check(out["accepted"] and out["doomed"] == "InvocationCancelled",
          f"cancel: accepted {out['accepted']}, fn-ft-3 ended {out['doomed']}")
    check(out["late"] == "DeadlineExceeded", f"deadline: the queued fn-ft-1 ended {out['late']}")
    tokens(out["warm"], "fn-ft", "warm beside the cancel")
    check(not out["warm"].cold and out["warm_first"], "warm fn-ft: not served warm during the restore")
    check(out["own_restoring"], "fn-ft-1: its deadline passed before its restore began")
    tokens(out["own"], "fn-ft-1", "fn-ft-1 past its deadline mid-restore")
    check(out["own"].cold and not out["own"].joined, "fn-ft-1: expected the restore's owner")
    for r in out["riders"]:
        tokens(r, "fn-ft-1", "fn-ft-1 rider")
        check(r.joined, "fn-ft-1: a rider did not join the restore")
    check(uploads.flush(WAIT_S), "cancel: uploads still pending")
    node.evict("fn-ft-1")
    kinds = node.memory.kind_bytes()
    check(all(kinds[key] == kinds0[key] for key in ("working_set", "residual")),
          f"cancel: ledger {kinds} after the regime, {kinds0} before")
    clean("cancel")
    held(warm_level, "after the cancel")
    print("  cancel and deadlines " + json.dumps({
        "seconds": c_s, "slow_read_bw": slow_bw, "accepted": out["accepted"],
        "fn-ft-3": out["doomed"], "queued fn-ft-1": out["late"],
        "warm fn-ft ttft_ms": out["warm"].ttft_s * 1e3,
        "fn-ft-1 past its deadline, total_ms": out["own"].total_s * 1e3,
        "riders max total_ms": max(r.total_s for r in out["riders"]) * 1e3,
        "ledger": {key: kinds[key] for key in ("working_set", "residual")}}))
    r = node.invoke("fn-ft-3", prompt, MAX_NEW, mode="spice", cfg=cfg)
    check(r.cold, "fn-ft-3 after its cancel: expected a cold start")
    tokens(r, "fn-ft-3", "fn-ft-3 after its cancel")
    clean("after the cancel")
    node.evict()
    held(full, "after the cancel and deadlines")

    # D. pressure on main_path's budget
    sched.memory_budget = BUDGET_IMAGES * image_bytes
    evictions0 = images.snapshot_stats()["evictions"]
    ends = []
    top = 0
    for _ in range(2):
        node.evict()
        handles = [node.submit(f, prompt, MAX_NEW, mode="spice", cfg=cfg) for f in fns]

        def done() -> bool:
            nonlocal top
            top = max(top, node.memory.held_bytes())
            return all(h.done() for h in handles)

        wait_until(done, "the pressure regime's invocations")
        for f, h in zip(fns, handles):
            o = outcome(mod, h)
            if not isinstance(o, str):
                tokens(o, f, "pressure")
            ends.append(o if isinstance(o, str) else "result")
        clean("pressure")
    node.evict()
    images.reclaim(images.resident_bytes())
    clean("pressure, device base reclaimed")
    hw = node.memory.high_water()
    print("  pressure " + json.dumps({
        "budget_images": BUDGET_IMAGES, "outcomes": ends,
        "held_max_sampled_images": top / image_bytes,
        "ledger_high_water_images_since_the_node": hw["total"] / image_bytes,
        "device_image_evictions": images.snapshot_stats()["evictions"] - evictions0}))
    held(empty, "after the pressure regime")
    launches = counts(counters)
    print(f"  concurrent path {time.perf_counter() - t_path:.1f} s; launches {launches}")
    return {"launches": launches, "k1_cold": k1_cold}


def qwen_node_phases(torch, np, counters, cfg, per_request, node, d, made, ref, prompt):
    """The phases after ``main_path`` on its qwen node: ``modes_path``,
    then ``concurrent_path``."""
    return {"modes": modes_path(torch, np, counters, cfg, "fn-ft", per_request, node, d, made,
                                ref, prompt),
            "concurrent": concurrent_path(torch, np, counters, cfg, per_request, node, d, made,
                                          ref, prompt)}


# twin, the needles tests/test_examples.py looks for in the reference's
# output, and the kernels its run on the card launches (the others launch
# nothing: every node of the examples installs eagerly, so K1 never runs)
EXAMPLES = (
    ("quickstart", ("COLD start",), ("flash_attention", "decode_attention")),
    ("overlay_finetunes", ("base-image cache",), ()),
    ("serve_coldstart", ("node cache",), ("flash_attention", "decode_attention", "ssd_scan")),
    ("train_ft", ("resuming from step", "canary", "instant rollback"),
     ("flash_attention", "decode_attention")),
)


def examples_path(torch, counters):
    """Each ``examples/torch_*.py`` loaded by path and its ``main()`` run in
    this process with the default device (the card); its output must hold
    the reference example's narrative.  Returns each twin's launch counts."""
    import importlib.util
    import io

    paths = {}
    for name, needles, kernels in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", os.path.join(ROOT, "examples", f"torch_{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        reset(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = counts(counters)
        print(f"  examples/torch_{name}.py: {wall_s:.1f} s, launches {launches}")
        for line in out.getvalue().splitlines():
            print(f"    | {line}")
        for n in needles:
            check(n in out.getvalue(), f"torch_{name}.py: missing narrative {n!r}")
        for k, n in launches.items():
            check(n > 0 if k in kernels else n == 0,
                  f"torch_{name}.py: {n} {k} launches, expected {'some' if k in kernels else 0}")
        paths[f"example {name}"] = launches
    return paths


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


def depth_cut(cfg, full, what: str) -> None:
    """Print a phase's depth cut with the widths it keeps."""
    print(f"  {cfg.name} cut to {cfg.n_layers} of {full.n_layers} layers ({what});"
          f" d_model {cfg.d_model}, heads {cfg.n_heads} / {cfg.n_kv_heads}, hd {cfg.hd},"
          f" d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")


def seeded_params(cfg, dev):
    """``cfg``'s weights from the seed, on the host, and their count: drawn
    on ``dev`` by a ``torch.Generator`` seeded with SEED, from
    ``lm.init_params``' distributions, and copied to the host.
    ``lm.init_params`` draws from numpy on the host, about 4 s a GB, which
    the full-width phases of 6-15 GB would spend minutes on."""
    import torch

    from repro_torch.interop import tree_leaves
    from repro_torch.models import lm
    from repro_torch.sharding.partition import map_specs

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)

    def draw(s):
        dt = s.dtype or torch.float32
        if s.init in ("zeros", "ones"):
            return torch.full(s.shape, float(s.init == "ones"), dtype=dt)
        a = torch.empty(s.shape, device=dev)
        if s.init == "log_uniform":
            a.uniform_(1.0, 16.0, generator=g).log_()
        else:
            fanin = s.init == "fanin" and len(s.shape) >= 2
            a.normal_(0.0, s.shape[-2] ** -0.5 if fanin else 0.02, generator=g)
        return a.to(dt).cpu()

    params = map_specs(lm.param_specs(cfg), draw)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"  {n} params, {n * 4 / 1e9:.3f} GB f32 (drawn on {dev} in"
          f" {time.perf_counter() - t0:.1f} s)")
    return params


def logits_against_cpu(np, cfg, got, want) -> None:
    """Greedy tokens of every step equal, and every step's logits within
    LOGITS_REL_TOL of their largest magnitude (random weights can repeat
    one token at every step, which the tokens alone would not notice)."""
    check(len(got) == len(want) == MAX_NEW, f"{cfg.name}: {len(got)} / {len(want)} steps"
                                            f" of logits recorded, not {MAX_NEW}")
    g_tok = np.stack([lg.argmax(-1).numpy() for lg in got], axis=1)
    w_tok = np.stack([lg.argmax(-1).numpy() for lg in want], axis=1)
    check(np.array_equal(g_tok, w_tok), f"{cfg.name}: tokens {g_tok.tolist()} != CPU path "
                                        f"{w_tok.tolist()}")
    errs = [(g - w).abs().max().item() / w.abs().max().item() for g, w in zip(got, want)]
    print(f"  tokens {g_tok.tolist()}, equal to the CPU path's; logits max |err| / max |logit|"
          f" by step: {', '.join(f'{e:.2e}' for e in errs)} (bound {LOGITS_REL_TOL:.0e})")
    check(max(errs) <= LOGITS_REL_TOL, f"{cfg.name}: logits differ from the CPU path")


def profiled(torch, label, fn, ranges=()):
    """``fn()`` once more under torch.profiler (CPU and CUDA), its device
    time reported by ``report_profile``; returns what ``fn`` returned."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, label, wall_ms, "the profiler's own cost included", ranges)
    return out


def generate_against_cpu(torch, np, dev, counters, cfg, ranges=(), tune=None):
    """``serve.engine.generate`` over a layerwise state of ``cfg``'s seed
    weights (``tune(params, cfg)`` of them when given), PROMPT_LEN tokens to
    MAX_NEW, on the CPU and then on the card: greedy tokens and every
    step's logits against the CPU path, then once more under the profiler
    (``ranges`` as ``report_profile`` takes them).  Returns the first card
    run's launch counts."""
    from repro_torch.serve.engine import generate, layerwise_state

    params = seeded_params(cfg, dev)
    state = layerwise_state(cfg, params if tune is None else tune(params, cfg))
    del params
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
          f" last prompt tokens {prompt[:, -1].tolist()}; launches {launches}")
    again, _ = profiled(torch, f"{cfg.name} generate", lambda: generate(
        cfg, None, state, prompt, MAX_NEW, device=dev), ranges)
    check(np.array_equal(got, want) and np.array_equal(again, want),
          f"{cfg.name}: tokens {got.tolist()} (profiled run {again.tolist()}) != CPU path "
          f"{want.tolist()}")
    logits_against_cpu(np, cfg, got_logits, want_logits)
    return launches


def gemma_path(torch, np, dev, counters):
    """gemma3-27b as the repo configures it (no head_dim, so hd = 5376 / 32
    = 168, which K2 and K3 run zero-padded to 192) at full width, its depth
    cut to one local layer (window 1024) and one global layer; random
    weights from the seed, through ``generate_against_cpu``.  Returns the
    path's launch counts."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(GEMMA_ARCH)
    local, glob = full.pattern[0], full.pattern[-1]
    cfg = dataclasses.replace(full, n_layers=2, pattern=(local, glob), pattern_reps=1,
                              remainder=())
    depth_cut(cfg, full, f"pattern=(LOCAL window {local.window}, GLOBAL), pattern_reps=1,"
                         f" remainder=(); no head_dim in the config")
    launches = generate_against_cpu(torch, np, dev, counters, cfg)
    check_attention_launches(cfg, launches)
    return launches


# ------------------------------------------------------------------- MoE
def moe_fine_tune(params, cfg):
    """Change one 64 KiB page of every layer's router and one of expert
    0's ``w_down``.  The router's page moves by a different amount in each
    expert's column (a constant over the experts would cancel in the
    softmax), so routing moves and a wrong patch shows in the tokens."""
    import torch

    moe = params["pattern"][0]["moe"]
    E = cfg.n_experts
    router = moe["router"].clone()  # (reps, d, E), f32
    router[:, :(64 << 10) // (E * 4), :] += 0.05 * torch.linspace(
        -1.0, 1.0, E, device=router.device)
    w_down = moe["w_down"].clone()  # (reps, E, d_ff, d)
    w_down[:, 0, :(64 << 10) // (cfg.d_model * 4), :] += 0.01
    layer = dict(params["pattern"][0], moe=dict(moe, router=router, w_down=w_down))
    return dict(params, pattern=(layer,))


@contextlib.contextmanager
def recorded_routes(into: list, n_tokens: int):
    """While the block runs, every MoE FFN call runs inside the profiler
    range ``MOE_RANGE``, and each one over ``n_tokens`` tokens (the
    smoke's prefill) appends (device type, expert indices, kept mask) to
    ``into``.  The tensors stay where they are: recording adds no
    synchronize to a request."""
    from torch.profiler import record_function

    from repro_torch.models import moe

    real_positions, real_ffn = moe._positions, moe.moe_ffn

    def positions(idx, E, C):
        out = real_positions(idx, E, C)
        if idx.shape[0] == n_tokens:
            into.append((idx.device.type, idx, out[2]))
        return out

    def moe_ffn(*args, **kwargs):
        with record_function(MOE_RANGE):
            return real_ffn(*args, **kwargs)

    moe._positions, moe.moe_ffn = positions, moe_ffn
    try:
        yield into
    finally:
        moe._positions, moe.moe_ffn = real_positions, real_ffn


def moe_path(torch, np, dev, counters):
    """olmoe-1b-7b at full width (d_model 2048, 16 heads of 128, 64 experts
    of width 1024, top-8, capacity factor 1.25, vocab 50,304), its depth
    cut to 2 of 16 layers, through ``main_path``: publish ``fn-moe-base``
    and ``fn-moe-ft`` (``moe_fine_tune``) against a base image, Spice
    restores with the fused install (K1), prefill through K2 and decode
    through K3 at hd 128.  The prefill's routing in each layer (expert
    indices and the pairs kept within capacity) must be equal on the card
    and on the CPU path, for every request.  Returns the path's launch
    counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity

    t_phase = time.perf_counter()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, pattern_reps=2)
    T = BATCH * PROMPT_LEN
    check((cfg.n_heads, cfg.n_kv_heads, cfg.hd) == MOE_HEADS,
          f"{cfg.name}: heads {(cfg.n_heads, cfg.n_kv_heads, cfg.hd)} are not the MOE_HEADS"
          f" that K2 and K3 were checked at")
    print(f"  {cfg.name} cut to 2 of {full.n_layers} layers: pattern_reps 2 (of"
          f" {full.pattern_reps}); d_model {cfg.d_model}, heads {cfg.n_heads} / {cfg.n_kv_heads},"
          f" hd {cfg.hd}; {cfg.n_experts} experts of width {cfg.d_ff}, top-{cfg.top_k},"
          f" capacity factor {cfg.capacity_factor}: capacity {capacity(cfg, T)} at the"
          f" prefill's {T} tokens, {capacity(cfg, BATCH)} at decode's {BATCH}")
    fns = {"fn-moe-base": lambda p, c: p, "fn-moe-ft": moe_fine_tune}
    per_request = {"flash_attention": cfg.n_layers,
                   "decode_attention": cfg.n_layers * (MAX_NEW - 1)}
    with recorded_routes([], T) as routes:
        launches = main_path(torch, np, dev, counters, cfg, "moe-base", fns, per_request,
                             ranges=(MOE_RANGE,))["launches"]
    # the CPU references ran first, function by function; then every
    # request of the plan, and the profiled cold start of the last function
    L = cfg.n_layers
    cpu = [r for r in routes if r[0] == "cpu"]
    card = [r for r in routes if r[0] != "cpu"]
    names = list(fns)
    served = [f for f, _ in request_plan(names)] + [names[-1]]
    check(len(cpu) == L * len(names) and len(card) == L * len(served),
          f"{cfg.name}: {len(cpu)} CPU and {len(card)} card prefill routings recorded")
    want = {f: cpu[i * L:(i + 1) * L] for i, f in enumerate(names)}

    def dropped(rows):
        return [int((~keep).sum()) for _, _, keep in rows]

    print(f"  prefill's dropped pairs by layer (of {T * cfg.top_k} a layer), CPU path: "
          + ", ".join(f"{f} {dropped(want[f])}" for f in names))
    for i, f in enumerate(served):
        got = card[i * L:(i + 1) * L]
        print(f"  request {i} {f}, card: dropped {dropped(got)}")
        for layer, ((_, gi, gk), (_, wi, wk)) in enumerate(zip(got, want[f])):
            gi, gk = gi.cpu(), gk.cpu()
            check(torch.equal(gi, wi), f"{f} request {i} layer {layer}: expert indices differ"
                                       f" from the CPU path at {int((gi != wi).sum())} pairs")
            check(torch.equal(gk, wk), f"{f} request {i} layer {layer}: kept pairs differ"
                                       f" from the CPU path")
    if not torch.equal(want[names[0]][0][1], want[names[1]][0][1]):
        print("  the fine-tune's router moved the prefill's routing in layer 0")
    print(f"  {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------- frontends and hybrid
def stacked_generate(torch, cfg, params, batch, seq: int, decode_input, where):
    """``lm.prefill`` over ``batch`` (``seq`` positions), then MAX_NEW - 1
    ``lm.decode_step`` calls, each on ``decode_input(step, logits)``, in f32
    on ``where``.  Returns each step's last-position logits on the host and
    the seconds to the first of them and to the last."""
    from repro_torch.models import lm

    f32 = torch.float32

    def on(b):
        return {k: torch.as_tensor(v).to(where) for k, v in b.items()}

    t0 = time.perf_counter()
    lg, caches, _ = lm.prefill(cfg, params, on(batch), compute_dtype=f32)
    logits = [lg[:, -1].float().cpu()]
    first = time.perf_counter() - t0
    for step in range(MAX_NEW - 1):
        lg, caches, _ = lm.decode_step(cfg, params, on(decode_input(step, logits[-1])), caches,
                                       seq + step, compute_dtype=f32)
        logits.append(lg[:, -1].float().cpu())
    return logits, first, time.perf_counter() - t0


def stacked_path(torch, np, dev, counters, cfg, batch, seq, decode_input):
    """``stacked_generate`` on the CPU, then on the card over a copy of the
    same weights: tokens and logits against the CPU, one K2 launch a layer
    in the prefill and one K3 a layer at each decode step.  Returns the
    card run's launch counts."""
    from repro_torch.interop import tree_map

    params = seeded_params(cfg, dev)
    torch.exp(torch.full((1 << 15,), -0.3))  # see main_path
    t0 = time.perf_counter()
    want, _, _ = stacked_generate(torch, cfg, params, batch, seq, decode_input, "cpu")
    print(f"  CPU reference in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_card = tree_map(lambda t: t.to(dev), params)
    torch.cuda.synchronize()
    print(f"  weights to the card in {time.perf_counter() - t0:.1f} s")
    reset(counters)
    got, first, total = stacked_generate(torch, cfg, on_card, batch, seq, decode_input, dev)
    launches = counts(counters)
    print(f"  on the card: lm.prefill to its logits on the host {first * 1e3:.1f} ms, with"
          f" {MAX_NEW - 1} lm.decode_step {total * 1e3:.1f} ms; launches {launches}")
    again, _, _ = profiled(torch, f"{cfg.name} lm.prefill + decode_step", lambda: (
        stacked_generate(torch, cfg, on_card, batch, seq, decode_input, dev)))
    check([a.argmax(-1).tolist() for a in again] == [g.argmax(-1).tolist() for g in got],
          f"{cfg.name}: the profiled run's tokens differ from the first run's")
    del on_card
    torch.cuda.empty_cache()
    logits_against_cpu(np, cfg, got, want)
    check_attention_launches(cfg, launches)
    return launches


def vl_path(torch, np, dev, counters):
    """qwen2-vl-7b at full width (d_model 3584, 28 / 4 heads of 128, d_ff
    18,944, untied vocab 152,064, qkv bias), its depth cut to 2 of 28
    layers, through the stacked serving entry points: ``lm.prefill`` over
    batch 2 x VL_SEQ positions, the first ``frontend_tokens`` (256, a 16 x
    16 grid) overlaid with seeded patch embeddings and every position
    rotated by M-RoPE's (3, B, S) t/h/w streams, then 7 ``lm.decode_step``
    calls on greedy tokens (M-RoPE over (B, 1) positions).  Returns the
    card run's launch counts."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.models.frontends import make_patch_embeds, mrope_positions

    t_phase = time.perf_counter()
    full = get_config(VL_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, pattern_reps=2)
    n_patch = cfg.frontend_tokens
    grid = math.isqrt(n_patch)
    seq = n_patch + VL_TEXT
    check(grid * grid == n_patch, f"{cfg.name}: {n_patch} patches are no square grid")
    check((cfg.n_heads, cfg.n_kv_heads, cfg.hd) == VL_HEADS and seq == VL_SEQ,
          f"{cfg.name}: heads {(cfg.n_heads, cfg.n_kv_heads, cfg.hd)}, {seq} positions are not"
          f" the VL_HEADS and VL_SEQ that K2 and K3 were checked at")
    depth_cut(cfg, full, f"pattern_reps 2 of {full.pattern_reps}; qkv bias, M-RoPE,"
                         f" {n_patch} patches on a {grid} x {grid} grid + {VL_TEXT} text tokens")
    gen = torch.Generator().manual_seed(SEED)
    batch = {
        "tokens": np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (BATCH, seq)).astype(np.int32),
        "patch_embeds": make_patch_embeds(gen, BATCH, n_patch, cfg.d_model,
                                          dtype=torch.float32, device="cpu"),
        "positions": mrope_positions(BATCH, seq, n_patch, grid=grid),
    }

    def next_tokens(step, logits):
        return {"tokens": logits.argmax(-1).to(torch.int32)[:, None]}

    launches = stacked_path(torch, np, dev, counters, cfg, batch, seq, next_tokens)
    print(f"  {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def audio_path(torch, np, dev, counters):
    """musicgen-large at full width (d_model 2048, 32 / 32 heads of 64,
    d_ff 8192, vocab 2048), its depth cut to 2 of 48 layers, through the
    stacked serving entry points with the audio frontend: ``lm.prefill``
    over seeded frame embeddings (B, PROMPT_LEN, d) in place of the token
    embedding, then 7 ``lm.decode_step`` calls, each on a seeded (B, 1, d)
    frame.  Returns the card run's launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.frontends import make_frame_embeds

    t_phase = time.perf_counter()
    full = get_config(AUDIO_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, pattern_reps=2)
    check((cfg.n_heads, cfg.n_kv_heads, cfg.hd) == AUDIO_HEADS,
          f"{cfg.name}: heads {(cfg.n_heads, cfg.n_kv_heads, cfg.hd)} are not the AUDIO_HEADS"
          f" that K2 and K3 were checked at")
    depth_cut(cfg, full, f"pattern_reps 2 of {full.pattern_reps}; frame embeddings in")
    gen = torch.Generator().manual_seed(SEED)
    batch = {"frame_embeds": make_frame_embeds(gen, BATCH, PROMPT_LEN, cfg.d_model,
                                               dtype=torch.float32, device="cpu")}
    frames = [make_frame_embeds(gen, BATCH, 1, cfg.d_model, dtype=torch.float32, device="cpu")
              for _ in range(MAX_NEW - 1)]

    def next_frame(step, logits):
        return {"frame_embeds": frames[step]}

    launches = stacked_path(torch, np, dev, counters, cfg, batch, PROMPT_LEN, next_frame)
    print(f"  {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def hybrid_path(torch, np, dev, counters):
    """jamba-v0.1-52b at full width, its depth cut to block positions 3 and
    4: a Mamba2 layer (d_inner 8192, 128 SSM heads of 64, state 16, one
    group) with the MoE FFN (16 experts of 14,336, top-2), then attention
    (32 / 8 heads of 128) with the dense FFN; random weights from the seed,
    through ``generate_against_cpu``.  The prefill's expert indices and
    kept pairs must be equal on the card (both runs) and on the CPU path;
    one K4 and one K2 launch in the prefill and one K3 at each decode step.
    No publish and restore: two publishes of a 14.7 GB image would add
    minutes, and K1 is checked on four other paths.  Returns the card
    run's launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity

    t_phase = time.perf_counter()
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, pattern=full.pattern[3:5], pattern_reps=1,
                              remainder=())
    T = BATCH * PROMPT_LEN
    check([(s.kind, s.moe) for s in cfg.pattern] == [("mamba", True), ("attn", False)],
          f"{cfg.name}: block positions 3 and 4 are {cfg.pattern}")
    check((cfg.n_heads, cfg.n_kv_heads, cfg.hd) == HYBRID_HEADS
          and (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state) == HYBRID_SSM,
          f"{cfg.name}: heads {(cfg.n_heads, cfg.n_kv_heads, cfg.hd)}, SSM"
          f" {(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)} are not the HYBRID_HEADS and"
          f" HYBRID_SSM that K2-K4 were checked at")
    depth_cut(cfg, full, f"pattern=full.pattern[3:5] (Mamba2 + MoE, attention + dense FFN),"
                         f" pattern_reps=1, remainder=(); d_inner {cfg.d_inner}, SSM heads"
                         f" {cfg.ssm_heads} of {cfg.ssm_head_dim}, state {cfg.ssm_state};"
                         f" {cfg.n_experts} experts, top-{cfg.top_k}, capacity {capacity(cfg, T)}"
                         f" at the prefill's {T} tokens")
    with recorded_routes([], T) as routes:
        launches = generate_against_cpu(torch, np, dev, counters, cfg, ranges=(MOE_RANGE,))
    card = torch.device(dev).type
    check([r[0] for r in routes] == ["cpu", card, card],
          f"{cfg.name}: prefill routings recorded on {[r[0] for r in routes]}")
    (_, wi, wk), *on_card = routes
    for run, (_, gi, gk) in zip(("first", "profiled"), on_card):
        gi, gk = gi.cpu(), gk.cpu()
        print(f"  prefill's routing, {run} run: {int((~gk).sum())} of {T * cfg.top_k} pairs"
              f" dropped on the card, {int((~wk).sum())} on the CPU path")
        check(torch.equal(gi, wi), f"{cfg.name}: expert indices differ from the CPU path at"
                                   f" {int((gi != wi).sum())} pairs")
        check(torch.equal(gk, wk), f"{cfg.name}: kept pairs differ from the CPU path")
    check(launches["ssd_scan"] == 1 and launches["flash_attention"] == 1
          and launches["decode_attention"] == MAX_NEW - 1, f"{cfg.name}: launches {launches}")
    print(f"  {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------- the last three configurations
def cut_to(arch: str, heads, layers: int = 2):
    """``arch`` at full width, its depth cut to ``layers`` layers of its
    one-layer pattern, with its heads checked against ``heads``, the (H,
    kvH, hd) that K2 and K3 were checked and timed at."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers, pattern_reps=layers)
    check((cfg.n_heads, cfg.n_kv_heads, cfg.hd) == heads,
          f"{cfg.name}: heads {(cfg.n_heads, cfg.n_kv_heads, cfg.hd)} are not the {heads}"
          f" that K2 and K3 were checked at")
    return full, cfg


def check_attention_launches(cfg, launches) -> None:
    """One K2 launch a layer in the prefill, one K3 a layer at each decode step."""
    check(launches["flash_attention"] == cfg.n_layers
          and launches["decode_attention"] == cfg.n_layers * (MAX_NEW - 1),
          f"{cfg.name}: launches {launches}")


def coder_path(torch, np, dev, counters):
    """starcoder2-7b at full width (d_model 4608, 36 / 4 heads of 128, so G
    9 and K3's 16-head instance; d_ff 18,432, untied vocab 49,152), its
    depth cut to 2 of 32 layers, through ``main_path``: publish
    ``fn-coder-base`` and ``fn-coder-ft`` (``fine_tune``) against a base
    image, Spice restores with the fused install (K1), prefill through K2
    and decode through K3; every request's tokens equal to the CPU path's.
    Returns the path's launch counts."""
    t_phase = time.perf_counter()
    full, cfg = cut_to(CODER_ARCH, CODER_HEADS)
    depth_cut(cfg, full, f"pattern_reps 2 of {full.pattern_reps}; G"
                         f" {cfg.n_heads // cfg.n_kv_heads}, untied unembedding")
    fns = {"fn-coder-base": lambda p, c: p, "fn-coder-ft": fine_tune}
    per_request = {"flash_attention": cfg.n_layers,
                   "decode_attention": cfg.n_layers * (MAX_NEW - 1)}
    launches = main_path(torch, np, dev, counters, cfg, "coder-base", fns, per_request)["launches"]
    print(f"  {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def qk_norm_off_one(params, cfg):
    """Every layer's ``q_norm`` and ``k_norm`` drawn as 1 + N(0,
    QK_NORM_SPREAD) from the seed, so that the norms' weights act (they are
    initialized to 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 7)
    attn = dict(params["pattern"][0]["attn"])
    for key in ("q_norm", "k_norm"):
        w = 1.0 + QK_NORM_SPREAD * rng.standard_normal(tuple(attn[key].shape))
        attn[key] = torch.as_tensor(w, dtype=attn[key].dtype, device=attn[key].device)
        print(f"  {key} {tuple(attn[key].shape)} drawn in [{w.min():.3f}, {w.max():.3f}]")
    layer = dict(params["pattern"][0], attn=attn)
    return dict(params, pattern=(layer,))


def qk_norm_path(torch, np, dev, counters):
    """qwen3-32b at full width (d_model 5120, 64 / 8 heads of 128: G 8 and
    H * hd 8192 != d_model; qk-norm, RoPE theta 1e6, d_ff 25,600, untied
    vocab 151,936), its depth cut to 2 of 64 layers, every layer's
    ``q_norm`` and ``k_norm`` moved off 1 (``qk_norm_off_one``), through
    ``generate_against_cpu``.  No publish and restore: two publishes of a
    10.1 GB image would add minutes, and K1 runs on five other paths.
    Returns the card run's launch counts."""
    t_phase = time.perf_counter()
    full, cfg = cut_to(QWEN3_ARCH, QWEN3_HEADS)
    check(cfg.qk_norm and cfg.n_heads * cfg.hd != cfg.d_model,
          f"{cfg.name}: qk_norm {cfg.qk_norm}, H * hd {cfg.n_heads * cfg.hd}")
    depth_cut(cfg, full, f"pattern_reps 2 of {full.pattern_reps}; qk-norm, H * hd"
                         f" {cfg.n_heads * cfg.hd}, RoPE theta {cfg.rope_theta:g}")
    launches = generate_against_cpu(torch, np, dev, counters, cfg, tune=qk_norm_off_one)
    check_attention_launches(cfg, launches)
    print(f"  {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phi_path(torch, np, dev, counters):
    """phi3.5-moe-42b at full width (d_model 4096, 32 / 8 heads of 128, 16
    experts of width 6,400, top-2, vocab 32,064), its depth cut to 2 of 32
    layers, through ``generate_against_cpu`` with its MoE FFN calls in the
    ``MOE_RANGE`` profiler range.  Every layer's prefill routing (expert
    indices and kept pairs) must be equal on the card, in both runs, and
    on the CPU path.  No publish and restore (11.5 GB), as for qwen3-32b.
    Returns the card run's launch counts."""
    from repro_torch.models.moe import capacity

    t_phase = time.perf_counter()
    full, cfg = cut_to(PHI_ARCH, HYBRID_HEADS)
    T = BATCH * PROMPT_LEN
    L = cfg.n_layers
    check(all(s.moe for s in cfg.pattern), f"{cfg.name}: pattern {cfg.pattern}")
    depth_cut(cfg, full, f"pattern_reps 2 of {full.pattern_reps}; {cfg.n_experts} experts,"
                         f" top-{cfg.top_k}, capacity {capacity(cfg, T)} at the prefill's"
                         f" {T} tokens")
    with recorded_routes([], T) as routes:
        launches = generate_against_cpu(torch, np, dev, counters, cfg, ranges=(MOE_RANGE,))
    card = torch.device(dev).type
    check([r[0] for r in routes] == ["cpu"] * L + [card] * 2 * L,
          f"{cfg.name}: prefill routings recorded on {[r[0] for r in routes]}")
    want = routes[:L]
    for run, got in (("first", routes[L:2 * L]), ("profiled", routes[2 * L:])):
        for layer, ((_, gi, gk), (_, wi, wk)) in enumerate(zip(got, want)):
            gi, gk = gi.cpu(), gk.cpu()
            print(f"  prefill's routing, {run} run, layer {layer}: {int((~gk).sum())} of"
                  f" {T * cfg.top_k} pairs dropped on the card, {int((~wk).sum())} on the CPU")
            check(torch.equal(gi, wi), f"{cfg.name} {run} run layer {layer}: expert indices"
                                       f" differ from the CPU path at {int((gi != wi).sum())}"
                                       f" pairs")
            check(torch.equal(gk, wk), f"{cfg.name} {run} run layer {layer}: kept pairs"
                                       f" differ from the CPU path")
    check_attention_launches(cfg, launches)
    print(f"  {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def granite_path(torch, np, dev, counters):
    """granite-4.0-h-small as the benchmark runs it (``granite_config``),
    at full width, its depth cut to layers 4 and 5 of its 10 (a Mamba-2
    layer, then NoPE attention, each with the dropless MoE of 9 held of
    72 experts and the shared expert), through ``generate_against_cpu``:
    the card runs K5 where the CPU path runs its plain version, so the
    tokens and every step's logits hold K5 on the main path.  One K5
    launch a layer at the prefill and at each decode step, one K4 and one
    K2 in the prefill, one K3 a decode step.  Returns the card run's
    launch counts."""
    import dataclasses

    t_phase = time.perf_counter()
    full = granite_config()
    cfg = dataclasses.replace(full, n_layers=2, pattern=full.pattern[4:6], pattern_reps=1)
    check([(s.kind, s.moe) for s in cfg.pattern] == [("mamba", True), ("attn", True)],
          f"{cfg.name}: layers 4 and 5 are {cfg.pattern}")
    depth_cut(cfg, full, f"pattern=full.pattern[4:6] (Mamba-2, attention, each with the"
                         f" dropless MoE); {cfg.n_experts} of {cfg.routed_experts} experts held,"
                         f" top-{cfg.top_k}, shared expert {cfg.shared_ff}")
    launches = generate_against_cpu(torch, np, dev, counters, cfg)
    check(launches["moe_experts"] == cfg.n_layers * MAX_NEW and launches["ssd_scan"] == 1
          and launches["flash_attention"] == 1 and launches["decode_attention"] == MAX_NEW - 1,
          f"{cfg.name}: launches {launches}")
    print(f"  {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------- training
TRAIN_SEQ, TRAIN_BATCH = 64, 8  # SyntheticLM: tokens per step 512
# the train phase's depth: 8 of qwen1.5-0.5b's 24 layers keep its four
# checkpoint saves (3.10 GB each, 5.57 at full depth) and the whole script
# near half its time limit
TRAIN_LAYERS = 8
LONG_SEQ, LONG_MICROBATCHES = 2048, 4  # a fine-tune's step: 16,384 tokens
TRAIN_REL_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "m": 1e-4}  # card against CPU, f32
RESTART_TOL = 2e-5  # tests/test_ft.py::test_restart_equivalence


def step_against_cpu(torch, np, dev, cfg, data):
    """One f32 train step of ``cfg`` at full width, depth cut to 2 layers,
    from the seed's weights, on the card and on the CPU path: the loss, the
    global gradient norm and every leaf of AdamW's first moment (0.1 x the
    clipped gradient) must agree."""
    import dataclasses

    from repro_torch.core.treeutil import flatten_state
    from repro_torch.train.steps import TrainStepConfig, init_train_state, make_train_step

    cut = dataclasses.replace(cfg, n_layers=2, pattern_reps=2)
    tc = TrainStepConfig(remat="dots", compute_dtype="float32", num_microbatches=2)
    out = []
    for where in (dev, torch.device("cpu")):
        params, opt = init_train_state(cut, SEED, device=where)
        batch = {k: torch.as_tensor(v, device=where) for k, v in data.batch_at(0).items()}
        t0 = time.perf_counter()
        _, opt, m = make_train_step(cut, tc)(params, opt, batch)
        loss = float(m["loss"])
        out.append((loss, float(m["grad_norm"]), opt["m"], time.perf_counter() - t0))
    (lg, ng, mg, sg), (lc, nc, mc, sc) = out
    rel = {"loss": abs(lg - lc) / abs(lc), "grad_norm": abs(ng - nc) / abs(nc), "m": 0.0}
    for (name, a), (_, b) in zip(flatten_state(mg)[0], flatten_state(mc)[0]):
        rel["m"] = max(rel["m"], (a.cpu() - b).abs().max().item() / b.abs().max().item())
    print(f"  one f32 step, 2 of {cfg.n_layers} layers: loss {lg:.6f} (CPU {lc:.6f}),"
          f" grad_norm {ng:.6f} (CPU {nc:.6f}); card {sg:.2f} s, CPU {sc:.2f} s (first calls);"
          f" rel errors {json.dumps(rel)} (bounds {json.dumps(TRAIN_REL_TOL)})")
    for k, bound_ in TRAIN_REL_TOL.items():
        check(rel[k] <= bound_, f"train step: {k} differs from the CPU path by {rel[k]:.2e}")


def profile_train_step(torch, cfg, tcfg, params, opt, batch, label="train step"):
    """One more train step under torch.profiler: wall time, the device's
    busy share of it, the device's events, and the ten that take most of
    its time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.steps import make_train_step

    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"  profiled {label}: {sum(e.count for e in host if e.key.startswith('aten::'))}"
          f" aten calls on the host; most self time:")
    for e in host[:5]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:80]}")
    events = device_events(prof)
    if not events:
        print(f"  profiled {label}: the profiler saw no device time (not measured)")
        return
    busy_ms = sum(event_device_us(e) for e in events) / 1e3
    print(f"  profiled {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms ="
          f" {100 * busy_ms / wall_ms:.1f}%, {sum(e.count for e in events)} device events")
    for e in sorted(events, key=event_device_us, reverse=True)[:10]:
        print(f"    {event_device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:80]}")


def long_train_steps(torch, dev, cfg, tcfg, params, opt):
    """Train steps at a fine-tune's size, LONG_SEQ tokens a sequence in
    LONG_MICROBATCHES microbatches of the same global batch: one to warm
    up, two timed by CUDA events, one under the profiler.  The steps start
    from ``params`` each time and their results are dropped."""
    import dataclasses

    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.train.steps import make_train_step

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=LONG_SEQ,
                                  global_batch=TRAIN_BATCH))
    tc = dataclasses.replace(tcfg, num_microbatches=LONG_MICROBATCHES)
    step = make_train_step(cfg, tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for i in range(3):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch_at(i).items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        if i:
            ms.append(start.elapsed_time(end))
    tokens = TRAIN_BATCH * LONG_SEQ
    print(f"  {cfg.name} at a fine-tune's size ({TRAIN_BATCH} x {LONG_SEQ} tokens a step,"
          f" {LONG_MICROBATCHES} microbatches, remat {tc.remat}, {tc.compute_dtype}): step ms"
          f" after the first {', '.join(f'{t:.2f}' for t in ms)} ="
          f" {tokens / (sum(ms) / len(ms)) * 1e3:.0f} tokens/s; peak device memory"
          f" {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    profile_train_step(torch, cfg, tc, params, opt, batch,
                       label=f"train step at {TRAIN_BATCH} x {LONG_SEQ}")


class StepClock:
    """``train_loop``'s ``on_step`` hook: a CUDA event at the end of every
    step (the loop has synchronized there, reading the loss), so the
    intervals between them time the steps after the first."""

    def __init__(self, torch):
        self.torch, self.events, self.losses = torch, [], []

    def __call__(self, step, m):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        self.losses.append(m["loss"])

    def step_ms(self):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def timed(fn, into: list):
    """``fn``, appending each call's seconds to ``into``."""

    def call(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            into.append(time.perf_counter() - t0)

    return call


def stacked_serving_against_cpu(torch, np, dev, cfg, params, counters, prompt):
    """``lm.prefill`` and two ``lm.decode_step`` calls (the stacked
    forward's serving modes: K2, then K3) at f32 on the card against the
    CPU path on the same trained weights, logits to LOGITS_REL_TOL."""
    from repro_torch.interop import tree_map
    from repro_torch.models import lm

    host = tree_map(lambda t: t.cpu(), params)
    f32 = torch.float32
    logits = []
    before = counts(counters)
    for where, p in ((dev, params), ("cpu", host)):
        toks = torch.as_tensor(prompt, device=where)
        lg, c, _ = lm.prefill(cfg, p, {"tokens": toks}, compute_dtype=f32)
        seq = [lg[:, -1].float().cpu()]
        for pos in range(prompt.shape[1], prompt.shape[1] + 2):
            toks = torch.as_tensor(seq[-1].argmax(-1).to(torch.int32)[:, None], device=where)
            lg, c, _ = lm.decode_step(cfg, p, {"tokens": toks}, c, pos, compute_dtype=f32)
            seq.append(lg[:, -1].float().cpu())
        logits.append(seq)
    made = {k: counts(counters)[k] - before[k] for k in before}
    errs = [(g - w).abs().max().item() / w.abs().max().item() for g, w in zip(*logits)]
    print(f"  lm.prefill + 2 lm.decode_step, f32: logits max |err| / max |logit| "
          f"{', '.join(f'{e:.2e}' for e in errs)} (bound {LOGITS_REL_TOL:.0e}); launches {made}")
    check(max(errs) <= LOGITS_REL_TOL, "lm.prefill / decode_step: logits differ from the CPU")
    check(made["flash_attention"] == cfg.n_layers and made["decode_attention"] == 2 * cfg.n_layers,
          f"lm.prefill / decode_step: launches {made}")


def served_leaf(node, fname, key):
    """The ``key`` leaf of the tree ``node`` serves ``fname`` from, on the
    host (a restore handle's leaf once it has landed)."""
    from repro_torch.core.restore import TensorHandle
    from repro_torch.interop import to_host

    inst = node.instance(fname)
    with inst.cond:
        leaf = inst.tree[key]
    return to_host(leaf.wait() if isinstance(leaf, TensorHandle) else leaf)


def train_path(torch, np, dev, counters, cfg):
    """``examples/train_ft.py`` on the card at ``cfg``'s width and depth
    (qwen1.5-0.5b, TRAIN_LAYERS deep): (1) one f32 step against the CPU
    path (2 layers);
    (2) 6 steps straight, then the same 6 with a crash at step 4 and a
    resume from the step-2 JIF checkpoint, whose final params must equal
    the straight run's, with steps at a fine-tune's size (8 x 2048 tokens)
    timed and profiled between them; (3) the trained params published as
    ``assistant``, a 1-step fine-tune whose checkpoint is
    delta-published as a canary (its ``final_norm`` grafted onto the base),
    6 requests through the router, each served tree's ``final_norm`` equal
    to its own version's and the two versions' unequal, the gate, a
    rollback, GC and the CAS audit.  Returns the
    path's launch counts and a host copy of the params the resume restored
    from the JIF."""
    from repro_torch.core import BufferPool, ChunkStore, SpiceRestorer
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.ft.manager import CheckpointManager
    from repro_torch.ft.publish import DeltaPublishCallback
    from repro_torch.interop import to_host, tree_leaves, tree_map
    from repro_torch.serve.engine import (
        ClusterRouter,
        FixedTTLPolicy,
        FunctionCatalog,
        NodeScheduler,
        RolloutController,
        TokenHealthGate,
        generate,
    )
    from repro_torch.train.loop import LoopConfig, SimulatedFailure, train_loop
    from repro_torch.train.steps import TrainStepConfig

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    torch.exp(torch.full((1 << 15,), -0.3))  # see main_path
    step_against_cpu(torch, np, dev, cfg, data)

    reset(counters)
    tcfg = TrainStepConfig(remat="dots", num_microbatches=2)  # bf16, the reference's default
    clock = StepClock(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    straight = train_loop(cfg, tcfg, LoopConfig(steps=6, ckpt_every=3), data, on_step=clock,
                          device=dev)
    ms = sorted(clock.step_ms())
    med = ms[len(ms) // 2]
    n_params = sum(t.numel() for t in tree_leaves(straight["params"]))
    print(f"  {cfg.name} at full width ({cfg.n_layers} layers, {n_params} params,"
          f" remat dots, bf16 compute, 2 microbatches of {TRAIN_BATCH // 2} x {TRAIN_SEQ}):"
          f" step ms after the first {', '.join(f'{t:.2f}' for t in clock.step_ms())};"
          f" median {med:.2f} ms = {TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} tokens/s;"
          f" losses {', '.join(f'{v:.4f}' for v in clock.losses)}; peak device memory"
          f" {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch_at(6).items()}
    profile_train_step(torch, cfg, tcfg, straight["params"], straight["opt"], batch,
                       label=f"train step at {TRAIN_BATCH} x {TRAIN_SEQ}")
    long_train_steps(torch, dev, cfg, tcfg, straight["params"], straight["opt"])
    d = tempfile.mkdtemp(prefix="chip-smoke-train-")
    router = None
    try:
        mgr = CheckpointManager(f"{d}/ckpt", keep=2)
        try:
            train_loop(cfg, tcfg, LoopConfig(steps=6, ckpt_every=3, fail_at_step=4), data, mgr,
                       device=dev)
            fail("train: the injected failure did not happen")
        except SimulatedFailure as e:
            print(f"  crash: {e}")
        mgr.wait()
        restore_s, restored = [], {}

        def keep(restore):
            def call(*a, **kw):  # a host copy of the restored params (the elastic phase's)
                state, step = restore(*a, **kw)
                restored["params"] = tree_map(lambda x: to_host(x).copy(), state["params"])
                return state, step
            return call

        mgr.restore = timed(keep(mgr.restore), restore_s)
        resumed_from = mgr.latest_step()
        # the resumed run saves no checkpoint: its params are held to the
        # straight run's, and the script's time goes to the saves it checks
        out = train_loop(cfg, tcfg, LoopConfig(steps=6, ckpt_every=7), data, mgr, device=dev)
        for h in mgr.history:
            print(f"  checkpoint step {h['step']}: {'anchor' if h['anchor'] else 'delta'},"
                  f" save_s {h['save_s']:.3f}, bytes_written {h['bytes_written']}"
                  f" of {h['total_bytes']}")
        # matched by name: restored dicts list their keys sorted
        diff = max(tree_leaves(tree_map(lambda a, b: (a - b).abs().max().item(),
                                        out["params"], straight["params"])))
        err = max(tree_leaves(tree_map(
            lambda a, b: ((a - b).abs() - RESTART_TOL * b.abs()).max().item(),
            out["params"], straight["params"])))
        print(f"  resume from step {resumed_from}: restore {restore_s[0]:.3f} s, then"
              f" {len(out['losses'])} steps; final params against the straight run: max"
              f" |diff| {diff:.3e}, max |diff| - rtol |want| = {err:.3e} (atol"
              f" {RESTART_TOL:.0e})")
        check(resumed_from == 2 and len(restore_s) == 1, "train: the resume did not restore")
        check(err <= RESTART_TOL, "train: resumed params differ from the straight run")
        del straight, mgr

        # train -> serve: the trained params become a function; a fine-tune
        # streams its checkpoints into canary versions of it
        stacked_serving_against_cpu(torch, np, dev, cfg, out["params"], counters, prompt)
        image_bytes = sum(t.nbytes for t in tree_leaves(out["params"]))
        budget = 6 * image_bytes
        store = ChunkStore(f"{d}/cas")
        catalog = FunctionCatalog(chunk_store=store, device=dev)
        t0 = time.perf_counter()
        catalog.publish("assistant", cfg, out["params"], d, warm_ttl_s=3600.0, formats=("jif",))
        print(f"  publish assistant (v1): {time.perf_counter() - t0:.2f} s")
        node = NodeScheduler(registry=catalog.registry, keepalive=FixedTTLPolicy(3600.0),
                             install="fused", pool=BufferPool(capacity_bytes=budget // 4),
                             memory_budget_bytes=budget, device=dev)
        router = ClusterRouter(catalog, [node])
        deploy = RolloutController(catalog, seed=SEED, dirpath=d).attach(router)
        base_params = dict(out["params"])

        def merge(state):
            # serve the base with the fine-tune's final norm grafted on: the
            # delta pays for that norm only
            return dict(base_params, final_norm=state["params"]["final_norm"])

        publish_s = []
        deploy.publish_version = timed(deploy.publish_version, publish_s)
        cb = DeltaPublishCallback(deploy, "assistant", cfg, every=1, canary_fraction=0.5,
                                  extract=merge)
        ft_mgr = CheckpointManager(f"{d}/ft", async_save=True, callbacks=[cb])
        # one step, one checkpoint and one canary: each more costs a 3.10 GB
        # save and a publish, and checks nothing new
        train_loop(cfg, tcfg, LoopConfig(steps=1, ckpt_every=1, seed=1), data, ft_mgr,
                   device=dev)
        for h in ft_mgr.history:
            print(f"  fine-tune checkpoint step {h['step']}: {'anchor' if h['anchor'] else 'delta'},"
                  f" save_s {h['save_s']:.3f}, bytes_written {h['bytes_written']}")
        for rec, sec in zip(cb.published, publish_s):
            print(f"  published {rec.name} (step {rec.step}): {sec:.2f} s, private"
                  f" {rec.private_bytes} B of {rec.total_bytes} B")
        check([r.step for r in cb.published] == [0], "train: the checkpoint was not published")
        check(all(0 < r.private_bytes < r.total_bytes for r in cb.published),
              "train: a published version is not a delta")
        canary = deploy.canary("assistant")
        check(canary is not None and canary.name == cb.published[-1].name,
              "train: the last publish is not the canary")
        # each version's tokens on the CPU, and its final_norm: the only
        # leaf where the versions differ, so the one that tells them apart
        ref, norm = {}, {}
        for name in ("assistant", canary.name):
            r = SpiceRestorer()
            try:
                state, _, _, _ = r.restore(catalog.registry.get(name).jif_path)
                norm[name] = to_host(state["final_norm"]).copy()
                ref[name] = generate(cfg, None, state, prompt, MAX_NEW, device="cpu")[0]
            finally:
                r.iosched.shutdown()
        apart = np.abs(norm[canary.name] - norm["assistant"]).max()
        print(f"  final_norm of {canary.name} against assistant: max |diff| {apart:.3e};"
              f" CPU tokens {'equal' if np.array_equal(*ref.values()) else 'differ'}")
        check(apart > 0, f"train: {canary.name} cannot be told apart from assistant")
        served = []
        for i in range(6):
            r = router.invoke("assistant", prompt, MAX_NEW, mode="spice", cfg=cfg)
            served.append(r.function)
            print(f"  request {i}: {r.function} {'cold' if r.cold else 'warm'},"
                  f" ttft {r.ttft_s * 1e3:.1f} ms")
            check(np.array_equal(r.tokens, ref[r.function]),
                  f"train: {r.function} tokens differ from its JIF's on the CPU")
            check(np.array_equal(served_leaf(node, r.function, "final_norm"), norm[r.function]),
                  f"train: {r.function} serves another version's final_norm")
        check(set(served) == {"assistant", canary.name}, f"train: canary split {served}")
        ok = deploy.evaluate_canary("assistant", prompt, gate=TokenHealthGate(cfg.vocab_size),
                                    n_probes=2, max_new_tokens=MAX_NEW, cfg=cfg)
        stable = deploy.current("assistant")
        back = deploy.rollback("assistant")
        retired = deploy.gc_retired("assistant")
        audit = store.audit()
        print(f"  gate {'passed: promoted' if ok else 'failed: rejected'} {canary.name}"
              f" (stable v{stable.version}); rollback to v{back.version}; retired {retired};"
              f" CAS audit {audit}")
        check(ok and stable.version == canary.version and back.version == 1,
              "train: gate, promote and rollback")
        launches = counts(counters)
        print(f"  train path launches {launches}")
        for name in ("overlay_patch", "flash_attention", "decode_attention"):
            check(launches[name] > 0, f"train: kernel {name} was not launched")
        router.audit()
        return launches, restored["params"]
    finally:
        if router is not None:
            router.close()
        shutil.rmtree(d, ignore_errors=True)


SHARD_BATCH, SHARD_SEQ, SHARD_DECODE = 8, 4096, 8  # prefill_32k / decode_32k cut to one card
PARITY_TOL = {"float32": 1e-5, "int8": 2e-4}  # max |card - CPU| over max |CPU| of the logits


@contextlib.contextmanager
def recorded_step_logits(into: list):
    """Record (on the host) the last-position logits each serve step turns
    into its greedy token."""
    from repro_torch.serve import steps

    real = steps._greedy

    def greedy(logits):
        into.append(logits[:, -1].float().cpu())
        return real(logits)

    steps._greedy = greedy
    try:
        yield into
    finally:
        steps._greedy = real


def run_cells(torch, cells, mesh, params, tokens, n_decode, seq):
    """The prefill cell's step on ``tokens``, then ``n_decode`` steps of the
    decode cell, each under its cell's rules (``mesh`` None: no rules, the
    CPU path).  ``cells`` is (prefill plan, decode plan, their rules).
    Returns (tokens of every step (B, 1 + n_decode), caches, prefill ms,
    decode ms per step); on the card the times come from CUDA events around
    each step, on the CPU they are None."""
    from repro_torch.sharding.partition import axis_rules

    pplan, dplan, prules, drules = cells

    def rules(r):
        return contextlib.nullcontext() if mesh is None else axis_rules(mesh, r)

    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(1 + n_decode)] if tokens.is_cuda else None
    with rules(prules):
        if ev:
            ev[0][0].record()
        tok, caches = pplan.fn(params, {"tokens": tokens})
        if ev:
            ev[0][1].record()
    toks = [tok]
    with rules(drules):
        for i in range(n_decode):
            if ev:
                ev[1 + i][0].record()
            tok, caches = dplan.fn(params, caches, {"tokens": tok[:, None]}, seq + i)
            if ev:
                ev[1 + i][1].record()
            toks.append(tok)
    if not ev:
        return torch.stack(toks, 1), caches, None, None
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ev]
    return torch.stack(toks, 1), caches, ms[0], ms[1:]


ROUNDING_EDGE = 1e-3  # a flipped int8 level's CPU value lies this close (in levels) to the half


@contextlib.contextmanager
def shared_rounding(np, record=None, replay=None, flips=None):
    """Patch ``attention.quantize_kv``.  With ``record``, append each call's
    int8 levels and scales (on the host).  With ``replay``, hold each call's
    levels against the recorded ones (scales within 1e-5; levels equal, or
    one apart where the value lies within ROUNDING_EDGE of the half-level
    between them: rounding that 1e-7 of arithmetic tips over), count those
    into ``flips`` and return the recorded ones."""
    from repro_torch.models import attention

    real = attention.quantize_kv
    calls = iter(replay or ())

    def quantize(x):
        q, scale = real(x)
        if record is not None:
            record.append((q.cpu(), scale.cpu()))
        if replay is None:
            return q, scale
        rq, rs = next(calls)
        check(bool(((rs - scale).abs() <= 1e-5 * scale).all()), "int8 scales differ")
        level = (x.float() / scale[..., None]).cpu().numpy()
        a, b = q.cpu().numpy().astype(np.int32), rq.numpy().astype(np.int32)
        off = a != b
        check(bool((np.abs(a - b) <= 1).all()
                   and (np.abs(level[off] - (a[off] + b[off]) / 2) <= ROUNDING_EDGE).all()),
              "int8 levels differ away from a rounding edge")
        flips.append(int(off.sum()))
        return rq.to(q.device), rs.to(scale.device)

    attention.quantize_kv = quantize
    try:
        yield
    finally:
        attention.quantize_kv = real


def fed_decode_steps(torch, np, cells, mesh, cpu_params, card_params, prompt, n_decode, seq,
                     dev):
    """The decode cell step by step on the card, each step fed the CPU
    path's cache and token from before that step (copied to the card), and
    the CPU's step then given the card's int8 levels for the slot the step
    writes (``shared_rounding``), so that no rounding either side made on
    its own enters the comparison.  Returns (each step's logits max |card -
    CPU| / max |CPU|, tokens equal, levels flipped per step)."""
    from repro_torch.interop import tree_map
    from repro_torch.sharding.partition import axis_rules

    pplan, dplan, _, drules = cells
    tok, caches = pplan.fn(cpu_params, {"tokens": prompt})
    errs, equal, flips = [], True, []
    for i in range(n_decode):
        on_card, levels, flipped = tree_map(lambda t: t.to(dev), caches), [], []
        with axis_rules(mesh, drules), recorded_step_logits([]) as got, \
                shared_rounding(np, record=levels):
            card_tok, _ = dplan.fn(card_params, on_card, {"tokens": tok.to(dev)[:, None]},
                                   seq + i)
        with recorded_step_logits([]) as want, shared_rounding(np, replay=levels, flips=flipped):
            nxt, caches = dplan.fn(cpu_params, caches, {"tokens": tok[:, None]}, seq + i)
        errs.append((got[0] - want[0]).abs().max().item() / want[0].abs().max().item())
        equal &= torch.equal(card_tok.cpu(), nxt)
        flips.append(sum(flipped))
        tok = nxt
    return errs, equal, flips


def cost_phase(torch, cfg, mesh, counted, card):
    """The cost harness (``launch/dryrun.py``) against the card.  Each of
    the cut cells' steps in ``counted`` (its count on the card and its
    measured median ms) is traced again on meta on the same 1 x 1 mesh
    (``dryrun.trace_cell``, the cell's name and the cut shape): FLOPs,
    bytes and kernel costs must be equal to the card's, K2 or K3 24 times,
    and the modeled column equal to the counted one.  Then each step's
    roofline on this card (``dryrun.roofline``: bf16 peak, HBM rate) and
    the share of it the measured step reaches.  Last, the dry-run CLI over
    the production qwen cells (16 x 16 and 2 x 16 x 16 fake groups) in a
    process of its own: a fake group and this NCCL group cannot both be
    the default group."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import roofline, summarize, trace_cell

    t0 = time.perf_counter()
    for label, (on_card, ms) in counted.items():
        kind = label.split()[0]
        name = f"{kind}_32k"
        shape = InputShape(name, kind, SHARD_SEQ, SHARD_BATCH)
        plan, on_meta = trace_cell(ARCH, name, mesh, False,
                                   {"kv_dtype": "int8"} if label.endswith("int8") else {},
                                   shape=shape)
        card_t, meta_t = on_card.totals(), on_meta.totals()
        kernel = "flash_attention" if kind == "prefill" else "decode_attention"
        check(on_card.kernel_calls() == on_meta.kernel_calls() == {kernel: cfg.n_layers},
              f"cost {label}: kernel costs {on_card.kernel_calls()} on the card,"
              f" {on_meta.kernel_calls()} on meta")
        if card_t != meta_t or dict(on_card.ops) != dict(on_meta.ops):
            for key in sorted(set(on_card.ops) | set(on_meta.ops)):
                if on_card.ops.get(key) != on_meta.ops.get(key):
                    print(f"    {key}: card {on_card.ops.get(key)}, meta {on_meta.ops.get(key)}")
            fail(f"cost {label}: the card's count {card_t} differs from meta's {meta_t}")
        s = summarize(on_meta, cfg, shape, mesh, plan)
        check(s["modeled"]["flops"] == card_t["flops"] and s["modeled"]["bytes"] == card_t["bytes"],
              f"cost {label}: on a 1 x 1 mesh the modeled column differs from the counted one")
        r = roofline({"flops": card_t["flops"], "bytes accessed": card_t["bytes"]},
                     s["collectives"], 1, cfg, shape)
        print(f"  cost {label} step ({SHARD_BATCH} x {SHARD_SEQ}): counted on the card = on meta,"
              f" {card_t['flops'] / 1e12:.4f} TFLOP, {card_t['bytes'] / 1e9:.4f} GB (kernels"
              f" {card_t['kernel_flops'] / 1e12:.4f} TFLOP, {card_t['kernel_bytes'] / 1e9:.4f} GB;"
              f" {card_t['ops']} aten ops); compute_s {r['compute_s'] * 1e3:.4f} ms, memory_s"
              f" {r['memory_s'] * 1e3:.4f} ms, bound {r['bound_time_s'] * 1e3:.4f} ms"
              f" ({r['dominant']}); measured {ms:.2f} ms a step -> {r['bound_time_s'] * 1e3 / ms:.2%}"
              f" of its roofline ({card})")
    print(f"  cost phase on the card {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "dryrun_torch")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH, "--mesh", "both",
         "--force", "--results", out_dir], capture_output=True, text=True, env=env, timeout=600)
    for line in proc.stdout.splitlines():
        if not line.startswith("[run]"):
            print(f"    {line}")
    print(f"  dryrun CLI --arch {ARCH} --mesh both: exit {proc.returncode}"
          f" ({time.perf_counter() - t0:.1f} s)")
    check(proc.returncode == 0, f"the dry-run CLI failed: {proc.stderr[-2000:]}")
    cells = sorted(f for f in os.listdir(out_dir) if f.endswith(".json"))
    results = [json.load(open(os.path.join(out_dir, f))) for f in cells]
    check(len(cells) == 8 and not any("error" in r for r in results),
          f"the dry-run CLI wrote {cells}")


def sharded_path(torch, np, dev, counters, restored, train_cfg, measured, card):
    """The sharded serve steps on the card: a one-rank NCCL process group
    (an in-memory store; nothing listens on a socket), the 1 x 1 host mesh
    and the serve rules, qwen1.5-0.5b at full width and depth.
    (1) Parity: ``build_cell``'s prefill and decode steps at batch 2 x 16
    tokens, f32, f32 and int8 caches, under the rules on the card against
    the same steps on the CPU path without rules: tokens equal, logits to
    PARITY_TOL, the decode steps' also fed the CPU path's cache and int8
    rounding (``fed_decode_steps``; with an int8 cache only those are
    held).  (2) The
    cells: ``prefill_32k`` and ``decode_32k`` cut to
    batch SHARD_BATCH x SHARD_SEQ, bf16 weights from the seed, one prefill
    step (K2) and SHARD_DECODE decode steps (K3), once at ``kv_policy``'s
    cache (bf16 on this mesh) and once with the reference's ``kv_dtype``
    override "int8" (K3's int8 instance); step ms from CUDA events, each
    step profiled once, K3 held against its plain version on the path's
    last cache and timed there, K2 held against its plain version at the
    prefill cell's call and timed there beside SDPA.  Between them the
    cost phase (:func:`cost_phase`) over one more prefill step and one more
    decode step at each cache, counted on the card.  (3) Elastic: the train
    phase's restored params resharded onto
    ``make_mesh_from_plan(plan_mesh(1, 16))``, equal bit for bit.  ``card``
    is ``nvidia-smi``'s name and power limit.  Returns each run's launch
    counts."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.ft.elastic import make_mesh_from_plan, plan_mesh, reshard_state
    from repro_torch.interop import to_torch, tree_leaves, tree_map
    from repro_torch.kernels.decode_attention.ops import cost as k3_cost
    from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_plain
    from repro_torch.kernels.flash_attention.ops import cost as k2_cost
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import init_single_process, make_host_mesh
    from repro_torch.launch.specs import build_cell, make_rules
    from repro_torch.models import lm
    from repro_torch.models.attention import dequantize_kv
    from repro_torch.sharding.partition import axis_rules

    cfg = get_config(ARCH)
    rng = np.random.default_rng(SEED + 7)
    t_phase = time.perf_counter()
    init_single_process(dev)
    paths = {}
    try:
        mesh = make_host_mesh(dev)
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"sharded: process group {dist.get_backend()} x {dist.get_world_size()}")
        print(f"  process group {dist.get_backend()}, world {dist.get_world_size()}; mesh"
              f" {dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}")

        def plans(B, S, over):
            cells = []
            for name, kind in (("prefill_32k", "prefill"), ("decode_32k", "decode")):
                shape = InputShape(name, kind, S, B)
                rules = make_rules(cfg, shape, False)
                with axis_rules(mesh, rules):
                    cells.append((build_cell(ARCH, name, mesh, False, over, shape=shape), rules))
            (pplan, prules), (dplan, drules) = cells
            return pplan, dplan, prules, drules

        # (1) parity at batch 2 x PROMPT_LEN, f32, against the CPU path
        params32 = seeded_params(cfg, dev)
        on_card = tree_map(lambda t: t.to(dev), params32)
        prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
        for kv in ("float32", "int8"):
            cells = plans(BATCH, PROMPT_LEN, {"compute_dtype": "float32", "kv_dtype": kv})
            ends = {}
            reset(counters)
            for where, p, m in (("cpu", params32, None), (dev, on_card, mesh)):
                with recorded_step_logits([]) as into:
                    toks = run_cells(torch, cells, m, p, torch.as_tensor(prompt, device=where),
                                     3, PROMPT_LEN)[0]
                ends[str(where)] = (toks.cpu(), into)
            fed, fed_equal, flips = fed_decode_steps(
                torch, np, cells, mesh, params32, on_card, torch.as_tensor(prompt), 3,
                PROMPT_LEN, dev)
            paths[f"sharded parity {kv}"] = counts(counters)
            (cpu_tok, want), (card_tok, got) = ends["cpu"], ends[str(dev)]
            errs = [(g - w).abs().max().item() / w.abs().max().item() for g, w in zip(got, want)]
            # the prefill step's logits, then the decode steps' fed the CPU's caches
            held = errs[:1] + fed
            print(f"  parity, {kv} cache: tokens {card_tok.tolist()}"
                  f" {'equal to' if torch.equal(card_tok, cpu_tok) else 'DIFFER from'} the CPU"
                  f" path's; logits max |err| / max |logit|, each side's own chain by step"
                  f" {', '.join(f'{e:.2e}' for e in errs)}; prefill and each decode step fed"
                  f" the CPU's cache {', '.join(f'{e:.2e}' for e in held)} (bound"
                  f" {PARITY_TOL[kv]:.0e}), tokens {'equal' if fed_equal else 'DIFFER'}, int8"
                  f" levels one apart at a rounding edge by step {flips};"
                  f" launches {paths[f'sharded parity {kv}']}")
            check(torch.equal(card_tok, cpu_tok) and fed_equal,
                  f"sharded parity {kv}: tokens differ")
            # an int8 cache rounds each K/V to one of 255 levels, and each side's
            # own chain rounds a cache of its own: a level 1e-7 tips over moves
            # the logits by ~1e-4.  There the f32 cache alone is held; the fed
            # steps, whose rounding is shared, hold both
            check(len(held) == 4 and all(e <= PARITY_TOL[kv] for e in held)
                  and (kv == "int8" or all(e <= PARITY_TOL[kv] for e in errs)),
                  f"sharded parity {kv}: logits differ from the CPU path")
        del on_card, params32
        torch.cuda.empty_cache()

        # (2) the cells at SHARD_BATCH x SHARD_SEQ, bf16
        counted = {}  # step -> (its count on the card, its measured ms)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        print(f"  {cfg.name} at full width and depth ({cfg.n_layers} layers), bf16 weights"
              f" {sum(t.nbytes for t in tree_leaves(params)) / 1e9:.3f} GB"
              f" (init {time.perf_counter() - t0:.1f} s)")
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SHARD_BATCH, SHARD_SEQ)),
                                 dtype=torch.int32, device=dev)
        for kv in (None, "int8"):
            over = {} if kv is None else {"kv_dtype": kv}
            cells = plans(SHARD_BATCH, SHARD_SEQ, over)
            pplan, dplan, prules, drules = cells
            want_kv = "bfloat16" if kv is None else "int8"
            check(pplan.meta["kv_dtype"] == dplan.meta["kv_dtype"] == want_kv,
                  f"sharded: cells planned {pplan.meta['kv_dtype']} / {dplan.meta['kv_dtype']}")
            check([(tuple(a.shape), a.dtype) for a in tree_leaves(pplan.args[0])]
                  == [(tuple(t.shape), t.dtype) for t in tree_leaves(params)],
                  "sharded: the cell's abstract params differ from the weights")
            label = f"{want_kv} cache{' (kv_policy)' if kv is None else ' (override)'}"
            torch.cuda.reset_peak_memory_stats(dev)
            reset(counters)
            toks, caches, pre_ms, dec_ms = run_cells(torch, cells, mesh, params, tokens,
                                                     SHARD_DECODE, SHARD_SEQ)
            launches = paths[f"sharded {want_kv}"] = counts(counters)
            cache_gb = sum(t.nbytes for t in tree_leaves(caches)) / 1e9
            print(f"  cells {pplan.meta['shape']} / {dplan.meta['shape']} cut to"
                  f" {SHARD_BATCH} x {SHARD_SEQ}, {label}: prefill step {pre_ms:.2f} ms"
                  f" ({SHARD_BATCH * SHARD_SEQ / pre_ms * 1e3:.0f} tokens/s); decode steps ms"
                  f" {', '.join(f'{t:.2f}' for t in dec_ms)} (median"
                  f" {sorted(dec_ms)[len(dec_ms) // 2]:.2f}); cache {cache_gb:.3f} GB; peak"
                  f" device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB;"
                  f" launches {launches}")
            check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "sharded: bad tokens")
            check(launches["flash_attention"] == cfg.n_layers
                  and launches["decode_attention"] == cfg.n_layers * SHARD_DECODE,
                  f"sharded {label}: launches {launches}")
            with axis_rules(mesh, prules):
                profiled(torch, f"prefill step, {label}",
                         lambda: pplan.fn(params, {"tokens": tokens}))
            with axis_rules(mesh, drules):
                profiled(torch, f"decode step, {label}",
                         lambda: dplan.fn(params, caches, {"tokens": toks[:, -1:]},
                                          SHARD_SEQ + SHARD_DECODE))
            # the cost harness counts one more step of each on the card (K2 /
            # K3 launched); cost_phase holds it against the count on meta
            if kv is None:
                with axis_rules(mesh, prules):
                    counted["prefill"] = (count_step("prefill", pplan.fn,
                                                     (params, {"tokens": tokens})), pre_ms)
            with axis_rules(mesh, drules):
                counted[f"decode {want_kv}"] = (count_step(
                    "decode", dplan.fn, (params, caches, {"tokens": toks[:, -1:]},
                                         SHARD_SEQ - 1)), sorted(dec_ms)[len(dec_ms) // 2])
            # K3 on the path's own cache (layer 0, after every step)
            c0 = {k: v[0] for k, v in caches["pattern"][0].items()}
            pos = SHARD_SEQ + SHARD_DECODE  # past the cache: every slot valid
            ks, vs = c0.get("k_scale"), c0.get("v_scale")
            for qd in (torch.bfloat16, torch.float32):
                q = torch.randn(SHARD_BATCH, cfg.n_heads, cfg.hd, device=dev).to(qd)
                got = decode_attention(q, c0["k"], c0["v"], pos, ks, vs)
                want = decode_attention_plain(q, c0["k"], c0["v"], pos, ks, vs)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL["bfloat16" if torch.bfloat16 in (qd, c0["k"].dtype) else want_kv]
                print(f"  decode_attention on the path's {want_kv} cache, q {str(qd)[6:]}:"
                      f" max abs err {err:.3e} (bound {tol:.0e})")
                check(err <= tol, f"sharded: decode_attention on the {want_kv} cache: {err}")
            if kv == "int8":
                kd = dequantize_kv(c0["k"], ks, torch.bfloat16)
                vd = dequantize_kv(c0["v"], vs, torch.bfloat16)
                q4 = q.to(torch.bfloat16)[:, :, None]
                qb = q.to(torch.bfloat16)
                row = timed_shape(
                    f"decode_attention on the sharded path's int8 cache B={SHARD_BATCH}"
                    f" H={cfg.n_heads} Sc={SHARD_SEQ} hd={cfg.hd} pos={pos} int8, q bf16"
                    f" (library: sdpa over the dequantized cache)",
                    lambda: decode_attention(qb, c0["k"], c0["v"], pos, ks, vs),
                    lambda: decode_attention_plain(qb, c0["k"], c0["v"], pos, ks, vs),
                    lambda: F.scaled_dot_product_attention(q4, kd, vd),
                    k3_cost(qb, c0["k"], c0["v"], pos, ks, vs), "float32")
                measured["decode_attention"]["shapes"].append(row)
                del kd, vd
            del caches, c0
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        cost_phase(torch, cfg, mesh, counted, card)

        # K2 at the prefill cell's own call, as attn_full makes it: the (B, S,
        # H, hd) projections seen as (B, H, S, hd), out=, causal, no window
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        H, kvH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v, out = flash_case(torch, g, dev, SHARD_BATCH, H, kvH, SHARD_SEQ, hd,
                                  torch.bfloat16, strided=True)
        got = flash_attention(q, k, v, out=out)
        want = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err, rr = (got.float() - want.float()).abs().max().item(), rel_rms(got, want)
        label = (f"flash_attention on the sharded prefill cell's call B={SHARD_BATCH} H={H}"
                 f"{f' kvH={kvH}' if kvH != H else ''} S={SHARD_SEQ} hd={hd} bfloat16 strided")
        print(f"  {label}: max abs err {err:.3e}, rel rms {rr:.3e} (bounds"
              f" {TOL['bfloat16']:.0e}, {REL_RMS_BF16:.0e})")
        check(got is out, "flash_attention did not write into out=")
        check(err <= TOL["bfloat16"] and rr <= REL_RMS_BF16,
              f"sharded: flash_attention at the prefill cell's shape: {err}, rel rms {rr}")
        del got, want
        measured["flash_attention"]["shapes"].append(timed_shape(
            label, lambda: flash_attention(q, k, v, out=out),
            lambda: flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=kvH != H),
            k2_cost(q, k, v), "bfloat16"))
        del q, k, v, out
        torch.cuda.empty_cache()

        # (3) elastic: the restored JIF's params onto the planned mesh
        plan = plan_mesh(1, model_parallel=16)
        check(plan.shape == (1, 1), f"plan_mesh(1, 16) = {plan.shape}")
        emesh = make_mesh_from_plan(plan, device=dev)
        t0 = time.perf_counter()
        placed = reshard_state(restored, lm.param_specs(train_cfg), emesh,
                               make_rules(train_cfg, SHAPES["train_4k"], False))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        same = tree_leaves(tree_map(
            lambda p, r: bool(torch.equal(p.full_tensor(), to_torch(r, dev))), placed, restored))
        n_bytes = sum(r.nbytes for r in tree_leaves(restored))
        print(f"  elastic: plan {plan.shape} {plan.axes}; reshard_state of the restored"
              f" {train_cfg.n_layers}-layer params ({n_bytes / 1e9:.3f} GB) in {secs:.2f} s;"
              f" {sum(same)} of {len(same)} leaves equal bit for bit")
        check(all(same), "elastic: resharded params differ from the restored JIF's")
        print(f"  sharded path {time.perf_counter() - t_phase:.1f} s")
        return paths
    finally:
        dist.destroy_process_group()


# every hand-written kernel: its source and the TPU kernel it replaces
KERNEL_SOURCES = {
    "overlay_patch": ("src/repro_torch/csrc/overlay_patch.cu",
                      "src/repro/kernels/overlay_patch/kernel.py:39"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:68"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:60"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:71"),
    # no TPU counterpart: the JAX package pads each expert to a capacity in jnp
    "moe_experts": ("src/repro_torch/csrc/moe_experts.cu", None),
}


def kernel_rows(measured, launches) -> list:
    """The ``kernels`` line's entries for the kernels in ``measured`` (each
    a ``check_*`` result), with their launches on the main paths."""
    rows = []
    for name, m in measured.items():
        source, replaces = KERNEL_SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "device_us": m["device_us"], "library_device_us": m["library_device_us"],
            "shapes": m["shapes"],
        })
    return rows


def main() -> None:
    import dataclasses

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
    t_start = time.perf_counter()
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
        "moe_experts": check_moe_experts(torch, dev),
    }
    print("== K2 and K3 at head dim 168 (the repo's gemma3-27b config), long shapes")
    wide = check_long_shapes(torch, dev, GEMMA_HEADS, "gemma3-27b config heads", (None, 1024))
    print("== K2 and K3 at starcoder2-7b's heads (G 9, K3's 16-head instance), long shapes")
    g9 = check_long_shapes(torch, dev, CODER_HEADS, "starcoder2-7b heads (G 9)", seed=SEED + 6)
    print(f"== K2 and K3 past head dim 256: generic instances at {GENERIC_HEAD_DIMS}")
    generic = check_generic_head_dim(torch, dev)
    for flash_rows, decode_rows, flash_err, decode_err in (wide, g9, generic):
        for name, rows, err in (("flash_attention", flash_rows, flash_err),
                                ("decode_attention", decode_rows, decode_err)):
            measured[name]["shapes"] += rows
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)

    # every request prefills once (one attention or SSD-scan launch per
    # layer) and decodes MAX_NEW - 1 tokens (the scan never runs there)
    qwen, ssm = get_config(ARCH), get_config(SSM_ARCH)
    counters = launch_counters()
    paths = {}
    qwen_request = {"flash_attention": qwen.n_layers,
                    "decode_attention": qwen.n_layers * (MAX_NEW - 1)}
    # the restore modes and the concurrent invocations run on the qwen
    # path's node, after it
    modes = functools.partial(qwen_node_phases, torch, np, counters, qwen, qwen_request)
    runs = {}
    for cfg, base_name, fns, per_request, after in (
        (qwen, "qwen-base", {"fn-base": lambda p, c: p, "fn-ft": fine_tune}, qwen_request, modes),
        (ssm, "rnn-base", {"fn-rnn-base": lambda p, c: p, "fn-rnn": py_rnn_fine_tune},
         {"ssd_scan": ssm.n_layers}, None),
    ):
        arch = cfg.name
        print(f"== main path {arch}: publish, Spice restore, fused install, generate")
        runs[arch] = main_path(torch, np, dev, counters, cfg, base_name, fns, per_request,
                               after=after)
        if after is not None:
            paths["modes"] = runs[arch]["after"]["modes"]
            paths["concurrent"] = runs[arch]["after"]["concurrent"]["launches"]
        paths[arch] = runs[arch]["launches"]
        for name in ("overlay_patch", *per_request):
            check(paths[arch][name] > 0, f"kernel {name} was not launched on the {arch} path")
    for path in ("modes", "concurrent"):
        for name in ("overlay_patch", *qwen_request):
            check(paths[path][name] > 0, f"kernel {name} was not launched on the {path} path")
    k1_main = [r["launches"]["overlay_patch"] for r in runs[ARCH]["requests"]
               if r["function"] == "fn-ft" and r["start"] == "cold"]
    k1_concurrent = runs[ARCH]["after"]["concurrent"]["k1_cold"]
    check(set(k1_main) == {k1_concurrent},
          f"a sequential cold start launched K1 {k1_concurrent} times on the concurrent path,"
          f" {k1_main} on the main path")
    print(f"== bf16 path {ARCH} at full width and depth, ml_dtypes unimportable: publish,"
          f" Spice restore, fused install, generate, checkpoint")
    t0 = time.perf_counter()
    paths["bf16"] = bf16_path(torch, np, dev, counters, qwen, qwen_request, runs[ARCH])
    for name in ("overlay_patch", *qwen_request):
        check(paths["bf16"][name] > 0, f"kernel {name} was not launched on the bf16 path")
    print(f"  bf16 path {time.perf_counter() - t0:.1f} s")
    print("== examples/torch_*.py in this process on the card")
    paths.update(examples_path(torch, counters))
    print(f"== {GEMMA_ARCH} generate at full width, depth cut")
    paths[GEMMA_ARCH] = gemma_path(torch, np, dev, counters)
    print(f"== main path {MOE_ARCH} (MoE) at full width, depth cut")
    paths[MOE_ARCH] = moe_path(torch, np, dev, counters)
    for name in ("overlay_patch", "flash_attention", "decode_attention"):
        check(paths[MOE_ARCH][name] > 0, f"kernel {name} was not launched on the {MOE_ARCH} path")
    print(f"== {VL_ARCH} (vision, M-RoPE) lm.prefill / decode_step at full width, depth cut")
    paths[VL_ARCH] = vl_path(torch, np, dev, counters)
    print(f"== {AUDIO_ARCH} (audio frames) lm.prefill / decode_step at full width, depth cut")
    paths[AUDIO_ARCH] = audio_path(torch, np, dev, counters)
    print(f"== {HYBRID_ARCH} (Mamba2 + MoE, attention) generate at full width, depth cut")
    paths[HYBRID_ARCH] = hybrid_path(torch, np, dev, counters)
    print(f"== main path {CODER_ARCH} (G 9) at full width, depth cut")
    paths[CODER_ARCH] = coder_path(torch, np, dev, counters)
    for name in ("overlay_patch", "flash_attention", "decode_attention"):
        check(paths[CODER_ARCH][name] > 0,
              f"kernel {name} was not launched on the {CODER_ARCH} path")
    print(f"== {QWEN3_ARCH} (qk-norm, G 8) generate at full width, depth cut")
    paths[QWEN3_ARCH] = qk_norm_path(torch, np, dev, counters)
    print(f"== {PHI_ARCH} (MoE, 16 experts top-2) generate at full width, depth cut")
    paths[PHI_ARCH] = phi_path(torch, np, dev, counters)
    print(f"== {GRANITE_CONFIG} (Mamba-2 / attention, dropless MoE through K5) generate at"
          f" full width, depth cut")
    paths[GRANITE_CONFIG] = granite_path(torch, np, dev, counters)
    paths.update(policy_paths(torch, np, dev, counters, qwen))
    for name in ("prewarm", "handoff", "deploy"):
        check(paths[name]["overlay_patch"] > 0, f"kernel overlay_patch was not launched on {name}")
    print(f"== train {ARCH} at full width, depth cut to {TRAIN_LAYERS} of {qwen.n_layers}"
          f" layers: crash, resume, publish, canary")
    t0 = time.perf_counter()
    train_cfg = dataclasses.replace(qwen, n_layers=TRAIN_LAYERS, pattern_reps=TRAIN_LAYERS)
    paths["train"], restored = train_path(torch, np, dev, counters, train_cfg)
    print(f"  train path {time.perf_counter() - t0:.1f} s")
    print(f"== sharded steps {ARCH}: one-rank NCCL group, 1 x 1 mesh, build_cell prefill /"
          f" decode at {SHARD_BATCH} x {SHARD_SEQ}, bf16 and int8 caches; elastic reshard")
    paths.update(sharded_path(torch, np, dev, counters, restored, train_cfg, measured, card))
    del restored
    launches = {name: sum(p[name] for p in paths.values()) for name in counters}
    print(f"  launches per path: {json.dumps(paths)}")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    check(not leaked, f"the port imported the JAX side: {leaked[:5]}")

    check(not spilled, f"stack frame or spills in K2-K4 kernels: {spilled}")
    kernels = kernel_rows(measured, launches)
    print(f"== all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
