"""End-to-end serving driver of the port: publish a function and serve
batched requests with cold restores (the Spice serving loop).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 8 --mode spice [--keep-warm | --prewarm [--interval 0.5]] \\
      [--full-width] [--device cuda]

``--arch`` takes every configuration of ``repro_torch.configs.ARCHS``: the
attention models (among them ``qwen3-32b``, with qk-norm and 64 / 8 heads,
and ``starcoder2-7b``, 36 / 4 heads), the Mamba2 one (``mamba2-780m``,
whose prefill runs the SSD-scan kernel) and the MoE ones (``olmoe-1b-7b``,
``phi3.5-moe-42b-a6.6b``, and ``jamba-v0.1-52b``, which mixes attention,
Mamba2 and MoE layers), and the frontend models (``qwen2-vl-7b``, whose
attention rotates with M-RoPE, and ``musicgen-large``), served on text
tokens as the reference's ``generate`` takes them.  Warmth modes:

  (none)       every request is a cold start (no keep-alive)
  --keep-warm  reactive: static 300 s keep-alive TTL
  --prewarm    predictive: adaptive per-function TTLs from the arrival
               histogram (PrewarmPolicy) + speculative restores ahead of
               the predicted next arrival (PrewarmEngine); ``--interval``
               spaces the requests so it has a period to learn

``--full-width`` serves the
configuration as published (the JAX CLI always serves ``.reduced()``);
weights are random, from seed 0.  The node installs with its default
(eager) policy.
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import BufferPool
from repro_torch.interop import tree_leaves
from repro_torch.models import lm
from repro_torch.serve.engine import (
    ArrivalTracker,
    FixedTTLPolicy,
    PrewarmEngine,
    PrewarmPolicy,
    ServerlessNode,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--mode", default="spice",
                    choices=["spice", "spice_sync", "criu_star", "reap_star",
                             "faasnap_star"])
    ap.add_argument("--interval", type=float, default=0.0,
                    help="seconds between requests (gives --prewarm a "
                         "periodic arrival pattern to learn)")
    warmth = ap.add_mutually_exclusive_group()
    warmth.add_argument("--keep-warm", action="store_true",
                        help="reactive keep-alive: static 300 s TTL")
    warmth.add_argument("--prewarm", action="store_true",
                        help="predictive: adaptive TTLs + speculative "
                             "restores from the arrival histogram")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the configuration unreduced")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, seed=0, device=args.device)
    image_bytes = sum(t.nbytes for t in tree_leaves(params))
    # the node ledger holds the image's staging, its warm copy and the
    # publish scratch at once: size it from the image, not the 2 GiB default
    budget = max(4 * image_bytes, 2 << 30)
    if args.prewarm:
        tracker = ArrivalTracker()
        kw = {
            "keepalive": PrewarmPolicy(
                tracker, default_ttl_s=0.0, max_ttl_s=300.0, min_observations=2,
            ),
            "prewarm": PrewarmEngine(
                tracker, horizon_s=max(0.3, args.interval), interval_s=0.05,
                min_observations=2,
            ),
            "reap_interval_s": 0.25,
        }
    elif args.keep_warm:
        kw = {"keepalive": FixedTTLPolicy(300.0)}
    else:
        kw = {}  # spec TTL 0: every request restores
    node = ServerlessNode(
        device=args.device, pool=BufferPool(capacity_bytes=budget),
        memory_budget_bytes=budget, **kw,
    )
    with tempfile.TemporaryDirectory() as d:
        node.publish("fn", cfg, params, d)
        prompt = np.tile(np.arange(1, args.prompt_len + 1, dtype=np.int32),
                         (args.batch, 1))
        # warm-up: the first request builds the kernels and the CUDA context
        node.invoke("fn", prompt, 2, mode="spice_sync", cfg=cfg)
        node.evict()

        print(f"{'req':>4} {'path':>6} {'ttft_ms':>9} {'total_ms':>9}")
        for i in range(args.requests):
            if not (args.keep_warm or args.prewarm):
                node.evict()
            r = node.invoke("fn", prompt, args.max_new, mode=args.mode, cfg=cfg)
            path = "warm" if not r.cold else ("join" if r.joined else args.mode)
            print(f"{i:>4} {path:>6} "
                  f"{r.ttft_s*1e3:9.2f} {r.total_s*1e3:9.2f}")
            if args.interval:
                time.sleep(args.interval)
        print("pool:", node.pool.stats)
        if args.prewarm:
            eng = node.router.prewarm
            eng.drain(5.0)
            print("prewarm:", {k: v for k, v in eng.stats.items() if v})
        node.close()


if __name__ == "__main__":
    main()
