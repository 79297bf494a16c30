"""End-to-end serving driver of the port: publish a function and serve
batched requests with cold restores (the Spice serving loop).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 8 --mode spice [--keep-warm] [--full-width] [--device cuda]

Without ``--keep-warm`` every request is a cold start; with it, a static
300 s keep-alive TTL keeps the function warm after its first restore.
``--full-width`` serves the configuration as published (the JAX CLI always
serves ``.reduced()``); weights are random, from seed 0.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import BufferPool
from repro_torch.interop import tree_leaves
from repro_torch.models import lm
from repro_torch.serve.engine import FixedTTLPolicy, ServerlessNode


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
    ap.add_argument("--keep-warm", action="store_true",
                    help="reactive keep-alive: static 300 s TTL")
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
    kw = {"keepalive": FixedTTLPolicy(300.0)} if args.keep_warm else {}
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
            if not args.keep_warm:
                node.evict()
            r = node.invoke("fn", prompt, args.max_new, mode=args.mode, cfg=cfg)
            path = "warm" if not r.cold else ("join" if r.joined else args.mode)
            print(f"{i:>4} {path:>6} "
                  f"{r.ttft_s*1e3:9.2f} {r.total_s*1e3:9.2f}")
        print("pool:", node.pool.stats)
        node.close()


if __name__ == "__main__":
    main()
