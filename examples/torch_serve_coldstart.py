"""End to end on the PyTorch/CUDA port: a serverless node serving
BATCHED requests across a zoo of model functions with aggressive
reclamation — every invocation after an idle gap is a disk cold start,
which Spice makes near-warm.

    PYTHONPATH=src python examples/torch_serve_coldstart.py               # on the GPU
    PYTHONPATH=src python examples/torch_serve_coldstart.py --device cpu  # on the host
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import BaseImage
from repro_torch.models import lm
from repro_torch.serve.engine import ServerlessNode, layerwise_state

REQUESTS = [  # (function, prompt len) — a bursty multi-tenant trace
    ("chat-a", 8), ("chat-a", 8), ("code-b", 16), ("chat-a", 8),
    ("ssm-c", 8), ("code-b", 16), ("chat-a", 8), ("ssm-c", 8),
]


def main(device=None):
    """``device`` None is the GPU."""
    node = ServerlessNode(device=device)
    with tempfile.TemporaryDirectory() as d:
        # three functions; two share one base image (a "Python+AI pool")
        base_cfg = get_config("qwen1.5-0.5b").reduced()
        base_params = lm.init_params(base_cfg, seed=1, device=device)
        node.node_cache.put(
            BaseImage.from_state("pool-base", layerwise_state(base_cfg, base_params))
        )
        ft = dict(base_params)
        ft["final_norm"] = ft["final_norm"] * 1.01
        node.publish("chat-a", base_cfg, base_params, d, base_name="pool-base")
        node.publish("code-b", base_cfg, ft, d, base_name="pool-base")

        ssm_cfg = get_config("mamba2-780m").reduced()
        node.publish("ssm-c", ssm_cfg, lm.init_params(ssm_cfg, seed=2, device=device), d)

        cfgs = {"chat-a": base_cfg, "code-b": base_cfg, "ssm-c": ssm_cfg}
        # a first invocation per arch
        for f, cfg in cfgs.items():
            node.invoke(f, np.ones((1, 4), np.int32), 2, mode="spice_sync", cfg=cfg)

        print(f"{'req':>3} {'function':>8} {'start':>6} {'ttft_ms':>9} {'total_ms':>9}")
        for i, (fname, plen) in enumerate(REQUESTS):
            node.evict()  # aggressive reclamation: idle instances are freed
            prompt = np.tile(np.arange(1, plen + 1, dtype=np.int32), (2, 1))
            r = node.invoke(fname, prompt, max_new_tokens=4, mode="spice",
                            cfg=cfgs[fname])
            print(f"{i:>3} {fname:>8} {'cold':>6} {r.ttft_s*1e3:9.2f} {r.total_s*1e3:9.2f}")

        print("\nnode cache:", node.node_cache.stats)
        print("buffer pool:", node.pool.stats)
    node.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
