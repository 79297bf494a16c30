"""Quickstart on the PyTorch/CUDA port: snapshot a model function to a JIF,
tear everything down, and cold-start it from disk in milliseconds.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # on the host
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve.engine import ServerlessNode


def main(device=None):
    """``device`` None is the GPU."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = lm.init_params(cfg, seed=0, device=device)

    node = ServerlessNode(device=device)
    with tempfile.TemporaryDirectory() as d:
        print("== publish: offline JIF preparation (trace + relocate + trim)")
        spec = node.publish("hello-fn", cfg, params, d)
        print(f"   wrote {spec.jif_path}")

        prompt = np.array([[11, 12, 13, 14]], dtype=np.int32)

        print("== warm up the compile cache (restored via keys, not re-trace)")
        node.invoke("hello-fn", prompt, max_new_tokens=4, mode="spice_sync", cfg=cfg)
        node.evict()

        print("== COLD start: restore from disk, overlap restore & execute")
        r = node.invoke("hello-fn", prompt, max_new_tokens=8, mode="spice", cfg=cfg)
        print(f"   tokens: {r.tokens[0].tolist()}")
        print(f"   ttft:   {r.ttft_s*1e3:.2f} ms   total: {r.total_s*1e3:.2f} ms")
        # the reference's counters; the upload jobs' sync_wait_s and the
        # staging slots' pinned_bytes are the port's own
        shared = {k: v for k, v in r.stats.items()
                  if k not in ("sync_wait_s", "pinned_bytes")}
        print(f"   restore stats: {shared}")

        print("== baseline comparison (same function, CRIU*-style replay)")
        node.evict()
        rb = node.invoke("hello-fn", prompt, max_new_tokens=8, mode="criu_star", cfg=cfg)
        assert np.array_equal(rb.tokens, r.tokens)
        print(f"   criu*: total {rb.total_s*1e3:.2f} ms "
              f"({rb.total_s/max(r.total_s,1e-9):.2f}x spice)")
    node.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
