"""Overlay economics on the PyTorch/CUDA port: N fine-tunes of one base
model, snapshotted as **delta chains against the parent JIF on disk** —
storage & restore I/O scale with the *delta*, not the model.  Restores run
against a COLD node cache: the parent image is bootstrapped from its file
on first use (``BaseImage.from_jif``) and then serves every sibling's
shared bytes from RAM.

The weights are made on ``device`` (the GPU unless ``--device cpu``) and
copied to the host once; every snapshot and restore after that is host
numpy, as in ``examples/overlay_finetunes.py``: no restore touches a device.

    PYTHONPATH=src python examples/torch_overlay_finetunes.py
    PYTHONPATH=src python examples/torch_overlay_finetunes.py --device cpu
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import NodeImageCache, SpiceRestorer, snapshot
from repro_torch.core.lifecycle import parent_cache_key
from repro_torch.interop import tree_map
from repro_torch.models import lm
from repro_torch.serve.engine import layerwise_state


def main(device=None):
    """``device`` None is the GPU."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(  # deep enough that delta fractions differ
        cfg, pattern_reps=12, n_layers=12, d_model=256, d_ff=512, head_dim=32
    )
    base_params = lm.init_params(cfg, seed=0, device=device)
    base_state = layerwise_state(cfg, base_params)

    with tempfile.TemporaryDirectory() as d:
        # the parent is just another JIF on disk — no pre-seeded node cache
        parent = f"{d}/base.jif"
        full = snapshot(base_state, parent)
        print(f"base image: {full.total_bytes/1e6:.1f} MB total, "
              f"{full.private_bytes/1e6:.1f} MB private\n")

        cache = NodeImageCache()  # cold: bootstrapped from disk on first restore
        print(f"{'finetune':>10} {'total_MB':>9} {'file_MB':>8} {'dedup':>6} "
              f"{'vs_full':>8} {'restore_ms':>10}")
        for i, frac in enumerate([0.05, 0.2, 0.5]):
            # fine-tune the top `frac` of layers
            ft = tree_map(lambda a: a, base_state)
            cut = int(len(ft["layers"]) * (1 - frac))
            for li in range(cut, len(ft["layers"])):
                ft["layers"][li] = tree_map(lambda a: a * 1.02, ft["layers"][li])

            path = f"{d}/ft{i}.jif"
            stats = snapshot(ft, path, parent=parent)

            restorer = SpiceRestorer(node_cache=cache)
            got, _, _, rstats = restorer.restore(path)
            np.testing.assert_allclose(
                got["layers"][-1]["mlp"]["w_down"], ft["layers"][-1]["mlp"]["w_down"]
            )
            print(
                f"{f'{int(frac*100)}%-tuned':>10} "
                f"{stats.total_bytes/1e6:9.1f} {stats.private_bytes/1e6:8.1f} "
                f"{(1-stats.file_fraction)*100:5.1f}% "
                f"{100*stats.private_bytes/max(full.private_bytes,1):7.1f}% "
                f"{rstats.total_s*1e3:10.2f}"
            )
        assert cache.get(parent_cache_key(parent)) is not None
        print("\nbase-image cache:", cache.stats,
              f"resident={cache.total_bytes/1e6:.1f}MB")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
