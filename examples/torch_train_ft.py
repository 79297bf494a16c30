"""Fault-tolerant training + continuous delivery on the PyTorch/CUDA port:
train a small LM with async incremental JIF checkpoints, crash it mid-run,
resume bit-exact from the manifest — then publish the result as a serving
function and let a fine-tune stream new versions straight into the
serving tier (canary → gate → promote → instant rollback).

    PYTHONPATH=src python examples/torch_train_ft.py               # on the GPU
    PYTHONPATH=src python examples/torch_train_ft.py --device cpu  # on the host
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import ChunkStore
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.ft.manager import CheckpointManager
from repro_torch.ft.publish import DeltaPublishCallback
from repro_torch.serve.cluster import ClusterRouter, FunctionCatalog
from repro_torch.serve.deploy import RolloutController, TokenHealthGate
from repro_torch.serve.node import FixedTTLPolicy, NodeScheduler
from repro_torch.train.loop import LoopConfig, SimulatedFailure, train_loop
from repro_torch.train.steps import TrainStepConfig


def main(device=None):
    """``device`` None is the GPU."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    tcfg = TrainStepConfig(remat="dots", num_microbatches=2)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8))

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3, anchor_every=2)
        print("== training, failure injected at step 17")
        try:
            train_loop(cfg, tcfg, LoopConfig(steps=30, ckpt_every=5, fail_at_step=17),
                       data, mgr, on_step=lambda s, m: (s % 5 == 0) and print(
                           f"  step {s:3d} loss {m['loss']:.4f}"), device=device)
        except SimulatedFailure as e:
            print(f"  !! {e}")
        mgr.wait()
        print(f"== node replaced; resuming from step {mgr.latest_step()} (JIF restore)")
        out = train_loop(cfg, tcfg, LoopConfig(steps=30, ckpt_every=5), data, mgr,
                         on_step=lambda s, m: (s % 5 == 0) and print(
                             f"  step {s:3d} loss {m['loss']:.4f}"), device=device)
        print(f"== done: final loss {out['losses'][-1]:.4f}, "
              f"{len(mgr.history)} checkpoints on disk "
              f"({sum(h['bytes_written'] for h in mgr.history)/1e6:.1f} MB written, "
              f"incremental dedup vs anchors)")

        # ---- act 2: the train->serve continuous-delta pipeline ----------
        print("== publishing trained params as serving function 'assistant'")
        store = ChunkStore(f"{d}/cas")
        catalog = FunctionCatalog(chunk_store=store, device=device)
        catalog.publish("assistant", cfg, out["params"], d,
                        warm_ttl_s=3600.0, formats=("jif",))
        node = NodeScheduler(registry=catalog.registry,
                             keepalive=FixedTTLPolicy(3600.0), device=device)
        router = ClusterRouter(catalog, [node])
        deploy = RolloutController(catalog, seed=0, dirpath=d).attach(router)

        base_params = dict(out["params"])

        def merge(state):
            # parameter-efficient publish: serve the base with just the
            # tuned head grafted on -> the delta pays for the head only
            merged = dict(base_params)
            merged["final_norm"] = state["params"]["final_norm"]
            return merged

        cb = DeltaPublishCallback(deploy, "assistant", cfg, every=1,
                                  canary_fraction=0.5, extract=merge)
        ft_mgr = CheckpointManager(f"{d}/ft", async_save=True, callbacks=[cb])
        print("== fine-tuning; every checkpoint delta-publishes a canary")
        train_loop(cfg, tcfg, LoopConfig(steps=4, ckpt_every=2, seed=1),
                   data, ft_mgr, device=device)
        for rec in cb.published:
            print(f"  published {rec.name} (step {rec.step}): "
                  f"{rec.private_bytes/1e3:.0f} KB delta vs "
                  f"{rec.total_bytes/1e6:.1f} MB full image")
        canary = deploy.canary("assistant")
        print(f"== canary {canary.name} taking "
              f"{deploy.lineage('assistant').canary_fraction:.0%} of traffic")
        prompt = np.array([[3, 1, 4, 1, 5, 9]], dtype=np.int32)
        served = [router.invoke("assistant", prompt, max_new_tokens=2,
                                mode="spice", cfg=cfg).function
                  for _ in range(6)]
        print(f"  A/B split served versions: {sorted(set(served))}")
        ok = deploy.evaluate_canary(
            "assistant", prompt, gate=TokenHealthGate(cfg.vocab_size),
            n_probes=2, max_new_tokens=2, cfg=cfg)
        print(f"== gate {'passed -> promoted' if ok else 'failed -> rejected'} "
              f"{canary.name}; stable is now "
              f"v{deploy.current('assistant').version}")
        back = deploy.rollback("assistant")
        print(f"== instant rollback -> v{back.version} "
              f"(pointer repoint, zero new bytes published)")
        print(f"  retired after GC: {deploy.gc_retired('assistant')}")
        store.audit()
        router.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
