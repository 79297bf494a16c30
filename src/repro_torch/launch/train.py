"""The port's training command line, end to end.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 50 --ckpt-dir /tmp/ckpt [--fail-at 20] [--full-config] \\
      [--device cuda]

The counterpart of ``repro.launch.train``: the reduced config unless
``--full-config``; ``--device`` defaults to the GPU and raises where there
is none (``--device cpu`` runs on the host).  With ``--ckpt-dir`` a run
resumes from the directory's latest checkpoint.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.ft.health import HealthMonitor
from repro_torch.ft.manager import CheckpointManager
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import TrainStepConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    tcfg = TrainStepConfig(remat=args.remat, num_microbatches=args.microbatches)
    data = SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                   global_batch=args.global_batch)
    )
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    mon = HealthMonitor(["host0"])

    def on_step(step, m):
        mon.heartbeat("host0", m["step_s"])
        if step % 10 == 0:
            print(f"step {step:5d}  loss {m['loss']:.4f}  {m['step_s']*1e3:.0f} ms")

    lcfg = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                      fail_at_step=args.fail_at)
    out = train_loop(cfg, tcfg, lcfg, data, mgr, on_step=on_step, device=args.device)
    print(f"done: {len(out['losses'])} steps, final loss {out['losses'][-1]:.4f}, "
          f"{out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
