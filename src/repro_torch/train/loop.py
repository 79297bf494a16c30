"""Training loop with checkpoint/restart, health hooks, and failure
injection (for tests and examples); the counterpart of
``repro.train.loop``, on one device."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.ft.manager import CheckpointManager
from repro_torch.interop import to_torch, tree_map
from repro_torch.train.steps import TrainStepConfig, init_train_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 50
    ckpt_every: int = 10
    log_every: int = 10
    seed: int = 0
    fail_at_step: Optional[int] = None  # failure injection


class SimulatedFailure(RuntimeError):
    pass


def train_loop(
    cfg: ModelConfig,
    tcfg: TrainStepConfig,
    lcfg: LoopConfig,
    data: SyntheticLM,
    mgr: Optional[CheckpointManager] = None,
    on_step: Optional[Callable[[int, Dict], None]] = None,
    device=None,
) -> Dict:
    """Runs/resumes training on ``device`` (None: the GPU); returns final
    metrics + history.  A resume restores the manager's latest checkpoint:
    its leaves are host views (numpy, or CPU torch tensors for bf16) into
    the restorer's buffers, copied onto the device here."""
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        restored, start = mgr.restore()
        params, opt = tree_map(lambda a: to_torch(a, dev, copy=True),
                               (restored["params"], restored["opt"]))
        start += 1
    else:
        params, opt = init_train_state(cfg, lcfg.seed, device=dev)

    losses: List[float] = []
    t_begin = time.perf_counter()
    for step in range(start, lcfg.steps):
        if lcfg.fail_at_step is not None and step == lcfg.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step is not None:
            on_step(step, {"loss": loss, "step_s": time.perf_counter() - t0})
        if mgr is not None and (step + 1) % lcfg.ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt})
    if mgr is not None:
        mgr.wait()
    return {
        "params": params,
        "opt": opt,
        "losses": losses,
        "last_step": lcfg.steps - 1,
        "wall_s": time.perf_counter() - t_begin,
    }
