"""The port's sharded paths on 8 ``gloo`` ranks, the counterpart of
``tests/test_distributed.py``: the vocab-parallel embedding, the MoE's
expert parallelism (all-to-all dispatch for a train forward, replicated
routing with a sum for decode), a sharded train step and the elastic
reshard.  A process group is per process, so a subprocess spawns the ranks
(``tests/torch_distributed_check.py``); the JAX package's single-device
results come from this process, on the same numpy weights and inputs.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import lm
from repro.train.optim import adamw_init
from repro.train.steps import TrainStepConfig, make_train_step

SCRIPT = Path(__file__).parent / "torch_distributed_check.py"
SRC = str(Path(__file__).resolve().parents[1] / "src")
CHECKS = ["moe", "moe_decode", "train", "elastic"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    """Each check's numpy weights and inputs, and the JAX package's local
    results on them (as ``tests/distributed_check.py`` computes its oracle)."""
    from repro_torch.core.treeutil import flatten_state
    from repro_torch.interop import params_from_jax

    rng = np.random.default_rng(0)
    out = {}
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), capacity_factor=8.0)
    params = lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    logits, _, aux = jax.jit(lambda p, t: lm.forward(cfg, p, {"tokens": t}, mode="train",
                                                     compute_dtype=jnp.float32))(params, toks)
    out["moe"] = {"params": _np(params), "tokens": toks, "jax_logits": np.asarray(logits),
                  "jax_aux": float(aux)}

    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(), capacity_factor=8.0)
    params = lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    caches = lm.init_cache(cfg, 4, 32, kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    toks = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    logits, _, _ = jax.jit(lambda p, t, c: lm.decode_step(
        cfg, p, {"tokens": t}, c, jnp.int32(3), compute_dtype=jnp.float32))(params, toks, caches)
    out["moe_decode"] = {"params": _np(params), "tokens": toks, "jax_logits": np.asarray(logits)}

    cfg = get_config("qwen1.5-0.5b").reduced()
    params = lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "targets")}
    tcfg = TrainStepConfig(remat="dots", compute_dtype="float32", num_microbatches=2,
                           kv_repeat=2)
    p_ref, _, m_ref = jax.jit(make_train_step(cfg, tcfg))(params, adamw_init(params), batch)
    out["train"] = {"params": _np(params), **batch, "jax_loss": float(m_ref["loss"]),
                    "jax_params": {k: v.numpy() for k, v in
                                   dict(flatten_state(params_from_jax(_np(p_ref), "cpu"))[0]).items()}}
    out["elastic"] = {"params": _np(params)}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    inputs, outputs = tmp / "inputs.pkl", tmp / "results.json"
    with open(inputs, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, str(SCRIPT), str(inputs), str(outputs)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, f"stdout:\n{run.stdout}\nstderr:\n{run.stderr[-4000:]}"
    return json.loads(outputs.read_text())


@pytest.mark.parametrize("which", CHECKS)
def test_torch_distributed(results, which):
    got = results[which]
    assert got["ok"], "\n".join(got["errors"])[-4000:]
