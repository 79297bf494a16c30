"""A bf16 function through the port's host side with ``ml_dtypes``
unimportable, as on a machine without JAX: publish (with its access-order
trace), a ``spice`` cold start and a warm request, the baselines' cold
starts, ``warm_state``, and a ``CheckpointManager`` save and restore.  The
port runs in a subprocess that sets ``sys.modules["ml_dtypes"] = None``
before anything is imported; the JAX package publishes and serves the same
bf16 weights in this process.  Tokens must equal the JAX package's, the
JIF its JIF apart from ``created_at``, and the checkpoint must restore bit
for bit."""
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serve.engine import ServerlessNode as JNode
from torch_twins import jax_params, jax_tokens, jif_bytes_but_created_at

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[5, 6, 7, 8, 9, 10]], dtype=np.int32)
MAX_NEW = 6

_CHILD = r"""
import sys
sys.modules["ml_dtypes"] = None  # numpy has no bf16 without it
import json, pickle
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.core.treeutil import flatten_state, leaf_bytes
from repro_torch.ft.manager import CheckpointManager
from repro_torch.interop import dtype_name, params_from_jax, tree_map
from repro_torch.serve.engine import ServerlessNode, layerwise_state

inputs, out_dir = sys.argv[1], sys.argv[2]
with open(inputs, "rb") as f:
    bits, prompt, max_new = pickle.load(f)  # bf16 leaves as int16 views
cfg = get_config("qwen1.5-0.5b").reduced()
params = tree_map(lambda t: t.view(torch.bfloat16) if t.dtype == torch.int16 else t,
                  params_from_jax(bits, "cpu"))


def bits_of(tree):
    return {n: (dtype_name(a.dtype), tuple(a.shape), leaf_bytes(a).tobytes())
            for n, a in flatten_state(tree)[0]}


res = {}
node = ServerlessNode(device="cpu")
try:
    # jif, criu and monolith; kept warm so the second request of each is warm
    spec = node.publish("fn", cfg, params, out_dir, warm_ttl_s=600.0)
    res["jif"] = spec.jif_path
    for mode in ("spice", "criu_star", "reap_star", "faasnap_star"):
        node.evict()
        cold = node.invoke("fn", prompt, max_new, mode=mode, cfg=cfg)
        warm = node.invoke("fn", prompt, max_new, mode=mode, cfg=cfg)
        res[mode] = [cold.cold, warm.cold, cold.tokens.tolist(), warm.tokens.tolist()]
    node.evict()
    node.invoke("fn", prompt, max_new, mode="spice", cfg=cfg)
    live = node.scheduler.warm_state("fn")
    res["warm_state_dtypes"] = sorted({str(a.dtype) for _, a in flatten_state(live)[0]})
    res["warm_state_exact"] = bits_of(live) == bits_of(layerwise_state(cfg, params))
finally:
    node.close()

mgr = CheckpointManager(out_dir + "/ckpt", async_save=False)
mgr.save(3, {"params": params, "step": torch.tensor(3)}, blocking=True)
restored, step = mgr.restore()
res["ckpt_step"] = step
res["ckpt_dtypes"] = sorted({dtype_name(a.dtype) for _, a in flatten_state(restored)[0]})
res["ckpt_exact"] = bits_of(restored) == bits_of({"params": params, "step": torch.tensor(3)})
try:  # the block held through every phase above: nothing put a module back
    import ml_dtypes  # noqa: F401
    res["ml_dtypes_import"] = "succeeded"
except ImportError as e:
    res["ml_dtypes_import"] = type(e).__name__
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's bf16 weights (its norms stay f32), its JIF of
    them and its tokens."""
    cfg = jget_config(ARCH).reduced()
    np_params = jax_params(cfg, 11, jnp.bfloat16)
    d = tmp_path_factory.mktemp("jax-bf16")
    node = JNode()
    try:
        spec = node.publish("fn", cfg, np_params, str(d), formats=("jif",))
        node_tokens = node.invoke("fn", PROMPT, MAX_NEW, mode="spice", cfg=cfg).tokens
    finally:
        node.close()
    tokens = jax_tokens(cfg, np_params, PROMPT, MAX_NEW)
    np.testing.assert_array_equal(node_tokens, tokens)
    bits = jax.tree.map(lambda a: a.view(np.int16) if a.dtype.name == "bfloat16" else a,
                        np_params)
    return {"jif": spec.jif_path, "tokens": tokens, "bits": bits}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    d = tmp_path_factory.mktemp("port-bf16")
    inputs = d / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((jax_side["bits"], PROMPT, MAX_NEW), f)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _CHILD, str(inputs), str(d / "fns")],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_runs_without_ml_dtypes(port_side):
    """Every phase ran to its end with the import blocked, and after them
    the child's own ``import ml_dtypes`` still failed."""
    assert {"jif", "spice", "criu_star", "reap_star", "faasnap_star", "warm_state_exact",
            "ckpt_exact"} <= set(port_side)
    assert port_side["ml_dtypes_import"] == "ModuleNotFoundError"


@pytest.mark.parametrize("mode", ["spice", "criu_star", "reap_star", "faasnap_star"])
def test_bf16_cold_and_warm_tokens_equal_jax(jax_side, port_side, mode):
    cold, warm_cold, cold_tokens, warm_tokens = port_side[mode]
    assert cold and not warm_cold
    np.testing.assert_array_equal(np.array(cold_tokens), jax_side["tokens"])
    np.testing.assert_array_equal(np.array(warm_tokens), jax_side["tokens"])


def test_bf16_jif_equals_jax_but_created_at(jax_side, port_side):
    assert jif_bytes_but_created_at(port_side["jif"]) == \
        jif_bytes_but_created_at(jax_side["jif"])


def test_bf16_warm_state_is_the_published_bits(port_side):
    assert port_side["warm_state_dtypes"] == ["float32", "torch.bfloat16"]
    assert port_side["warm_state_exact"]


def test_bf16_checkpoint_restores_bit_exact(port_side):
    assert port_side["ckpt_step"] == 3
    assert port_side["ckpt_dtypes"] == ["bfloat16", "float32", "int64"]
    assert port_side["ckpt_exact"]
