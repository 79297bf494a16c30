"""The port's serving path against the JAX package's, on the same weights.

Generation, cold starts through ``ServerlessNode`` under every restore mode
and install policy, JIFs crossing between the two packages, the staging
buffer hazard of the eager install, and bf16 leaves through publish and
restore.  Everything runs on the CPU, where the kernels' wrappers take
their plain versions.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import BaseImage as JBaseImage
from repro.core import SpiceRestorer as JRestorer
from repro.models import lm as jlm
from repro.serve.engine import ServerlessNode as JNode
from repro.serve.instance import generate as jgenerate
from repro.serve.instance import layerwise_state as jlayerwise
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import BaseImage, BufferPool, SpiceRestorer, snapshot
from repro_torch.core.treeutil import flatten_state
from repro_torch.interop import params_from_jax, to_numpy
from repro_torch.serve.engine import ServerlessNode, generate, layerwise_state

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], dtype=np.int32)
CPU = "cpu"


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    cfg = get_config(ARCH).reduced()
    tcfg = t_get_config(ARCH).reduced()
    params = jlm.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    tuned = dict(params, final_norm=params["final_norm"] + 0.01)
    np_tuned = dict(np_params, final_norm=np_params["final_norm"] + np.float32(0.01))
    # the JAX node's tokens for the fine-tune published against a base image
    d = tmp_path_factory.mktemp("jax-node")
    node = JNode()
    try:
        node.node_cache.put(JBaseImage.from_state("base", jlayerwise(cfg, params)),
                            evictable=False)
        node.publish("fn", cfg, tuned, str(d), base_name="base")
        want = node.invoke("fn", PROMPT, 4, mode="spice", cfg=cfg).tokens
    finally:
        node.close()
    return {
        "cfg": cfg, "tcfg": tcfg, "params": params, "tuned": tuned,
        "tparams": params_from_jax(np_params, CPU),
        "ttuned": params_from_jax(np_tuned, CPU), "want": want, "d": d,
    }


@pytest.mark.parametrize("S", [4, 8])
def test_generate_matches_jax(zoo, S):
    cfg, tcfg = zoo["cfg"], zoo["tcfg"]
    prompt = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = jgenerate(cfg, None, jlayerwise(cfg, zoo["params"]), prompt, 4)
    got, ttft = generate(tcfg, None, layerwise_state(tcfg, zoo["tparams"]), prompt, 4,
                         device=CPU)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and ttft > 0


def _publish_ft(node, tcfg, zoo, d, **kw):
    node.node_cache.put(
        BaseImage.from_state("base", layerwise_state(tcfg, zoo["tparams"])),
        evictable=False,
    )
    return node.publish("fn", tcfg, zoo["ttuned"], str(d), base_name="base", **kw)


@pytest.mark.parametrize("install", ["eager", "host", "fused"])
@pytest.mark.parametrize("mode", ["spice", "spice_sync", "criu_star"])
def test_cold_invoke_matches_jax_node(zoo, tmp_path, install, mode, monkeypatch):
    from repro_torch.kernels.overlay_patch import ops

    patched = []
    plain = ops.overlay_patch_plain
    monkeypatch.setattr(ops, "overlay_patch_plain",
                        lambda *a: patched.append(1) or plain(*a))
    node = ServerlessNode(device=CPU, install=install)
    try:
        _publish_ft(node, zoo["tcfg"], zoo, tmp_path)
        r = node.invoke("fn", PROMPT, 4, mode=mode, cfg=zoo["tcfg"])
        assert r.cold
        assert node.scheduler.drain_residual()
        np.testing.assert_array_equal(r.tokens, zoo["want"])
        node.memory.audit()
        if install == "fused" and mode.startswith("spice"):
            # BASE pages came through the overlay patch's plain version
            assert patched and r.stats["patched_on_device_bytes"] > 0
            assert node.scheduler.upload_stream.snapshot_stats()["failures"] == 0
        else:
            assert not patched
    finally:
        node.close()


def test_cross_restore_jax_jif_in_port(zoo, tmp_path):
    """One JIF format: a JIF the JAX package published restores in the
    port (and generates the same tokens)."""
    cfg, tcfg = zoo["cfg"], zoo["tcfg"]
    jnode = JNode()
    try:
        spec = jnode.publish("fn", cfg, zoo["params"], str(tmp_path), formats=("jif",))
        want = jnode.invoke("fn", PROMPT, 4, mode="spice_sync", cfg=cfg).tokens
    finally:
        jnode.close()
    r = SpiceRestorer(transform=None)
    state, _, _, _ = r.restore(spec.jif_path)
    r.iosched.shutdown()
    got, _ = generate(tcfg, None, state, PROMPT, 4, device=CPU)
    np.testing.assert_array_equal(got, want)


def test_cross_restore_port_jif_in_jax(zoo, tmp_path):
    cfg, tcfg = zoo["cfg"], zoo["tcfg"]
    node = ServerlessNode(device=CPU)
    try:
        spec = node.publish("fn", tcfg, zoo["tparams"], str(tmp_path), formats=("jif",))
        want = node.invoke("fn", PROMPT, 4, mode="spice_sync", cfg=tcfg).tokens
    finally:
        node.close()
    r = JRestorer()
    state, _, _, _ = r.restore(spec.jif_path)
    r.iosched.shutdown()
    got, _ = jgenerate(cfg, None, state, PROMPT, 4)
    np.testing.assert_array_equal(got, want)


def test_eager_install_never_aliases_the_staging_buffer(zoo, tmp_path):
    """The pool recycles a staging buffer as soon as its tensor is
    installed: writing into the recycled buffer must not reach the
    installed tensor (on the CPU a torch view would alias it)."""
    tcfg = zoo["tcfg"]
    state = layerwise_state(tcfg, zoo["tparams"])
    path = str(tmp_path / "fn.jif")
    snapshot(state, path)
    node = ServerlessNode(device=CPU, install="eager")
    try:
        transform, _ = node.scheduler._install_policy()
    finally:
        node.close()
    pool = BufferPool(prezero=False)  # released buffers keep their bytes
    r = SpiceRestorer(pool=pool, transform=transform)
    restored, _, _, _ = r.restore(path)
    r.iosched.shutdown()
    free = [b for bufs in pool._free.values() for b in bufs]
    assert free  # every staging buffer went back to the pool
    for buf in free:
        buf[:] = 0xFF
    for (n1, a), (n2, b) in zip(flatten_state(state)[0], flatten_state(restored)[0]):
        assert n1 == n2 and isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=n1)


@pytest.mark.parametrize("install", ["host", "eager", "fused"])
def test_bf16_leaf_round_trips_publish_restore(zoo, tmp_path, install):
    """A bf16 leaf published as a delta against a base image (one private
    page of four) restores bit for bit under every install policy; the
    fused one patches it from the base's pages."""
    from repro_torch.core import NodeImageCache

    rng = np.random.default_rng(5)
    w = rng.standard_normal((256, 512)).astype(ml_dtypes.bfloat16)  # 4 pages
    base_state = {"w": w, "b": rng.standard_normal(96).astype(np.float32)}
    tuned = dict(base_state, w=w.copy())
    tuned["w"][:64] = ml_dtypes.bfloat16(0.5)  # page 0 becomes private
    cache = NodeImageCache()
    img = BaseImage.from_state("bf16-base", base_state)
    cache.put(img, evictable=False)
    path = str(tmp_path / "bf16.jif")
    snapshot(tuned, path, base=img)
    node = ServerlessNode(device=CPU, install=install)
    try:
        transform, dpath = node.scheduler._install_policy()
        r = SpiceRestorer(node_cache=cache, transform=transform, device_path=dpath)
        out, _, _, stats = r.restore(path)
        r.iosched.shutdown()
    finally:
        node.close()
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(out["w"]).view(np.int16),
                                  tuned["w"].view(np.int16))
    np.testing.assert_array_equal(np.asarray(out["b"]), tuned["b"])
    if install == "fused":
        assert stats.patched_on_device_bytes >= tuned["w"].nbytes
        assert stats.uploaded_bytes < tuned["w"].nbytes


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None  # numpy has no bf16 without it
from repro_torch.core import SpiceRestorer
r = SpiceRestorer()
out, _, _, _ = r.restore(sys.argv[1])
r.iosched.shutdown()
w = out["w"]
assert str(w.dtype) == "torch.bfloat16", w.dtype
print(w.view(__import__("torch").int16).numpy().tobytes().hex())
"""


def test_bf16_restore_needs_no_ml_dtypes(tmp_path):
    w = np.random.default_rng(6).standard_normal((8, 16)).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "bf16.jif")
    snapshot({"w": w}, path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [p for p in sys.path if p.endswith("src")] + [os.environ.get("PYTHONPATH", "")]
    ))
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, path], capture_output=True,
                         text=True, timeout=120, check=True, env=env).stdout.strip()
    assert out == w.view(np.int16).tobytes().hex()


def test_serve_cli_runs_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--requests", "2", "--prompt-len", "4",
        "--max-new", "2",
    ])
    serve.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["req", "path", "ttft_ms", "total_ms"]
    assert [line.split()[1] for line in out[1:3]] == ["spice", "spice"]
