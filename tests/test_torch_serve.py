"""The port's serving path against the JAX package's, on the same weights.

Generation, cold starts through ``ServerlessNode`` under every restore mode
and install policy, JIFs crossing between the two packages, the staging
buffer hazard of the eager install, and bf16 leaves through publish and
restore; the Mamba2 family (``mamba2-780m`` reduced) through generation, a
fused cold start and the JIF crossing; the MoE family (``olmoe-1b-7b``
reduced) through a fused cold start and the JIF crossing.  Everything runs on the CPU, where
the kernels' wrappers take their plain versions.
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
from repro_torch.interop import params_from_jax
from torch_twins import to_numpy
from repro_torch.serve.engine import ServerlessNode, generate, layerwise_state

ARCH = "qwen1.5-0.5b"
SSM_ARCH = "mamba2-780m"
MOE_ARCH = "olmoe-1b-7b"
PROMPT = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], dtype=np.int32)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """On some CPUs the first vectorized ``torch.exp`` of a fresh process
    was seen off in the fourth significant digit; every later call was
    exact to f32.  One warm-up call keeps the comparisons below about the
    algorithm."""
    torch.exp(torch.full((1 << 15,), -0.3))


def _zoo(arch, tmp_path_factory):
    cfg = get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
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


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    return _zoo(ARCH, tmp_path_factory)


@pytest.fixture(scope="module")
def ssm_zoo(tmp_path_factory):
    return _zoo(SSM_ARCH, tmp_path_factory)


@pytest.fixture(scope="module")
def moe_zoo(tmp_path_factory):
    return _zoo(MOE_ARCH, tmp_path_factory)


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
@pytest.mark.parametrize("mode", ["spice", "spice_sync", "criu_star", "reap_star",
                                  "faasnap_star"])
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


# ------------------------------------------------------------ Mamba2
@pytest.mark.parametrize("S", [4, 8])
def test_mamba_generate_matches_jax(ssm_zoo, S):
    cfg, tcfg = ssm_zoo["cfg"], ssm_zoo["tcfg"]
    assert tcfg.pattern[0].kind == "mamba"
    prompt = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = jgenerate(cfg, None, jlayerwise(cfg, ssm_zoo["params"]), prompt, 4)
    got, _ = generate(tcfg, None, layerwise_state(tcfg, ssm_zoo["tparams"]), prompt, 4,
                      device=CPU)
    np.testing.assert_array_equal(got, want)


def test_mamba_generate_refuses_indivisible_prompt(ssm_zoo):
    """A 12-token prompt at chunk 8: the reference asserts, the port raises."""
    cfg, tcfg = ssm_zoo["cfg"], ssm_zoo["tcfg"]
    prompt = np.ones((1, 12), np.int32)
    with pytest.raises(AssertionError, match="seq 12 not divisible by chunk 8"):
        jgenerate(cfg, None, jlayerwise(cfg, ssm_zoo["params"]), prompt, 2)
    with pytest.raises(ValueError, match="seq 12 not divisible by chunk 8"):
        generate(tcfg, None, layerwise_state(tcfg, ssm_zoo["tparams"]), prompt, 2, device=CPU)


def test_mamba_cold_fused_invoke_matches_jax_node(ssm_zoo, tmp_path):
    """A fine-tune published against a base image, cold-started with Spice
    and the fused install: the sub-page leaves (A_log, D, dt_bias) and the
    conv weights patch from the base like every other tensor."""
    node = ServerlessNode(device=CPU, install="fused")
    try:
        _publish_ft(node, ssm_zoo["tcfg"], ssm_zoo, tmp_path)
        r = node.invoke("fn", PROMPT, 4, mode="spice", cfg=ssm_zoo["tcfg"])
        assert r.cold and r.stats["patched_on_device_bytes"] > 0
        assert node.scheduler.drain_residual()
        np.testing.assert_array_equal(r.tokens, ssm_zoo["want"])
        node.memory.audit()
        assert node.scheduler.upload_stream.snapshot_stats()["failures"] == 0
    finally:
        node.close()


def _jif_crosses(zoo, tmp_path, direction):
    """A JIF published by one package restores in the other and generates
    the publisher's tokens."""
    cfg, tcfg = zoo["cfg"], zoo["tcfg"]
    if direction == "jax_to_port":
        node, pcfg, params = JNode(), cfg, zoo["params"]
    else:
        node, pcfg, params = ServerlessNode(device=CPU), tcfg, zoo["tparams"]
    try:
        spec = node.publish("fn", pcfg, params, str(tmp_path), formats=("jif",))
        want = node.invoke("fn", PROMPT, 4, mode="spice_sync", cfg=pcfg).tokens
    finally:
        node.close()
    if direction == "jax_to_port":
        r = SpiceRestorer(transform=None)
        state, _, _, _ = r.restore(spec.jif_path)
        got, _ = generate(tcfg, None, state, PROMPT, 4, device=CPU)
    else:
        r = JRestorer()
        state, _, _, _ = r.restore(spec.jif_path)
        got, _ = jgenerate(cfg, None, state, PROMPT, 4)
    r.iosched.shutdown()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mamba_jif_crosses_packages(ssm_zoo, tmp_path, direction):
    _jif_crosses(ssm_zoo, tmp_path, direction)


# ------------------------------------------------------------ MoE
def test_moe_cold_fused_invoke_matches_jax_node(moe_zoo, tmp_path):
    """A fine-tune of reduced olmoe published against a base image and
    cold-started with Spice and the fused install: the router and expert
    leaves patch from the base like every other tensor."""
    node = ServerlessNode(device=CPU, install="fused")
    try:
        _publish_ft(node, moe_zoo["tcfg"], moe_zoo, tmp_path)
        r = node.invoke("fn", PROMPT, 4, mode="spice", cfg=moe_zoo["tcfg"])
        assert r.cold and r.stats["patched_on_device_bytes"] > 0
        assert node.scheduler.drain_residual()
        np.testing.assert_array_equal(r.tokens, moe_zoo["want"])
        node.memory.audit()
    finally:
        node.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_moe_jif_crosses_packages(moe_zoo, tmp_path, direction):
    _jif_crosses(moe_zoo, tmp_path, direction)


@pytest.mark.parametrize("arch", [ARCH, SSM_ARCH, MOE_ARCH, "qwen2-vl-7b", "musicgen-large",
                                  "qwen3-32b", "starcoder2-7b", "phi3.5-moe-42b-a6.6b"])
def test_serve_cli_runs_on_cpu(capsys, monkeypatch, arch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--device", "cpu", "--requests", "2",
        "--prompt-len", "4", "--max-new", "2",
    ])
    serve.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["req", "path", "ttft_ms", "total_ms"]
    assert [line.split()[1] for line in out[1:3]] == ["spice", "spice"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernels", [(ARCH, {"flash_attention", "decode_attention"}),
                                          (SSM_ARCH, {"ssd_scan"}),
                                          (MOE_ARCH, {"flash_attention", "decode_attention"}),
                                          ("qwen2-vl-7b", {"flash_attention", "decode_attention"}),
                                          ("musicgen-large",
                                           {"flash_attention", "decode_attention"}),
                                          ("qwen3-32b", {"flash_attention", "decode_attention"}),
                                          ("starcoder2-7b",
                                           {"flash_attention", "decode_attention"}),
                                          ("phi3.5-moe-42b-a6.6b",
                                           {"flash_attention", "decode_attention"})])
def test_serve_cli_runs_on_gpu(capsys, monkeypatch, arch, kernels):
    """The CLI as a user runs it: the card by default and the reduced
    configuration, whose head dim of 16 the attention kernels take
    zero-padded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import launch_counters
    from repro_torch.launch import serve

    before = {n: c.count for n, c in launch_counters().items()}
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--requests", "2", "--prompt-len", "4", "--max-new", "2",
    ])
    serve.main()
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in out[1:3]] == ["spice", "spice"]
    launched = {n for n, c in launch_counters().items() if c.count > before[n]}
    assert kernels <= launched
