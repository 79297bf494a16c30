"""The port's twin of ``tests/test_engine.py``: publish -> cold start under
every restore mode -> warm; all modes must produce identical tokens, and
they must be the JAX package's on the same weights.  On the card (``gpu``)
the five modes run again at the reduced config on a node with the fused
install, through the CUDA kernels, and must give the CPU's tokens."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro_torch.configs import get_config
from repro_torch.core import BaseImage
from repro_torch.models import lm
from repro_torch.serve.engine import ServerlessNode, layerwise_state
from torch_twins import CPU, DEVICES, jax_params, jax_tokens, need_device, port_params

ARCH = "qwen1.5-0.5b"
MODES = ["spice", "spice_sync", "criu_star", "reap_star", "faasnap_star"]
PROMPT = np.array([[5, 6, 7, 8, 9, 10]], dtype=np.int32)


def _node(d, device, **kw):
    """A node on ``device`` with ``f1`` published in every format (JIF,
    CRIU* and the monolith) and a residual ``extra_state``."""
    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(device=device, **kw)
    node.publish("f1", cfg, port_params(jax_params(jget_config(ARCH).reduced(), 0), device),
                 str(d), warm_ttl_s=60.0,
                 extra_state={"opt_m": np.ones((1 << 16,), np.float32)})
    return node, cfg


@pytest.fixture(scope="module")
def node_with_fn(tmp_path_factory):
    node, cfg = _node(tmp_path_factory.mktemp("fns"), CPU)
    yield node, cfg
    node.close()


@pytest.fixture(scope="module")
def want():
    """The JAX package's tokens for ``f1``'s weights."""
    jcfg = jget_config(ARCH).reduced()
    return jax_tokens(jcfg, jax_params(jcfg, 0), PROMPT, 6)


def _all_modes(node, cfg):
    outs = {}
    for mode in MODES:
        node.evict()
        r = node.invoke("f1", PROMPT, max_new_tokens=6, mode=mode, cfg=cfg)
        assert r.cold
        outs[mode] = r.tokens
    node.memory.audit()
    return outs


@pytest.mark.parametrize("device", DEVICES)
def test_all_modes_agree(node_with_fn, want, tmp_path, device):
    need_device(device)
    if device == CPU:
        node, cfg = node_with_fn
        outs = _all_modes(node, cfg)
    else:
        node, cfg = _node(tmp_path, device, install="fused")
        try:
            outs = _all_modes(node, cfg)
            assert node.scheduler.upload_stream.snapshot_stats()["failures"] == 0
        finally:
            node.close()
    for mode, toks in outs.items():
        np.testing.assert_array_equal(toks, want, err_msg=mode)
    assert outs["spice"].shape == (1, 6)


def test_warm_path_matches_cold(node_with_fn):
    node, cfg = node_with_fn
    node.evict()
    cold = node.invoke("f1", PROMPT, max_new_tokens=4, mode="spice", cfg=cfg)
    warm = node.invoke("f1", PROMPT, max_new_tokens=4, cfg=cfg)
    assert cold.cold and not warm.cold
    np.testing.assert_array_equal(cold.tokens, warm.tokens)
    assert warm.total_s <= cold.total_s + 1.0


def test_generation_matches_lm_forward(node_with_fn):
    """Engine layerwise generation == monolithic lm.prefill/decode path."""
    node, cfg = node_with_fn
    node.evict()
    r = node.invoke("f1", PROMPT, max_new_tokens=3, mode="spice_sync", cfg=cfg)

    params = port_params(jax_params(jget_config(ARCH).reduced(), 0))
    logits, caches, _ = lm.prefill(
        cfg, params, {"tokens": torch.from_numpy(PROMPT)}, compute_dtype=torch.float32
    )
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = PROMPT.shape[1]
    for _ in range(2):
        logits, caches, _ = lm.decode_step(
            cfg, params, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32)},
            caches, pos, compute_dtype=torch.float32,
        )
        toks.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    np.testing.assert_array_equal(r.tokens[0], np.asarray(toks))


def test_layerwise_state_roundtrip(node_with_fn):
    node, cfg = node_with_fn
    params = port_params(jax_params(jget_config(ARCH).reduced(), 0))
    state = layerwise_state(cfg, params)
    assert len(state["layers"]) == cfg.n_layers
    np.testing.assert_array_equal(
        state["layers"][0]["attn"]["wq"], params["pattern"][0]["attn"]["wq"][0].numpy()
    )


def test_base_image_dedup_across_finetunes(tmp_path):
    """Two functions sharing a base: the second one's JIF is mostly BASE."""
    cfg = get_config(ARCH).reduced()
    params = port_params(jax_params(jget_config(ARCH).reduced(), 0))
    node = ServerlessNode(device=CPU)
    try:
        base_state = layerwise_state(cfg, params)
        node.node_cache.put(BaseImage.from_state("base-lm", base_state))

        # fine-tune: perturb only the first layer
        attn = dict(params["pattern"][0]["attn"])
        attn["wq"] = attn["wq"] + 0.5
        ft = dict(params, pattern=[dict(params["pattern"][0], attn=attn)])
        from repro_torch.core.snapshot import snapshot as jif_snapshot

        stats = jif_snapshot(
            layerwise_state(cfg, ft), str(tmp_path / "ft.jif"),
            base=node.node_cache.get("base-lm"),
        )
        assert stats.base_bytes > 0.5 * stats.total_bytes
        assert stats.private_bytes < 0.5 * stats.total_bytes
    finally:
        node.close()
