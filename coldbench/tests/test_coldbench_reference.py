"""The plain reference against the port's CPU path at the tests' size: the
same seeded weights and prompts, greedy tokens equal and every step's
logits within f32 rounding, the fine-tune makers as the port's tests make
them, and the frozen work counts against the shapes they count."""
import contextlib

import numpy as np
import pytest
import torch

from coldbench import spec
from coldbench.costs import decode_attention, overlay_patch, ssd_scan
from coldbench.reference import finetunes, weights
from coldbench.tests import small

LOGITS_TOL = 1e-5  # f32 on both sides, summed in other orders


@contextlib.contextmanager
def recorded_logits(into):
    from repro_torch.serve import instance

    real = instance.unembed

    def unembed(cfg, p, x, dt):
        out = real(cfg, p, x, dt)
        into.append(out[:, -1].clone())
        return out

    instance.unembed = unembed
    try:
        yield into
    finally:
        instance.unembed = real


def greedy(ref, config, params, prompt, n):
    toks = torch.zeros((prompt.shape[0], 0), dtype=torch.long)
    for _ in range(n):
        logits = ref.served_logits(config, params, prompt, torch.cat(
            [toks, toks.new_zeros((prompt.shape[0], 1))], dim=1))
        toks = torch.cat([toks, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    return toks


@pytest.mark.parametrize("name,function", [("qwen1.5-0.5b", "fn-ft-1"),
                                           ("mamba2-780m", "fn-rnn")])
def test_reference_equals_the_port(name, function):
    from repro_torch.serve.engine import generate, layerwise_state

    config = small.config(name)
    ref = spec.reference(config)
    base = weights.draw(ref.leaf_specs(config), 2**31 + 5, "cpu")
    params = finetunes.make(base, config, config["functions"][function])
    prompt = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(np.int32)
    torch.exp(torch.full((1 << 15,), -0.3))  # a fresh process's first vectorized exp
    with recorded_logits([]) as got:
        toks, _ = generate(spec.program_config(config), None,
                           layerwise_state(spec.program_config(config), params), prompt, 8,
                           device="cpu")
    want = ref.served_logits(config, params, prompt, torch.as_tensor(toks.astype(np.int64)))
    got = torch.stack(got, dim=1)
    assert float((got - want).abs().max() / want.abs().max()) < LOGITS_TOL
    assert np.array_equal(greedy(ref, config, params, prompt, 8).numpy(), toks)


def test_fine_tunes_touch_what_they_say():
    config = small.config("qwen1.5-0.5b")
    base = weights.draw(spec.reference(config).leaf_specs(config), 1, "cpu")
    ft = [finetunes.make(base, config, config["functions"][f]) for f in ("fn-ft-0", "fn-ft-1")]
    wo = base["pattern"][0]["attn"]["wo"]
    # at d_model 64 a 64 KiB page is 256 rows, more than wo has: page 0 takes them all
    assert torch.allclose(ft[0]["pattern"][0]["attn"]["wo"] - wo, torch.tensor(0.01))
    assert torch.equal(ft[1]["pattern"][0]["attn"]["wo"], wo)
    assert torch.allclose(ft[1]["final_norm"] - base["final_norm"], torch.tensor(0.02))
    assert ft[1]["pattern"][0]["mlp"]["w_up"] is base["pattern"][0]["mlp"]["w_up"]
    m = small.config("mamba2-780m")
    mb = weights.draw(spec.reference(m).leaf_specs(m), 1, "cpu")
    rnn = finetunes.make(mb, m, m["functions"]["fn-rnn"])
    w, w0 = rnn["pattern"][0]["mamba"]["in_proj"], mb["pattern"][0]["mamba"]["in_proj"]
    assert torch.equal(w[:1], w0[:1]) and torch.allclose(w[1:], w0[1:] * 1.10)
    assert "unembed" not in rnn["embed"]  # tied, as published: the table is the head
    assert torch.allclose(rnn["embed"]["tok"], mb["embed"]["tok"] * 1.05)


def test_draw_repeats_from_the_seed():
    config = small.config("mamba2-780m")
    specs = spec.reference(config).leaf_specs(config)
    a, b = weights.draw(specs, 2**40 + 3, "cpu"), weights.draw(specs, 2**40 + 3, "cpu")
    c = weights.draw(specs, 2**40 + 4, "cpu")
    pairs = list(zip(weights.leaves(a), weights.leaves(b), weights.leaves(c)))
    assert all(torch.equal(x, y) for (_, x), (_, y), _ in pairs)
    assert not all(torch.equal(x, z) for (_, x), _, (_, z) in pairs)


def test_frozen_counts():
    # the port's own counts at the PERF.md table's path shapes (bytes)
    assert decode_attention.call_work(2, 16, 16, 64, 16, 19)[1] == 278528
    assert ssd_scan.call_work(2, 16, 48, 64, 1, 128)[1] == 3971072
    t = torch.zeros(3 * overlay_patch.PAGE // 4)
    base = t.clone()
    t[0] = 1.0  # page 0 private, page 1 zero, page 2 ... zero
    base[-1] = 2.0  # page 2 of the base differs, the tensor's page 2 is zero
    patched, nbytes = overlay_patch.tensor_work(t, base)
    assert patched and nbytes == 3 * overlay_patch.PAGE + overlay_patch.PAGE + 24
    assert overlay_patch.tensor_work(t + 5.0, base)[0] is False  # every page private
