"""The port's training path (``repro_torch.{data,train}`` and the stacked
``models.lm`` forward) against the JAX package's, on the CPU.

Weights come from the JAX package's initializer and cross with
``interop.params_from_jax`` / ``train_state_from_jax`` (the two packages
initialize differently); batches come from ``SyntheticLM`` (numpy, seeded).
Tolerances: logits at f32 rtol/atol 2e-5; loss and every gradient leaf
rtol 1e-4, atol 1e-6; bf16 loss 2e-2; AdamW 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro.train import optim as joptim
from repro.train import steps as jsteps
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config
from repro_torch.core.treeutil import flatten_state
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.models import lm
from repro_torch.train import optim
from repro_torch.train import steps

CPU = "cpu"
LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _model(arch, seed=3, **replace):
    cfg = dataclasses.replace(j_get_config(arch).reduced(), **replace)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    jparams = jlm.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    return cfg, tcfg, jparams, np_params, params_from_jax(np_params, CPU)


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen1.5-0.5b")


@pytest.fixture(scope="module")
def mamba():
    return _model("mamba2-780m")


@pytest.fixture(scope="module")
def olmoe():
    return _model("olmoe-1b-7b")


@pytest.fixture(scope="module")
def by_arch(qwen, mamba, olmoe):
    return {"qwen1.5-0.5b": qwen, "mamba2-780m": mamba, "olmoe-1b-7b": olmoe}

def _batch(cfg, seq=16, batch=4, step=0):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    return data.batch_at(step)


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _named(tree):
    return {n: np.asarray(a) if not isinstance(a, torch.Tensor) else a.detach().numpy()
            for n, a in flatten_state(tree)[0]}


def _close_trees(got, want, **tol):
    g, w = _named(got), _named(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w) and g
    for name in w:
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **tol)


# ------------------------------------------------------------------- data
def test_batch_at_matches_reference():
    for seed, hosts, host in [(0, 1, 0), (5, 2, 1)]:
        kw = dict(vocab_size=256, seq_len=16, global_batch=8, seed=seed, n_hosts=hosts,
                  host_id=host)
        mine, ref = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
        for step in (0, 1, 17):
            a, b = mine.batch_at(step), ref.batch_at(step)
            assert sorted(a) == ["targets", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        it = mine.iter_from(3)
        assert np.array_equal(next(it)["tokens"], ref.batch_at(3)["tokens"])


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("arch,kw", [
    ("qwen1.5-0.5b", {}),
    # chunked queries, two stages (the second reads keys below its last query)
    ("qwen1.5-0.5b", dict(q_chunk=4, attn_stages=2)),
    # chunked queries in one stage (every chunk reads keys from 0)
    ("qwen1.5-0.5b", dict(q_chunk=4)),
    ("mamba2-780m", {}),
    ("olmoe-1b-7b", {}),
])
def test_forward_train_logits_match_reference(arch, kw, by_arch):
    cfg, tcfg, jparams, _, tparams = by_arch[arch]
    b = _batch(cfg)
    want, _, jaux = jlm.forward(cfg, jparams, _jb(b), mode="train", compute_dtype=jnp.float32,
                                remat="dots", **kw)
    got, aux = lm.forward(tcfg, tparams, _tb(b), compute_dtype=torch.float32, remat="dots",
                          **kw)
    assert aux.dtype == torch.float32
    if any(s.moe for s in tcfg.pattern):  # each MoE layer's load-balance loss, summed
        assert float(jaux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    else:
        assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOGITS_TOL)


def test_forward_train_window_chunks_match_reference():
    """A windowed layer with query chunks: each stage reads keys from its
    first query minus the window, rounded down to a chunk."""
    spec = dataclasses.replace(j_get_config("qwen1.5-0.5b").pattern[0], window=6)
    cfg, tcfg, jparams, _, tparams = _model("qwen1.5-0.5b", pattern=(spec,))
    b = _batch(cfg)
    for kw in ({}, dict(q_chunk=4, attn_stages=4)):
        want, _, _ = jlm.forward(cfg, jparams, _jb(b), mode="train", compute_dtype=jnp.float32,
                                 **kw)
        got, _ = lm.forward(tcfg, tparams, _tb(b), compute_dtype=torch.float32, **kw)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOGITS_TOL)


# ------------------------------------------------------- loss and grads
def _j_value_and_grad(cfg, jparams, b, tc):
    loss_fn = jsteps.make_loss_fn(cfg, jsteps.TrainStepConfig(**tc))
    (total, m), g = jax.value_and_grad(loss_fn, has_aux=True)(jparams, _jb(b))
    return total, m, g


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-780m", "olmoe-1b-7b"])
def test_loss_and_grads_match_reference(arch, by_arch):
    cfg, tcfg, jparams, _, tparams = by_arch[arch]
    b = _batch(cfg)
    tc = dict(remat="dots", compute_dtype="float32")
    jtotal, jm, jg = _j_value_and_grad(cfg, jparams, b, tc)
    loss_fn = steps.make_loss_fn(tcfg, steps.TrainStepConfig(**tc))
    (total, m), g = steps._value_and_grad(loss_fn, tparams, _tb(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-4)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    _close_trees(g, jg, **GRAD_TOL)


def test_loss_in_bf16_matches_reference(qwen):
    cfg, tcfg, jparams, _, tparams = qwen
    b = _batch(cfg)
    tc = dict(remat="dots", compute_dtype="bfloat16")
    _, jm, _ = _j_value_and_grad(cfg, jparams, b, tc)
    (_, m), _ = steps._value_and_grad(steps.make_loss_fn(tcfg, steps.TrainStepConfig(**tc)),
                                      tparams, _tb(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-2)


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 64)) * 4).astype(np.float32)
    targets = rng.integers(0, 64, (3, 5)).astype(np.int32)
    want = jsteps.softmax_xent(jnp.asarray(logits), jnp.asarray(targets))
    got = steps.softmax_xent(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("remat", [None, "full", "dots", "dots_no_batch"])
def test_remat_changes_no_value(remat, qwen, mamba):
    """Checkpointing recomputes the same ops: loss and every gradient are
    bit-identical to those without it."""
    for cfg, tcfg, _, _, tparams in (qwen, mamba):
        b = _tb(_batch(cfg))

        def run(r):
            tc = steps.TrainStepConfig(remat=r, compute_dtype="float32")
            return steps._value_and_grad(steps.make_loss_fn(tcfg, tc), tparams, b)

        (l0, _), g0 = run("full")
        (l1, _), g1 = run(remat)
        assert torch.equal(l0, l1)
        for (n, a), (_, c) in zip(flatten_state(g0)[0], flatten_state(g1)[0]):
            assert torch.equal(a, c), n


def test_remat_without_checkpoint_is_the_same_function(qwen):
    """The values under checkpointing equal a forward with no checkpoint at
    all (the ops run unwrapped)."""
    cfg, tcfg, _, _, tparams = qwen
    b = _tb(_batch(cfg))
    tc = steps.TrainStepConfig(remat="dots", compute_dtype="float32")
    (l_ck, _), g_ck = steps._value_and_grad(steps.make_loss_fn(tcfg, tc), tparams, b)
    real = lm._remat
    try:
        lm._remat = lambda fn, remat: fn
        (l_no, _), g_no = steps._value_and_grad(steps.make_loss_fn(tcfg, tc), tparams, b)
    finally:
        lm._remat = real
    assert torch.equal(l_ck, l_no)
    for (n, a), (_, c) in zip(flatten_state(g_ck)[0], flatten_state(g_no)[0]):
        assert torch.equal(a, c), n


def test_dots_remat_keeps_the_matrix_products(qwen):
    """Under "dots" the backward recomputes no ``mm`` (their outputs are
    saved); under "full" it recomputes every one of the forward's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    cfg, tcfg, _, _, tparams = qwen
    b = _tb(_batch(cfg))

    def count(remat):
        tc = steps.TrainStepConfig(remat=remat, compute_dtype="float32")
        CountMM.n = 0
        with CountMM():
            steps._value_and_grad(steps.make_loss_fn(tcfg, tc), tparams, b)
        return CountMM.n

    n = {"full": count("full"), "dots": count("dots")}
    real = lm._remat
    try:
        lm._remat = lambda fn, remat: fn
        n["none"] = count("full")
    finally:
        lm._remat = real
    assert n["dots"] == n["none"] < n["full"]


def test_unknown_remat_is_refused(qwen):
    cfg, tcfg, _, _, tparams = qwen
    with pytest.raises(ValueError, match="unknown remat"):
        lm.forward(tcfg, tparams, _tb(_batch(cfg)), remat="bogus")


# --------------------------------------------------------------- optimizer
def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "stack": (2, 3, 4)}
    mk = lambda s: {k: (rng.standard_normal(v) * s).astype(np.float32) for k, v in shapes.items()}
    params, grads = mk(0.5), mk(3.0)  # a global norm above clip_norm: clipping acts
    m, v = mk(0.1), {k: np.abs(a) for k, a in mk(0.1).items()}
    return params, grads, {"m": m, "v": v, "count": np.int32(7)}


def test_adamw_update_matches_reference():
    params, grads, opt = _opt_inputs()
    cfg = joptim.AdamWConfig(warmup_steps=10)
    jp, jopt, jmet = joptim.adamw_update(
        cfg, jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, opt),
        jax.tree.map(jnp.asarray, params))
    tparams, topt = train_state_from_jax(params, opt, CPU)
    tgrads = params_from_jax(grads, CPU)
    p, o, met = optim.adamw_update(optim.AdamWConfig(warmup_steps=10), tgrads, topt, tparams)
    tol = dict(rtol=1e-6, atol=1e-6)
    _close_trees(p, jp, **tol)
    _close_trees(o["m"], jopt["m"], **tol)
    _close_trees(o["v"], jopt["v"], **tol)
    assert o["count"].dtype == torch.int32 and int(o["count"]) == int(jopt["count"]) == 8
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-6)
    assert float(met["grad_norm"]) > 1.0


def test_adamw_grad_norm_sums_in_reference_order():
    """The global norm sums the leaves in ``jax.tree.leaves`` order (dict
    keys sorted), whatever order the dict lists them in: a tree restored
    from a checkpoint lists them sorted, one the model builds in insertion
    order.  f32 addition depends on the order: 2^24 then eight 1s stays
    2^24, eight 1s then 2^24 is 2^24 + 8."""
    grads = {"z": np.array([4096.0], np.float32)}  # its square is 2^24
    grads.update({k: np.ones(1, np.float32) for k in "abcdefgh"})
    params = {k: np.zeros(1, np.float32) for k in grads}
    opt = {"m": dict(params), "v": dict(params), "count": np.int32(0)}
    _, _, jmet = joptim.adamw_update(
        joptim.AdamWConfig(), jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, opt),
        jax.tree.map(jnp.asarray, params))
    assert float(jmet["grad_norm"]) == np.sqrt(np.float32(2**24 + 8), dtype=np.float32)
    tparams, topt = train_state_from_jax(params, opt, CPU)
    for tree in (grads, dict(sorted(grads.items()))):
        _, _, met = optim.adamw_update(optim.AdamWConfig(), params_from_jax(tree, CPU), topt,
                                       tparams)
        assert float(met["grad_norm"]) == float(jmet["grad_norm"])


def test_adamw_init_is_f32_zeros():
    params = {"a": torch.ones(3, 2, dtype=torch.bfloat16), "b": (torch.ones(4),)}
    opt = optim.adamw_init(params)
    assert opt["count"].dtype == torch.int32 and opt["count"].shape == ()
    for t in (opt["m"]["a"], opt["v"]["b"][0]):
        assert t.dtype == torch.float32 and not t.any()
    p, _, _ = optim.adamw_update(optim.AdamWConfig(), {"a": torch.ones(3, 2),
                                                       "b": (torch.ones(4),)}, opt, params)
    assert p["a"].dtype == torch.bfloat16  # cast back to the parameter's dtype


def test_compress_int8_matches_reference():
    rng = np.random.default_rng(1)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    err = (rng.standard_normal((64, 33)) * 1e-2).astype(np.float32)
    jq, js, je = joptim.compress_int8(jnp.asarray(g), jnp.asarray(err))
    q, s, e = optim.compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(optim.decompress_int8(q, s).numpy(),
                               np.asarray(joptim.decompress_int8(jq, js)), rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- train step
def test_three_train_steps_with_microbatches_match_reference(qwen):
    cfg, tcfg, jparams, np_params, _ = qwen
    tc = dict(remat="dots", compute_dtype="float32", num_microbatches=2)
    jstep = jax.jit(jsteps.make_train_step(cfg, jsteps.TrainStepConfig(**tc)))
    jp, jopt = jparams, joptim.adamw_init(jparams)
    tp, topt = train_state_from_jax(np_params, jax.tree.map(np.asarray, jopt), CPU)
    tstep = steps.make_train_step(tcfg, steps.TrainStepConfig(**tc))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    for step in range(3):
        b = data.batch_at(step)
        jp, jopt, jm = jstep(jp, jopt, _jb(b))
        tp, topt, tm = tstep(tp, topt, _tb(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _close_trees(tp, jp, rtol=2e-5, atol=2e-5)
    _close_trees(topt["m"], jopt["m"], rtol=1e-4, atol=1e-7)
    assert int(topt["count"]) == 3


def test_moe_train_step_with_microbatches_matches_reference(olmoe):
    """One step of reduced olmoe (remat "dots", 2 microbatches, f32): the
    loss, the reported aux (both packages report 0 over microbatches), the
    grad norm, which takes the aux term's gradient through the router, and
    the new params."""
    cfg, tcfg, jparams, np_params, _ = olmoe
    tc = dict(remat="dots", compute_dtype="float32", num_microbatches=2)
    jstep = jax.jit(jsteps.make_train_step(cfg, jsteps.TrainStepConfig(**tc)))
    jopt = joptim.adamw_init(jparams)
    tp, topt = train_state_from_jax(np_params, jax.tree.map(np.asarray, jopt), CPU)
    b = _batch(cfg)
    jp, _, jm = jstep(jparams, jopt, _jb(b))
    tp, _, m = steps.make_train_step(tcfg, steps.TrainStepConfig(**tc))(tp, topt, _tb(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(m["aux"]) == float(jm["aux"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _close_trees(tp, jp, rtol=2e-5, atol=2e-5)


def test_microbatches_average_the_gradients(qwen):
    """Two microbatches give the mean of their gradients: the same update
    as one pass over the whole batch (to f32 rounding)."""
    cfg, tcfg, _, _, tparams = qwen
    b = _tb(_batch(cfg))
    out = {}
    for n in (1, 2):
        tc = steps.TrainStepConfig(remat="full", compute_dtype="float32", num_microbatches=n)
        p, o, m = steps.make_train_step(tcfg, tc)(tparams, optim.adamw_init(tparams), b)
        out[n] = (o["m"], m)
    np.testing.assert_allclose(float(out[2][1]["grad_norm"]), float(out[1][1]["grad_norm"]),
                               rtol=1e-5)
    two, one = _named(out[2][0]), _named(out[1][0])
    for name in one:
        np.testing.assert_allclose(two[name], one[name], rtol=1e-4, atol=1e-9, err_msg=name)


def test_default_microbatches_match_reference():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name in ARCHS:
        for gb, shards, seq in [(8, 1, 64), (256, 16, 4096), (1024, 32, 8192), (16, 64, 2048)]:
            assert steps.default_microbatches(ARCHS[name], gb, shards, seq) == \
                jsteps.default_microbatches(J_ARCHS[name], gb, shards, seq), name


def test_init_train_state_is_seeded(qwen):
    _, tcfg, _, _, _ = qwen
    p1, o1 = steps.init_train_state(tcfg, 4, device=CPU)
    p2, _ = steps.init_train_state(tcfg, 4, device=CPU)
    assert _named(p1).keys() == _named(o1["m"]).keys()
    for (n, a), (_, b) in zip(flatten_state(p1)[0], flatten_state(p2)[0]):
        assert torch.equal(a, b), n
    assert int(o1["count"]) == 0


# ------------------------------------------------------- prefill / decode
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-780m", "olmoe-1b-7b"])
def test_prefill_and_decode_step_match_reference(arch, by_arch):
    cfg, tcfg, jparams, _, tparams = by_arch[arch]
    toks = _batch(cfg, seq=8, batch=2)["tokens"]
    f32 = dict(compute_dtype=jnp.float32)
    want, jc, _ = jlm.prefill(cfg, jparams, {"tokens": jnp.asarray(toks)}, **f32)
    got, tc, _ = lm.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _close_trees(tc, jc, **LOGITS_TOL)
    tok = np.argmax(np.asarray(want)[:, -1], axis=-1).astype(np.int32)[:, None]
    for pos in (8, 9):
        want, jc, _ = jlm.decode_step(cfg, jparams, {"tokens": jnp.asarray(tok)}, jc,
                                      jnp.int32(pos), **f32)
        got, tc, _ = lm.decode_step(tcfg, tparams, {"tokens": torch.from_numpy(tok)}, tc, pos,
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
        _close_trees(tc, jc, **LOGITS_TOL)
        tok = np.argmax(np.asarray(want)[:, -1], axis=-1).astype(np.int32)[:, None]


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_step_on_gpu_matches_cpu(cuda):
    """One reduced train step (f32, two microbatches) on the card against
    the CPU path from the same seed: loss, grad norm and the new params."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    tc = steps.TrainStepConfig(remat="dots", compute_dtype="float32", num_microbatches=2)
    b = _batch(cfg, seq=32, batch=4)
    out = {}
    for dev in ("cpu", cuda):
        p, o = steps.init_train_state(cfg, 0, device=dev)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        p, o, m = steps.make_train_step(cfg, tc)(p, o, batch)
        out[str(dev)[:4]] = (p, m)
    (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mg["grad_norm"]), float(mc["grad_norm"]), rtol=1e-4)
    for (n, a), (_, c) in zip(flatten_state(pg)[0], flatten_state(pc)[0]):
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
