"""The port's sharding rules, ``build_cell``, serve steps and elastic mesh
plans (``repro_torch.{sharding,launch.specs,launch.mesh,serve.steps,
ft.elastic}``) against the JAX package's, on the CPU.

Specs need no ranks: both packages bind logical axes against abstract
meshes of the production shapes (16 x 16 and 2 x 16 x 16;
``jax.sharding.AbstractMesh`` and the port's ``AbstractMesh``).  The serve
steps run at f32 on the same weights (the JAX initializer's, through
``interop.params_from_jax``): tokens equal; f32 caches rtol/atol 2e-5, bf16
caches 2e-2, int8 caches dequantized within 2e-4 (``tests/test_kernels.py``'s
int8 decode tolerance).  The multi-rank paths are in
``tests/test_torch_distributed.py``.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.ft import elastic as jelastic
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.serve import steps as jsteps
from repro.sharding import partition as jpart
from repro.train.steps import TrainStepConfig as JTrainStepConfig
from repro.train.steps import default_microbatches as j_default_microbatches
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.ft import elastic
from repro_torch.interop import dtype_name, params_from_jax, tree_leaves, tree_map
from torch_twins import to_numpy
from repro_torch.launch import hw, mesh as tmesh, specs
from repro_torch.models import lm
from repro_torch.serve import steps
from repro_torch.sharding import partition as part
from repro_torch.train import optim
from repro_torch.train.steps import TrainStepConfig, default_microbatches, make_train_step

MESHES = {"16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}
MODES = {"train": "train_4k", "serve": "decode_32k"}


def _meshes(name):
    sizes, axes, multi_pod = MESHES[name]
    return JAbstractMesh(sizes, axes), part.AbstractMesh(sizes, axes), multi_pod


def _spec_leaves(tree, is_spec):
    """[(path, spec)] of a specs tree, in key order (both packages nest the
    same dicts and tuples)."""
    out = []

    def walk(t, path):
        if is_spec(t):
            out.append((path, t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))

    walk(tree, ())
    return out


def _dt(d):
    return None if d is None else dtype_name(d) if isinstance(d, torch.dtype) else str(jnp.dtype(d))


def test_arch_lists_agree():
    assert sorted(ARCHS) == sorted(J_ARCHS)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_specs_match_reference(arch, mesh_name, mode):
    """Every parameter's (and in serve mode every cache leaf's) shape,
    dtype, logical axes and bound spec equal the reference's, and so do the
    cell's meta and its placements, at the production meshes."""
    jmesh, tmesh_, multi_pod = _meshes(mesh_name)
    shape_name = MODES[mode]
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jrules = jspecs.make_rules(jcfg, J_SHAPES[shape_name], multi_pod)
    trules = specs.make_rules(tcfg, SHAPES[shape_name], multi_pod)
    assert trules == jrules

    want = _spec_leaves(jlm.param_specs(jcfg), lambda s: isinstance(s, jpart.ParamSpec))
    got = _spec_leaves(lm.param_specs(tcfg), lambda s: isinstance(s, part.ParamSpec))
    pol = jspecs.kv_policy(jcfg, J_SHAPES[shape_name], 16)
    if mode == "serve":
        kv = jnp.dtype(pol["kv_dtype"])
        want += _spec_leaves(jlm.cache_specs(jcfg, 128, 4096, kv, jnp.bfloat16, pol["kv_repeat"]),
                             lambda s: isinstance(s, jpart.ParamSpec))
        got += _spec_leaves(lm.cache_specs(tcfg, 128, 4096, getattr(torch, pol["kv_dtype"]),
                                           torch.bfloat16, pol["kv_repeat"]),
                            lambda s: isinstance(s, part.ParamSpec))
    assert [p for p, _ in got] == [p for p, _ in want]
    with jpart.axis_rules(jmesh, jrules), part.axis_rules(tmesh_, trules):
        for (path, j), (_, t) in zip(want, got):
            assert (t.shape, t.logical, _dt(t.dtype)) == (tuple(j.shape), tuple(j.logical),
                                                           _dt(j.dtype)), path
            assert part.logical_to_spec(t.logical, t.shape) == tuple(
                jpart.logical_to_spec(j.logical, j.shape)), path
        jplan = jspecs.build_cell(arch, shape_name, jmesh, multi_pod)
        tplan = specs.build_cell(arch, shape_name, tmesh_, multi_pod)
    assert tplan.meta == jplan.meta
    jsh = _spec_leaves(jplan.in_shardings, lambda s: hasattr(s, "spec"))
    tsh = _spec_leaves(tplan.in_shardings, lambda s: isinstance(s, tuple) and len(s) > 0
                       and all(hasattr(p, "is_shard") for p in s))
    assert [p for p, _ in tsh] == [p for p, _ in jsh]
    for (path, j), (_, t) in zip(jsh, tsh):
        assert t == part.to_placements(tuple(j.spec), tmesh_), path


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_policies_and_memory_model_match_reference(arch):
    """kv_policy, default_microbatches, the modeled memory's byte terms and
    cell_skip_reason equal the reference's at every shape and both meshes
    (``fits_hbm`` is judged against another card's HBM)."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for mesh_name in MESHES:
        jmesh, tmesh_, multi_pod = _meshes(mesh_name)
        for shape_name, shape in SHAPES.items():
            jshape = J_SHAPES[shape_name]
            for m in (1, 4, 16):
                assert specs.kv_policy(tcfg, shape, m) == jspecs.kv_policy(jcfg, jshape, m)
            assert (specs.cell_skip_reason(arch, shape_name) is None) == (
                jspecs.cell_skip_reason(arch, shape_name) is None)
            for mb_args in ((shape.global_batch, 16, shape.seq_len, 16), (8, 1, 512, 1)):
                assert default_microbatches(tcfg, *mb_args) == j_default_microbatches(
                    jcfg, *mb_args)
            pol = jspecs.kv_policy(jcfg, jshape, 16)
            meta = {"kv_repeat": pol["kv_repeat"], "kv_dtype": pol["kv_dtype"],
                    "num_microbatches": 2, "q_chunk": 1024}
            want = jspecs.modeled_memory(jcfg, jshape, jmesh, meta)
            got = specs.modeled_memory(tcfg, shape, tmesh_, meta)
            for key in ("param_bytes", "opt_bytes", "cache_bytes", "activation_bytes",
                        "total_bytes"):
                assert got[key] == pytest.approx(want[key], rel=1e-12), (mesh_name, shape_name,
                                                                        key)
            assert got["fits_hbm"] == (got["total_bytes"] < 0.92 * hw.HBM_BYTES)


def test_plan_mesh_matches_reference():
    for n in (1, 2, 3, 6, 8, 12, 16, 24, 48, 256, 512):
        for mp in (1, 4, 16):
            for pods in (1, 2):
                t, j = elastic.plan_mesh(n, mp, pods), jelastic.plan_mesh(n, mp, pods)
                assert (t.shape, t.axes) == (tuple(j.shape), tuple(j.axes)), (n, mp, pods)
    assert elastic.plan_mesh(8, model_parallel=4).shape == (2, 4)
    # 6 live ranks keep TP 2, not 4: a (3, 2) mesh (on 8 ranks, 2 stay idle)
    assert elastic.plan_mesh(6, model_parallel=4).shape == (3, 2)
    assert elastic.plan_mesh(1, model_parallel=16).shape == (1, 1)


@pytest.mark.parametrize("arch,shape_name", [("qwen1.5-0.5b", "train_4k"),
                                             ("qwen2-vl-7b", "prefill_32k"),
                                             ("musicgen-large", "train_4k"),
                                             ("jamba-v0.1-52b", "decode_32k"),
                                             ("qwen2-vl-7b", "decode_32k")])
def test_input_specs_match_reference(arch, shape_name):
    """Meta tensors of the reference's ShapeDtypeStruct shapes and dtypes,
    holding no storage."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    pol = jspecs.kv_policy(jcfg, J_SHAPES[shape_name])
    want = jspecs.input_specs(jcfg, J_SHAPES[shape_name], jnp.bfloat16,
                              jnp.dtype(pol["kv_dtype"]), pol["kv_repeat"])
    got = specs.input_specs(tcfg, SHAPES[shape_name], torch.bfloat16,
                            getattr(torch, pol["kv_dtype"]), pol["kv_repeat"])
    jl = _spec_leaves(want, lambda s: isinstance(s, jax.ShapeDtypeStruct))
    tl = _spec_leaves(got, lambda s: isinstance(s, torch.Tensor))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, j), (_, t) in zip(jl, tl):
        assert t.device.type == "meta", path
        assert (tuple(t.shape), dtype_name(t.dtype)) == (tuple(j.shape), str(j.dtype)), path


def test_rules_bind_divisibility_and_placements():
    """Prefix fallback, replication of an indivisible dim, one use of each
    mesh axis; placements name the tensor dim each mesh axis shards."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = part.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    rules = {"batch": ("pod", "data"), "vocab": ("model",), "fsdp": ("data",)}
    with part.axis_rules(mesh, rules):
        assert part.logical_to_spec(("batch", "vocab"), (64, 50280)) == (("pod", "data"), None)
        assert part.logical_to_spec(("batch", None), (2, 7)) == ("pod", None)
        assert part.logical_to_spec(("batch", "fsdp"), (64, 64)) == (("pod", "data"), None)
        assert part.named_sharding(("vocab", "fsdp"), (256, 32)) == (
            Replicate(), Shard(1), Shard(0))
    assert part.logical_to_spec(("batch", "vocab")) == (None, None)
    assert part.named_sharding(("vocab",)) is None
    x = torch.ones(4, 4)
    assert part.constrain(x, "batch", None) is x
    with part.axis_rules(mesh, rules):
        assert part.constrain(x, "batch", None) is x  # a plain tensor is a global view


# ------------------------------------------------ the steps against the reference
CPU = "cpu"


def _model(arch, seed=5):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_jax(np_params, CPU)


@pytest.fixture(scope="module")
def models():
    return {a: _model(a) for a in ("qwen1.5-0.5b", "gemma3-27b", "olmoe-1b-7b",
                                   "jamba-v0.1-52b")}


def _caches_close(got, want, kv):
    jl = _spec_leaves(want, lambda a: hasattr(a, "shape") and not isinstance(a, dict))
    tl = _spec_leaves(got, lambda a: isinstance(a, torch.Tensor))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    named = {p: (t, np.asarray(j)) for (p, j), (_, t) in zip(jl, tl)}
    for path, (t, j) in named.items():
        t = to_numpy(t)
        assert t.shape == j.shape and str(t.dtype) == str(j.dtype), path
        if path[-1] in ("k", "v") and kv == "int8":
            scale = path[:-1] + (path[-1] + "_scale",)
            tq = t.astype(np.float32) * to_numpy(named[scale][0])[..., None]
            jq = j.astype(np.float32) * np.asarray(named[scale][1])[..., None]
            np.testing.assert_allclose(tq, jq, rtol=2e-4, atol=2e-4, err_msg=str(path))
        else:
            tol = 2e-2 if kv == "bfloat16" and path[-1] in ("k", "v") else 2e-5
            np.testing.assert_allclose(t.astype(np.float32), j.astype(np.float32),
                                       rtol=tol, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("arch,kv", [("qwen1.5-0.5b", "float32"), ("qwen1.5-0.5b", "bfloat16"),
                                     ("qwen1.5-0.5b", "int8"), ("gemma3-27b", "int8"),
                                     ("olmoe-1b-7b", "bfloat16"), ("jamba-v0.1-52b", "int8")])
def test_serve_steps_match_reference(models, arch, kv):
    """A prefill step and three decode steps: tokens equal, caches within
    their dtype's tolerance after each."""
    jcfg, tcfg, jparams, tparams = models[arch]
    kv_repeat = 2 if arch == "qwen1.5-0.5b" and kv == "int8" else 1
    jscfg = jsteps.ServeStepConfig(compute_dtype="float32", kv_dtype=kv, kv_repeat=kv_repeat)
    tscfg = steps.ServeStepConfig(compute_dtype="float32", kv_dtype=kv, kv_repeat=kv_repeat)
    assert dataclasses.asdict(tscfg) == dataclasses.asdict(jscfg)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jtok, jc = jax.jit(jsteps.make_prefill_step(jcfg, jscfg))(jparams, {"tokens": jnp.asarray(tokens)})
    ttok, tc = steps.make_prefill_step(tcfg, tscfg)(tparams, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _caches_close(tc, jc, kv)
    jdec = jax.jit(jsteps.make_decode_step(jcfg, jscfg))
    tdec = steps.make_decode_step(tcfg, tscfg)
    for pos in (16, 17, 18):
        jtok, jc = jdec(jparams, jc, {"tokens": jtok[:, None]}, jnp.int32(pos))
        ttok, tc = tdec(tparams, tc, {"tokens": ttok[:, None]}, pos)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        _caches_close(tc, jc, kv)


def test_kv_repeat_and_unroll_change_nothing(models):
    """``kv_repeat`` 2 replicates the reduced qwen's 2 KV heads to 4 in
    prefill, decode and the train forward, and ``unroll`` only steers the
    reference's scans: the port's outputs are equal both ways, and equal to
    the reference's at kv_repeat 2."""
    jcfg, tcfg, jparams, tparams = models["qwen1.5-0.5b"]
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    b = {"tokens": torch.as_tensor(tokens)}
    f32 = torch.float32
    l1, c1, _ = lm.prefill(tcfg, tparams, b, compute_dtype=f32)
    l2, c2, _ = lm.prefill(tcfg, tparams, b, compute_dtype=f32, kv_repeat=2, unroll=True)
    torch.testing.assert_close(l2, l1, rtol=2e-5, atol=2e-5)
    assert c2["pattern"][0]["k"].shape[2] == 2 * c1["pattern"][0]["k"].shape[2]  # (reps, B, kvH, ..)
    jl, _, _ = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                           compute_dtype=jnp.float32, kv_repeat=2, unroll=True)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), rtol=2e-5, atol=2e-5)
    nxt = {"tokens": torch.argmax(l1[:, -1], -1)[:, None]}
    d1, _, _ = lm.decode_step(tcfg, tparams, nxt, c1, 8, compute_dtype=f32)
    d2, _, _ = lm.decode_step(tcfg, tparams, nxt, c2, 8, compute_dtype=f32, kv_repeat=2,
                              unroll=True, unroll_inner=True)
    torch.testing.assert_close(d2, d1, rtol=2e-5, atol=2e-5)
    f1, _ = lm.forward(tcfg, tparams, b, compute_dtype=f32)
    f2, _ = lm.forward(tcfg, tparams, b, compute_dtype=f32, kv_repeat=2, unroll=True)
    torch.testing.assert_close(f2, f1, rtol=2e-5, atol=2e-5)


def test_train_step_kv_repeat_matches_reference(models):
    """``TrainStepConfig.kv_repeat`` / ``unroll_scans`` as the reference's:
    one f32 step with kv_repeat 2, two microbatches, loss rtol 1e-4 and
    params 3e-4 (``tests/distributed_check.py``'s tolerances)."""
    jcfg, tcfg, jparams, tparams = models["qwen1.5-0.5b"]
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    kw = dict(remat="dots", compute_dtype="float32", num_microbatches=2, kv_repeat=2,
              unroll_scans=True)
    from repro.train.optim import adamw_init as j_adamw_init

    jp, _, jm = jax.jit(j_make_train_step(jcfg, JTrainStepConfig(**kw)))(
        jparams, j_adamw_init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    tp, _, tm = make_train_step(tcfg, TrainStepConfig(**kw))(
        tparams, optim.adamw_init(tparams), {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    tree_map(lambda t, j: np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=3e-4,
                                                     atol=3e-4), tp, jax.tree.map(np.asarray, jp))


def test_meshes_need_a_process_group():
    """Mesh constructors are functions: importing them touches no process group,
    and calling one without a group raises rather than starting one."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_host_mesh("cpu")
    assert tmesh.data_shards(part.AbstractMesh((2, 16, 16), ("pod", "data", "model"))) == 32
    assert tree_leaves(lm.abstract_params(get_config("qwen1.5-0.5b").reduced()))[0].is_meta


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NCCL group and the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_nccl_one_rank_steps_on_gpu(cuda, kv):
    """One NCCL rank (an in-memory store), the 1 x 1 host mesh and the serve
    rules: ``build_cell``'s prefill step and two decode steps of the reduced
    qwen at f32 give the CPU path's tokens, through K2 and K3 (its int8
    instance for the int8 cache) and the vocab-parallel embedding's NCCL
    all-reduce."""
    import torch.distributed as dist

    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import launch_counters

    cfg = get_config("qwen1.5-0.5b").reduced()
    params = lm.init_params(cfg, seed=3, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tmesh.init_single_process(cuda)
    try:
        mesh = tmesh.make_host_mesh(cuda)
        cells = []
        for name, kind in (("prefill_32k", "prefill"), ("decode_32k", "decode")):
            shape = InputShape(name, kind, 16, 2)
            rules = specs.make_rules(cfg, shape, False)
            with part.axis_rules(mesh, rules):
                plan = specs.build_cell("qwen1.5-0.5b", name, mesh, False,
                                        {"compute_dtype": "float32", "kv_dtype": kv},
                                        cfg=cfg, shape=shape)
            cells.append((plan, rules))
        counters = launch_counters()
        for c in counters.values():
            c.reset()
        got, want = [], []
        for out, p, m, where in ((got, on_card, mesh, cuda), (want, params, None, "cpu")):
            tok, caches = None, None
            for pos, (plan, rules) in zip((None, 16, 17), (cells[0], cells[1], cells[1])):
                with part.axis_rules(m, rules) if m is not None else contextlib.nullcontext():
                    if pos is None:
                        tok, caches = plan.fn(p, {"tokens": torch.as_tensor(prompt, device=where)})
                    else:
                        tok, caches = plan.fn(p, caches, {"tokens": tok[:, None]}, pos)
                out.append(tok.cpu())
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert counters["flash_attention"].count == cfg.n_layers
        assert counters["decode_attention"].count == 2 * cfg.n_layers
    finally:
        dist.destroy_process_group()

