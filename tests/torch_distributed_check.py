"""Subprocess worker: the port's sharded paths on 8 ``gloo`` ranks (a 2 x 4
``data`` x ``model`` mesh), against the port's single-device path and the
JAX package's single-device results.  Invoked by
``test_torch_distributed.py``, which computes the JAX results and writes
them with the inputs to a pickle:

    python tests/torch_distributed_check.py INPUTS.pkl RESULTS.json

Every rank runs every check (the tensors are global views on each rank);
rank 0 compares and writes one entry per check: ``{"ok", "error", ...}``.
The checks and tolerances are ``tests/distributed_check.py``'s:
``moe`` (olmoe reduced, capacity factor 8, train forward: logits 2e-4, aux
rtol 25%; here also the parameter gradients of the sharded forward against
the local one, 3e-4), ``moe_decode`` (phi3.5-moe reduced, replicated EP
decode: 2e-4), ``train`` (qwen1.5 reduced, kv_repeat 2, 2 microbatches:
loss rtol 1e-4, params 3e-4; here also the loss's gradients, 3e-4), ``elastic`` (plan_mesh, placed state equal
on a (2, 4) mesh and on the (3, 2) mesh of 6 live ranks, 2 idle).
"""
import dataclasses
import datetime
import json
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8


def _tree(np_tree):
    from repro_torch.interop import params_from_jax

    return params_from_jax(np_tree, "cpu")


def _close(name, got, want, rtol, atol, errors):
    try:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)
    except AssertionError as e:
        errors.append(f"{name}: {e}")


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def mesh_2d():
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((2, 4), ("data", "model"), "cpu")


def check_moe(inp, out):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.specs import make_rules
    from repro_torch.models import lm
    from repro_torch.sharding.partition import axis_rules

    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), capacity_factor=8.0)
    toks = torch.as_tensor(inp["tokens"])

    def run():
        params = _tree(inp["params"])
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_()
        logits, aux = lm.forward(cfg, params, {"tokens": toks}, compute_dtype=torch.float32)
        # the aux loss is left out: its sharded form is another function
        grads = torch.autograd.grad((logits * logits).sum(), leaves)
        return logits.detach().numpy(), float(aux), [g.numpy() for g in grads]

    ref_logits, ref_aux, ref_grads = run()
    mesh = mesh_2d()
    with axis_rules(mesh, make_rules(cfg, InputShape("t", "train", 16, 4), False)):
        sh_logits, sh_aux, sh_grads = run()
    errors = []
    _close("sharded logits vs local", sh_logits, ref_logits, 2e-4, 2e-4, errors)
    _close("sharded logits vs JAX local", sh_logits, inp["jax_logits"], 2e-4, 2e-4, errors)
    # the sharded aux is the per-device load-balance loss (a mean of
    # per-shard products): approximate agreement only, as in the reference
    _close("sharded aux vs local", sh_aux, ref_aux, 0.25, 0, errors)
    _close("sharded aux vs JAX local", sh_aux, inp["jax_aux"], 0.25, 0, errors)
    for i, (g, r) in enumerate(zip(sh_grads, ref_grads)):
        _close(f"sharded grad leaf {i} vs local", g, r, 3e-4, 3e-4, errors)
    out.update(errors=errors, logits_err=_max_err(sh_logits, inp["jax_logits"]),
               aux=[sh_aux, ref_aux, float(inp["jax_aux"])],
               grad_err=max(_max_err(g, r) for g, r in zip(sh_grads, ref_grads)))


def check_moe_decode(inp, out):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.specs import make_rules
    from repro_torch.models import lm
    from repro_torch.sharding.partition import axis_rules

    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                              capacity_factor=8.0)
    toks = torch.as_tensor(inp["tokens"])

    def run():
        params = _tree(inp["params"])
        caches = lm.init_cache(cfg, 4, 32, torch.float32, torch.float32, device="cpu")
        logits, _, _ = lm.decode_step(cfg, params, {"tokens": toks}, caches, 3,
                                      compute_dtype=torch.float32)
        return logits.numpy()

    ref = run()
    mesh = mesh_2d()
    with axis_rules(mesh, make_rules(cfg, InputShape("d", "decode", 32, 4), False)):
        got = run()
    errors = []
    _close("sharded vs local", got, ref, 2e-4, 2e-4, errors)
    _close("sharded vs JAX local", got, inp["jax_logits"], 2e-4, 2e-4, errors)
    out.update(errors=errors, logits_err=_max_err(got, inp["jax_logits"]))


def check_train(inp, out):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.treeutil import flatten_state
    from repro_torch.launch.specs import make_rules
    from repro_torch.sharding.partition import axis_rules
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.steps import (
        TrainStepConfig,
        _value_and_grad,
        make_loss_fn,
        make_train_step,
    )

    cfg = get_config("qwen1.5-0.5b").reduced()
    tcfg = TrainStepConfig(remat="dots", compute_dtype="float32", num_microbatches=2,
                           kv_repeat=2)
    batch = {k: torch.as_tensor(inp[k]) for k in ("tokens", "targets")}
    step = make_train_step(cfg, tcfg)
    loss_fn = make_loss_fn(cfg, tcfg)

    def run():
        params = _tree(inp["params"])
        # the gradients themselves: one AdamW step sees little more than their signs
        _, g = _value_and_grad(loss_fn, params, batch)
        p, _, m = step(params, adamw_init(params), batch)
        return dict(flatten_state(p)[0]), float(m["loss"]), dict(flatten_state(g)[0])

    p_ref, l_ref, g_ref = run()
    mesh = mesh_2d()
    with axis_rules(mesh, make_rules(cfg, InputShape("t", "train", 32, 4), False)):
        p_sh, l_sh, g_sh = run()
    errors = []
    for name in sorted(g_ref):
        _close(f"sharded grad {name} vs local", g_sh[name].numpy(), g_ref[name].numpy(),
               3e-4, 3e-4, errors)
    _close("sharded loss vs local", l_sh, l_ref, 1e-4, 0, errors)
    _close("sharded loss vs JAX local", l_sh, inp["jax_loss"], 1e-4, 0, errors)
    want = inp["jax_params"]
    for name in sorted(p_ref):
        _close(f"sharded {name} vs local", p_sh[name].numpy(), p_ref[name].numpy(),
               3e-4, 3e-4, errors)
        _close(f"sharded {name} vs JAX local", p_sh[name].numpy(), want[name], 3e-4, 3e-4, errors)
    out.update(errors=errors, loss=[l_sh, l_ref, float(inp["jax_loss"])],
               params_err=max(_max_err(p_sh[n].numpy(), want[n]) for n in want))


def check_elastic(inp, out):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.treeutil import flatten_state
    from repro_torch.ft.elastic import make_mesh_from_plan, plan_mesh, reshard_state
    from repro_torch.launch.specs import make_rules
    from repro_torch.models.lm import param_specs
    from repro_torch.sharding.partition import axis_rules, constrain

    cfg = get_config("qwen1.5-0.5b").reduced()
    state_np = inp["params"]  # the JAX package's initializer's, as numpy
    want = dict(flatten_state(_tree(state_np))[0])
    errors = []
    plan = plan_mesh(8, model_parallel=4)
    if plan.shape != (2, 4):
        errors.append(f"plan_mesh(8, 4) = {plan.shape}")
    mesh = make_mesh_from_plan(plan, world=WORLD, device="cpu")
    rules = make_rules(cfg, InputShape("t", "train", 32, 4), False)
    placed = reshard_state(state_np, param_specs(cfg), mesh, rules)
    tok = placed["embed"]["tok"]  # (vocab, fsdp) -> (model, data)
    if not isinstance(tok, DTensor) or tuple(tok.placements) != (Shard(1), Shard(0)):
        errors.append(f"embed/tok placed as {getattr(tok, 'placements', type(tok))}")
    for name, t in flatten_state(placed)[0]:
        if not torch.equal(t.full_tensor(), want[name]):
            errors.append(f"(2, 4) mesh: {name} differs")
    with axis_rules(mesh, make_rules(cfg, InputShape("d", "decode", 32, 4), False)):
        moved = constrain(tok, "vocab", None)  # serve rules: no fsdp
    if tuple(moved.placements) != (Replicate(), Shard(0)) or not torch.equal(
            moved.full_tensor(), want["embed/tok"]):
        errors.append(f"constrain redistributed to {moved.placements}")
    # scale-down: 6 live ranks -> (3, 2), ranks 6 and 7 idle
    plan2 = plan_mesh(6, model_parallel=4)
    mesh2 = make_mesh_from_plan(plan2, device="cpu")
    placed2 = reshard_state(state_np, param_specs(cfg), mesh2, rules)
    if mesh2.get_coordinate() is not None:
        for name, t in flatten_state(placed2)[0]:
            if not torch.equal(t.full_tensor(), want[name]):
                errors.append(f"{plan2.shape} mesh: {name} differs")
    out.update(errors=errors, plans=[list(plan.shape), list(plan2.shape)])


CHECKS = {"moe": check_moe, "moe_decode": check_moe_decode, "train": check_train,
          "elastic": check_elastic}


def worker(rank, inputs_path, results_path, store_path):
    dist.init_process_group("gloo", init_method=f"file://{store_path}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    results = {}
    for name, fn in CHECKS.items():
        out = {}
        try:
            fn(inputs[name], out)
            out["ok"] = not out["errors"]
        except Exception:  # noqa: BLE001 - reported to the test, which fails
            out.update(ok=False, errors=[traceback.format_exc()])
        results[name] = out
        dist.barrier()
    if rank == 0:
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1)
    dist.destroy_process_group()


if __name__ == "__main__":
    import tempfile

    import torch.multiprocessing as mp

    torch.set_num_threads(1)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(worker, args=(sys.argv[1], sys.argv[2], os.path.join(tmp, "store")),
                 nprocs=WORLD)
