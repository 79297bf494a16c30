"""The port stands alone: importing every module of ``repro_torch`` loads
neither jax, nor the JAX package, nor ``ml_dtypes`` (which ships with JAX),
no module names any of them in an import, and entry points refuse to fall
back to the host when no GPU is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
print(len(names), " ".join(bad))
print(" ".join(names))
"""


def test_port_imports_neither_jax_nor_repro():
    first, walked = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.splitlines()
    n_modules, leaked = int(first.split()[0]), first.split()[1:]
    assert n_modules >= 70  # every subpackage was walked
    for name in ("data.synthetic", "ft.manager", "ft.publish", "ft.health", "train.loop",
                 "train.steps", "train.optim", "launch.train", "sharding", "sharding.partition",
                 "sharding.collectives", "launch.mesh", "launch.hw", "launch.specs",
                 "serve.steps", "ft.elastic", "launch.dryrun", "launch.hlo_analysis"):
        assert f"repro_torch.{name}" in walked.split()
    assert leaked == []


def test_no_port_module_names_jax_repro_or_ml_dtypes_in_an_import():
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    files = sorted(src.rglob("*.py"))
    assert len(files) >= 70
    named = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            named += [f"{path.relative_to(src)}:{node.lineno} {m}" for m in mods
                      if m.split(".")[0] in ("jax", "repro", "ml_dtypes")]
    assert named == []


_TWIN_PROBE = r"""
import importlib.util, sys
sys.modules["jax"] = None  # an import of either package now fails
sys.modules["repro"] = None
spec = importlib.util.spec_from_file_location("twin", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(callable(mod.main))
"""


@pytest.mark.parametrize("name", ["quickstart", "overlay_finetunes", "serve_coldstart",
                                  "train_ft"])
def test_example_twins_import_neither_jax_nor_repro(name):
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _TWIN_PROBE, str(root / "examples" / f"torch_{name}.py")],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "True"


def test_entry_points_default_to_cuda():
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import ServerlessNode
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.steps import TrainStepConfig

    cfg = get_config("qwen1.5-0.5b").reduced()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2))
    train = (cfg, TrainStepConfig(), LoopConfig(steps=1), data)
    if torch.cuda.is_available():
        node = ServerlessNode()
        try:
            assert node.device.type == "cuda"
        finally:
            node.close()
        assert train_loop(*train)["params"]["final_norm"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="'cuda'"):
        ServerlessNode()
    with pytest.raises(RuntimeError, match="'cuda'"):
        train_loop(*train)
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "1"],
        capture_output=True, text=True, timeout=120,
    )
    assert cli.returncode != 0 and "'cuda' requested" in cli.stderr
    with pytest.raises(RuntimeError, match="'cuda'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
