"""The port stands alone: importing every module of ``repro_torch`` loads
neither jax nor the JAX package, and entry points refuse to fall back to
the host when no GPU is present."""
import subprocess
import sys

import pytest
import torch

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), " ".join(bad))
"""


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split()
    n_modules, leaked = int(out[0]), out[1:]
    assert n_modules >= 40  # every subpackage was walked
    assert leaked == []


def test_entry_points_default_to_cuda():
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import ServerlessNode

    if torch.cuda.is_available():
        node = ServerlessNode()
        try:
            assert node.device.type == "cuda"
        finally:
            node.close()
        return
    with pytest.raises(RuntimeError, match="'cuda'"):
        ServerlessNode()
    with pytest.raises(RuntimeError, match="'cuda'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
