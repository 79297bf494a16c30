"""Shared by the port's twins of the JAX package's data-plane tests
(``tests/test_torch_{upload,node,invocation,cluster,engine}.py``): the JAX
initializer's weights carried into the port, the JAX package's tokens on
them, and the device a ``gpu``-marked case asks for."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.serve.instance import generate as jgenerate
from repro.serve.instance import layerwise_state as jlayerwise
from repro_torch.interop import params_from_jax

CPU = "cpu"
# a case per device: the CPU always, the card where there is one
DEVICES = [CPU, pytest.param("cuda", marks=pytest.mark.gpu)]


def need_device(device: str) -> str:
    """``device``, or a skip when it is the card and there is none."""
    if device != CPU and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return device


def jax_params(cfg, key: int):
    """The JAX package's ``lm.init_params`` at ``PRNGKey(key)`` in f32, as
    numpy arrays."""
    return jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(key), jnp.float32))


def port_params(np_params, device=CPU):
    """The same weights as the port's params (torch tensors on ``device``)."""
    return params_from_jax(np_params, device)


def jax_tokens(cfg, np_params, prompt, max_new: int) -> np.ndarray:
    """The JAX package's greedy tokens over ``np_params``: its own
    layer-gated ``generate``, as its node serves them."""
    return jgenerate(cfg, None, jlayerwise(cfg, np_params), prompt, max_new)[0]
