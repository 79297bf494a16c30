"""Architecture registry: ``--arch <id>`` resolves through ``get_config``."""
from repro_torch.configs.base import SHAPES, InputShape, LayerSpec, ModelConfig

from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.phi35_moe_42b import CONFIG as _phi35
from repro_torch.configs.jamba_v01_52b import CONFIG as _jamba
from repro_torch.configs.qwen2_vl_7b import CONFIG as _qwen2vl
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.qwen15_05b import CONFIG as _qwen15
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2

ARCHS = {
    c.name: c
    for c in [
        _olmoe,
        _phi35,
        _jamba,
        _qwen2vl,
        _gemma3,
        _qwen3,
        _starcoder2,
        _qwen15,
        _musicgen,
        _mamba2,
    ]
}

# Convenience aliases (ids as listed in the assignment).
ALIASES = {
    "olmoe-1b-7b": "olmoe-1b-7b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "jamba-v0.1-52b": "jamba-v0.1-52b",
    "jamba": "jamba-v0.1-52b",
    "qwen2-vl-7b": "qwen2-vl-7b",
    "gemma3-27b": "gemma3-27b",
    "qwen3-32b": "qwen3-32b",
    "starcoder2-7b": "starcoder2-7b",
    "qwen1.5-0.5b": "qwen1.5-0.5b",
    "musicgen-large": "musicgen-large",
    "mamba2-780m": "mamba2-780m",
}


def get_config(arch: str) -> ModelConfig:
    key = ALIASES.get(arch, arch)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "InputShape",
    "LayerSpec",
    "get_config",
    "get_shape",
]
