"""Architecture registry for the port: the three dense archs of the APC
deployment, the ssm arch (rwkv6-3b) and the hybrid arch (zamba2-2.7b).
``get(name)`` returns the full-size config, ``get_smoke(name)`` the reduced
CPU-smoke variant."""

from __future__ import annotations

from typing import List

from repro_torch.configs import nemotron_4_15b, olmo_1b, qwen2_5_3b, rwkv6_3b, zamba2_2_7b
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

_MODULES = {
    "olmo-1b": olmo_1b,
    "nemotron-4-15b": nemotron_4_15b,
    "qwen2.5-3b": qwen2_5_3b,
    "rwkv6-3b": rwkv6_3b,
    "zamba2-2.7b": zamba2_2_7b,
}

ARCH_NAMES: List[str] = list(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return reduce_for_smoke(get(name))
