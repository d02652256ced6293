"""Architecture registry for the port: the three dense archs of the APC
deployment. ``get(name)`` returns the full-size config, ``get_smoke(name)``
the reduced CPU-smoke variant."""

from __future__ import annotations

from typing import List

from repro_torch.configs import nemotron_4_15b, olmo_1b, qwen2_5_3b
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

_MODULES = {
    "olmo-1b": olmo_1b,
    "nemotron-4-15b": nemotron_4_15b,
    "qwen2.5-3b": qwen2_5_3b,
}

ARCH_NAMES: List[str] = list(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return reduce_for_smoke(get(name))
