"""Architecture registry for the port: every arch of ``repro.configs.registry``
— the three dense archs of the APC deployment, the ssm arch (rwkv6-3b), the
hybrid arch (zamba2-2.7b), qwen3-4b (dense, qk-norm), the moe archs
(granite-moe-1b-a400m, kimi-k2-1t-a32b), the vlm arch (qwen2-vl-7b) and the
audio arch (whisper-tiny) — and the port's own archs (``PORT_ONLY_ARCHS``),
which ``get`` and ``get_smoke`` resolve and ``ARCH_NAMES`` and
``all_cells()`` leave out. ``get(name)`` returns the full-size config,
``get_smoke(name)`` the reduced CPU-smoke variant, ``get_sharding(name,
kind)`` its deployment profile and ``all_cells()`` the (arch, shape) cells
of the assignment rules."""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs import (
    granite_moe_1b_a400m,
    kimi_k2_1t_a32b,
    nemotron_4_15b,
    nemotron_h_47b,
    olmo_1b,
    qwen2_5_3b,
    qwen2_vl_7b,
    qwen3_4b,
    rwkv6_3b,
    whisper_tiny,
    zamba2_2_7b,
)
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    ShardingProfile,
    reduce_for_smoke,
    supports_shape,
)

_MODULES = {
    "olmo-1b": olmo_1b,
    "nemotron-4-15b": nemotron_4_15b,
    "qwen2.5-3b": qwen2_5_3b,
    "rwkv6-3b": rwkv6_3b,
    "zamba2-2.7b": zamba2_2_7b,
    "qwen3-4b": qwen3_4b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "whisper-tiny": whisper_tiny,
}

ARCH_NAMES: List[str] = list(_MODULES)
# archs of the port alone, each with its reason: nemotron-h-47b is APC's
# large planner family in its hybrid Mamba-2/attention generation, which
# the benchmark measures and the reference does not model
PORT_ONLY_ARCHS: Tuple[str, ...] = ("nemotron-h-47b",)
_MODULES["nemotron-h-47b"] = nemotron_h_47b
# the reference registry's order of the same archs
_REFERENCE_ORDER = ("qwen3-4b", "olmo-1b", "nemotron-4-15b", "qwen2.5-3b", "rwkv6-3b",
                    "qwen2-vl-7b", "kimi-k2-1t-a32b", "granite-moe-1b-a400m",
                    "zamba2-2.7b", "whisper-tiny")


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list(_MODULES)}")
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return reduce_for_smoke(get(name))


def get_sharding(name: str, kind: str = "") -> ShardingProfile:
    """Deployment profile; per-shape-kind overrides via SHARDING_<KIND>
    module attrs (e.g. olmo's train profile drops TP, its serving profile
    keeps it)."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list(_MODULES)}")
    mod = _MODULES[name]
    if kind:
        return getattr(mod, f"SHARDING_{kind.upper()}", mod.SHARDING)
    return mod.SHARDING


def all_cells() -> List[Tuple[str, str]]:
    """All (arch, shape) cells per the assignment rules, in the
    reference's order (its registry lists the archs in another order)."""
    cells = []
    for arch in _REFERENCE_ORDER:
        cfg = get(arch)
        for shape_name, shp in SHAPES.items():
            if supports_shape(cfg, shp):
                cells.append((arch, shape_name))
    return cells


def shape(name: str) -> ShapeConfig:
    return SHAPES[name]
