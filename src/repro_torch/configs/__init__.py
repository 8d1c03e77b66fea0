"""Architecture registry: the 10 assigned configs + EPAC paper testbenches.

The port's own copy of ``repro.configs`` (data only, no JAX): the same
``ModelConfig`` schema, ``smoke()`` reduction, ``ARCH_IDS`` and
``get_config`` lookup, field for field.
"""

from __future__ import annotations

import importlib

from .base import LM_SHAPES, ModelConfig, ShapeCell

ARCH_IDS = (
    "xlstm_1_3b",
    "qwen2_vl_2b",
    "whisper_base",
    "yi_6b",
    "h2o_danube_3_4b",
    "gemma_7b",
    "olmo_1b",
    "kimi_k2_1t_a32b",
    "qwen3_moe_30b_a3b",
    "recurrentgemma_2b",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"{__name__}.{arch}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def get_cell(name: str) -> ShapeCell:
    for c in LM_SHAPES:
        if c.name == name:
            return c
    raise KeyError(name)
