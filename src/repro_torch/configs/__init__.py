"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the exact published configuration;
``smoke_config`` (base.py) derives the reduced CPU-test variant.
"""
from __future__ import annotations

from .base import (SHAPES, SUBQUADRATIC, ModelConfig, ShapeConfig,
                   resolve_for_tp, shape_applicable, smoke_config)
from .granite_moe_3b import CONFIG as granite_moe_3b
from .h2o_danube3_4b import CONFIG as h2o_danube3_4b
from .internvl2_26b import CONFIG as internvl2_26b
from .minicpm3_4b import CONFIG as minicpm3_4b
from .phi3_mini import CONFIG as phi3_mini
from .phi4_mini import CONFIG as phi4_mini
from .qwen3_moe_30b import CONFIG as qwen3_moe_30b
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .xlstm_350m import CONFIG as xlstm_350m

ARCHS = {
    c.name: c for c in [
        qwen3_moe_30b, granite_moe_3b, h2o_danube3_4b, minicpm3_4b,
        phi3_mini, phi4_mini, recurrentgemma_2b, seamless_m4t_medium,
        xlstm_350m, internvl2_26b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_configs() -> list[str]:
    return sorted(ARCHS)


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "ModelConfig", "ShapeConfig",
           "get_config", "get_shape", "list_configs", "resolve_for_tp",
           "shape_applicable", "smoke_config"]
