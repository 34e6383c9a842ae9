"""Config registry of the port: the paper's four edge models plus the
granite fixture every serve test scales down."""
from typing import Dict

from repro_torch.configs.edge_models import EDGE_MODELS
from repro_torch.configs.granite_3_8b import SPEC as GRANITE_3_8B
from repro_torch.core.model_config import ModelSpec

ASSIGNED: Dict[str, ModelSpec] = {GRANITE_3_8B.name: GRANITE_3_8B}
ARCHS: Dict[str, ModelSpec] = {**ASSIGNED, **EDGE_MODELS}


def get_arch(name: str) -> ModelSpec:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]
