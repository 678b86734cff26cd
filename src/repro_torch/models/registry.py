"""Architecture registry: ``--arch <id>`` -> config + model."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model


def _configs() -> Dict[str, ModelConfig]:
    from repro_torch.configs import CONFIGS  # local import: configs import models

    return CONFIGS


def _smoke_configs() -> Dict[str, ModelConfig]:
    from repro_torch.configs import SMOKE_CONFIGS

    return SMOKE_CONFIGS


def list_archs() -> List[str]:
    return sorted(_configs().keys())


def get_config(name: str, smoke: bool = False, **overrides) -> ModelConfig:
    table = _smoke_configs() if smoke else _configs()
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    cfg = table[name]
    return cfg.scaled(**overrides) if overrides else cfg


def build_model(cfg: ModelConfig, device=None, seed: int = 0,
                generator: Optional[torch.Generator] = None) -> Model:
    """The model on ``device`` (``cuda`` unless told otherwise), its
    weights drawn from ``generator`` or, without one, from a generator on
    that device seeded with ``seed``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, device).init_weights(generator)
