"""Architecture registry: ``get_config("<arch-id>")`` for ``--arch`` flags.

The port's copy of the reference's registry, with the renderer's own
config (``lsgaussian``) as an extra id.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ArchConfig, ShapeSpec, SHAPES,
                                      shape_applicable)

# Dense MLA / dense GQA / dense GQA with a GELU MLP / fine-grained MoE.
ARCH_IDS = (
    "minicpm3-4b",
    "yi-9b",
    "starcoder2-7b",
    "moonshot-v1-16b-a3b",
)

EXTRA_IDS = ("lsgaussian",)


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_")


def get_config(arch_id: str):
    if arch_id.endswith("-smoke"):
        return get_config(arch_id[: -len("-smoke")]).reduced()
    if arch_id not in ARCH_IDS + EXTRA_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{ARCH_IDS + EXTRA_IDS}")
    return importlib.import_module(_module_name(arch_id)).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
