"""Architecture registry: ``--arch <id>`` resolution.

Arch ids use dashes (as assigned); module files use underscores.  Every
module exports ``CONFIG`` (the exact assigned configuration) and ``SMOKE``
(a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

ARCH_IDS: List[str] = [
    "gemma-2b",
    "qwen2.5-3b",
    "llama3.2-3b",
    "h2o-danube-3-4b",
    "internvl2-1b",
    "recurrentgemma-9b",
    "seamless-m4t-medium",
    "xlstm-1.3b",
    "qwen3-moe-235b-a22b",
    "llama4-scout-17b-a16e",
]


def _module_for(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(
        ".", "_")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_module_for(arch_id)).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_module_for(arch_id)).SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
