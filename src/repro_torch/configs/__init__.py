"""Architecture registry (``repro.configs``): ``get(name)`` -> full
config, ``get_smoke(name)`` -> reduced same-family config for CPU tests.

The 10 LM architectures return a ``models.config.ModelConfig`` (their
files are the reference's data); the paper's own model (Instant-NGP +
ASDR, ``ingp_asdr``) is the 11th entry and returns an ``NGPBundle``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCHS: List[str] = [
    "gemma2_27b",
    "minitron_8b",
    "qwen3_14b",
    "gemma3_12b",
    "paligemma_3b",
    "whisper_medium",
    "dbrx_132b",
    "deepseek_moe_16b",
    "mamba2_780m",
    "hymba_1_5b",
]

# canonical spec names (shown in CLIs, dry-run records, EXPERIMENTS.md)
CANONICAL = {
    "gemma2_27b": "gemma2-27b",
    "minitron_8b": "minitron-8b",
    "qwen3_14b": "qwen3-14b",
    "gemma3_12b": "gemma3-12b",
    "paligemma_3b": "paligemma-3b",
    "whisper_medium": "whisper-medium",
    "dbrx_132b": "dbrx-132b",
    "deepseek_moe_16b": "deepseek-moe-16b",
    "mamba2_780m": "mamba2-780m",
    "hymba_1_5b": "hymba-1.5b",
}

ALIAS = {
    "gemma2-27b": "gemma2_27b",
    "minitron-8b": "minitron_8b",
    "qwen3-14b": "qwen3_14b",
    "gemma3-12b": "gemma3_12b",
    "paligemma-3b": "paligemma_3b",
    "whisper-medium": "whisper_medium",
    "dbrx-132b": "dbrx_132b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-780m": "mamba2_780m",
    "hymba-1.5b": "hymba_1_5b",
    "ingp-asdr": "ingp_asdr",
}


def _module(name: str):
    name = ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def list_archs() -> List[str]:
    return [CANONICAL[a] for a in ARCHS]
