"""Assigned architecture registry.

``get(name)`` -> exact ArchConfig; ``get_tiny(name)`` -> reduced same-family
config for CPU smoke tests; ``ALL_ARCHS`` lists the 10 assigned ids.
"""

from __future__ import annotations

import importlib
from typing import List

from ..config import ArchConfig

ALL_ARCHS: List[str] = [
    "grok-1-314b",
    "moonshot-v1-16b-a3b",
    "llama-3.2-vision-90b",
    "qwen2-1.5b",
    "granite-34b",
    "qwen2.5-14b",
    "minicpm-2b",
    "whisper-large-v3",
    "rwkv6-3b",
    "zamba2-1.2b",
]

_MODULES = {
    "grok-1-314b": "grok_1_314b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "qwen2-1.5b": "qwen2_1_5b",
    "granite-34b": "granite_34b",
    "qwen2.5-14b": "qwen2_5_14b",
    "minicpm-2b": "minicpm_2b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-1.2b": "zamba2_1_2b",
}


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def get_tiny(name: str) -> ArchConfig:
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.TINY
