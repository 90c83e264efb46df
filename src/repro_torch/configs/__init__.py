"""Architecture registry of the port.

``get(name)`` returns the full published config, ``get_smoke(name)`` a
reduced same-family config for CPU tests, as in ``repro/configs``;
``"shelby"`` names the storage deployment (``configs/shelby.py``).  Every
architecture of the JAX package is registered.
"""
from __future__ import annotations

import importlib

ALL_ARCHS = [
    "deepseek-v2-lite-16b",
    "qwen3-moe-30b-a3b",
    "hymba-1.5b",
    "falcon-mamba-7b",
    "whisper-tiny",
    "starcoder2-3b",
    "granite-8b",
    "yi-9b",
    "command-r-plus-104b",
    "phi-3-vision-4.2b",
]

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "qwen3-moe-30b-a3b": "qwen3_moe",
    "hymba-1.5b": "hymba",
    "falcon-mamba-7b": "falcon_mamba",
    "starcoder2-3b": "starcoder2",
    "granite-8b": "granite",
    "yi-9b": "yi",
    "command-r-plus-104b": "command_r_plus",
    "phi-3-vision-4.2b": "phi3_vision",
    "whisper-tiny": "whisper_tiny",
    "shelby": "shelby",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
