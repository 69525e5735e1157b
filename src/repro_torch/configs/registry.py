"""Config registry: ``get(name)`` returns the exact assigned ArchConfig;
``reduced(name)`` returns the same-family CPU smoke-test variant.

Counterpart of `repro.configs.registry`, holding only the configurations
whose family the port builds (`PORTED`): the dense qwen2.5-3b and
qwen3-8b, and the MoE family's deepseek-v2-lite-16b (MLA) and
arctic-480b.  The reference's other ids are known here and raise
`NotImplementedError`; an unknown id raises `KeyError`, as in the
reference.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "arctic_480b",
    "deepseek_v2_lite_16b",
    "xlstm_125m",
    "qwen2_5_3b",
    "codeqwen1_5_7b",
    "granite_34b",
    "qwen3_8b",
    "whisper_large_v3",
    "zamba2_2_7b",
    "paligemma_3b",
)
PORTED = ("qwen2_5_3b", "qwen3_8b", "deepseek_v2_lite_16b", "arctic_480b")


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return name


def _module(name: str):
    cid = canonical(name)
    if cid not in PORTED:
        raise NotImplementedError(
            f"arch {cid!r} is not ported; the port builds {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{cid}")


def get(name: str):
    return _module(name).CONFIG


def reduced(name: str):
    return _module(name).REDUCED
