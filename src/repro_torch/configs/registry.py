"""Config registry: ``get(name)`` returns the exact assigned ArchConfig;
``reduced(name)`` returns the same-family CPU smoke-test variant.

Counterpart of `repro.configs.registry`.  `PORTED` names the
configurations whose family the port builds, which is every one of the
reference's: the dense qwen2.5-3b, qwen3-8b, codeqwen1.5-7b and
granite-34b (learned positions), the MoE family's deepseek-v2-lite-16b
(MLA) and arctic-480b, the VLM family's paligemma-3b, the hybrid
family's zamba2-2.7b, the audio family's whisper-large-v3 and the SSM
family's xlstm-125m.  An id outside `PORTED` raises
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
PORTED = ("qwen2_5_3b", "qwen3_8b", "codeqwen1_5_7b", "granite_34b",
          "deepseek_v2_lite_16b", "arctic_480b", "paligemma_3b",
          "zamba2_2_7b", "whisper_large_v3", "xlstm_125m")

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


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


def all_configs():
    return {n: get(n) for n in ARCH_IDS}
