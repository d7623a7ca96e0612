"""Architecture registry: ``get(name)`` -> full ArchConfig, ``get_smoke(name)``
-> the reduced same-family variant the CPU tests use.

The counterpart of :mod:`repro.configs.registry`, with all ten of its
architectures: the dense-GQA models (stablelm, mistral-nemo, gemma2, phi3),
the RG-LRU + local-attention hybrid recurrentgemma, the Mamba2 SSD model,
the MoE models grok-1 (GQA + MoE) and deepseek-v3 (MLA attention, dense
prefix layers, MoE with a shared expert), the audio encoder hubert and the
vision-language model internvl2 (their front ends take precomputed
features and patch embeddings, as the reference's).
"""
from __future__ import annotations

import importlib

#: the reference registry's architectures (``repro/configs/registry.py``)
ARCH_IDS = [
    "stablelm_1_6b",
    "internvl2_26b",
    "recurrentgemma_9b",
    "mistral_nemo_12b",
    "mamba2_130m",
    "phi3_medium_14b",
    "grok_1_314b",
    "gemma2_9b",
    "deepseek_v3_671b",
    "hubert_xlarge",
]

#: the ones the port runs: all of them
PORTED = list(ARCH_IDS)

# CLI aliases with dashes
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def all_configs():
    return {a: get(a) for a in PORTED}
