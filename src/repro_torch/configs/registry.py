"""Architecture registry: ``get(name)`` -> full ArchConfig, ``get_smoke(name)``
-> the reduced same-family variant the CPU tests use.

The counterpart of :mod:`repro.configs.registry` for the architectures the
port runs: the dense-GQA models (stablelm, mistral-nemo, gemma2, phi3), the
RG-LRU + local-attention hybrid recurrentgemma and the Mamba2 SSD model.
The reference's other four raise ``NotImplementedError``: grok-1 (its MoE
block) and deepseek-v3 (MoE and MLA attention) need blocks the port lacks,
hubert (audio) and internvl2 (vision) their front ends -- and hubert's head
dim of 80 is not one the flash kernels take.
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

#: the ones ported so far
PORTED = ["stablelm_1_6b", "mistral_nemo_12b", "gemma2_9b",
          "phi3_medium_14b", "recurrentgemma_9b", "mamba2_130m"]

# CLI aliases with dashes
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(ALIASES)}")
    if name not in PORTED:
        raise NotImplementedError(f"arch '{name}' is not ported yet; "
                                  f"ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def all_configs():
    return {a: get(a) for a in PORTED}
