"""Config substrate: the four input shapes and which (arch, shape) pairs
run -- the port's copy of :mod:`repro.configs.base`.

``train`` is the federated train step (one round of Algorithm 1);
``prefill`` the prompt-processing forward; ``decode`` one new token against
a KV/state cache of ``seq_len`` tokens.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def shape_supported(cfg, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is runnable; the reason when it is not.

    Encoder-only models have no decode step; a model whose ``long_mode``
    is ``skip`` has no sub-quadratic variant for long_500k (the others run
    it through ``cfg.long_context_variant()``)."""
    if shape.kind == "decode" and not cfg.decode_supported:
        return False, f"{cfg.name} is encoder-only: no decode step"
    if shape.name == "long_500k" and cfg.long_mode == "skip":
        return False, f"{cfg.name} has no sub-quadratic long-context variant"
    return True, ""
