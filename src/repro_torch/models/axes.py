"""The logical-axis specs of the model's params and caches.

The reference's ``init_*`` functions return ``(params, specs)``: ``specs``
mirrors the params tree with one tuple of logical axis names per leaf
(``("embed", "mlp")``, ``("layers", "expert", "embed", "expert_mlp")`` ...),
which :mod:`repro_torch.launch.sharding` resolves to mesh placements.  The
port's ``init_*`` return the params alone, so the specs are built here, leaf
for leaf in the reference's names, from the config alone: no params are
made.  :func:`param_specs` matches :func:`repro_torch.models.transformer.
init_model`'s tree and :func:`cache_specs` ``init_cache``'s.
"""
from __future__ import annotations

from repro_torch.models import transformer as T


def _attention(mcfg) -> dict:
    if mcfg.kind == "mla":
        return {"wq": ("embed", "heads", "qk_dim"),
                "w_dkv": ("embed", "kv_lora"),
                "w_uk": ("kv_lora", "heads", "qk_dim"),
                "w_uv": ("kv_lora", "heads", "v_dim"),
                "wo": ("heads", "v_dim", "embed")}
    return {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


def _rglru() -> dict:
    return {"w_x": ("embed", "rnn"), "w_gate": ("embed", "rnn"),
            "w_out": ("rnn", "embed"), "conv": ("conv", "rnn"),
            "w_a": ("rnn", "rnn"), "w_i": ("rnn", "rnn"), "lam": ("rnn",)}


def _mamba2() -> dict:
    return {"in_x": ("embed", "rnn"), "in_z": ("embed", "rnn"),
            "in_B": ("embed", "state"), "in_C": ("embed", "state"),
            "in_dt": ("embed", "heads"), "conv": ("conv", "rnn"),
            "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
            "out": ("rnn", "embed")}


def _mlp() -> dict:
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def _moe(mcfg) -> dict:
    s = {"router": ("embed", "expert"),
         "w_gate": ("expert", "embed", "expert_mlp"),
         "w_up": ("expert", "embed", "expert_mlp"),
         "w_down": ("expert", "expert_mlp", "embed")}
    if mcfg.num_shared:
        s["shared"] = _mlp()
    return s


def block_specs(cfg, kind: str, mlp_kind: str) -> dict:
    """Specs of one block (the reference's ``init_block``)."""
    mcfg = T._mixer_cfg(cfg, kind)
    mixer = {"rec": _rglru, "ssm": _mamba2}.get(kind)
    s = {"norm1": ("embed",),
         "mixer": mixer() if mixer is not None else _attention(mcfg)}
    if cfg.post_norm:
        s["post_norm1"] = ("embed",)
    if mlp_kind == "dense":
        s["norm2"] = ("embed",)
        s["mlp"] = _mlp()
    elif mlp_kind == "moe":
        s["norm2"] = ("embed",)
        s["moe"] = _moe(cfg.moe)
    if cfg.post_norm and mlp_kind != "none":
        s["post_norm2"] = ("embed",)
    return s


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def _lead(tree, axis: str):
    """Every spec of ``tree`` with ``axis`` prepended (the stacked
    periods' leading axis)."""
    if _is_spec(tree):
        return (axis,) + tree
    if isinstance(tree, dict):
        return {k: _lead(v, axis) for k, v in tree.items()}
    return [_lead(v, axis) for v in tree]


def param_specs(cfg) -> dict:
    """The logical-axis spec tree of ``init_model(gen, cfg)``'s params."""
    prefix, pattern, suffix = T._block_sequence(cfg)
    s = {"embed": ("vocab", "embed")}
    if cfg.frontend is not None:
        s["frontend_proj"] = ("none", "embed")
    for name, blocks in (("prefix", prefix), ("suffix", suffix)):
        if blocks:
            s[name] = [block_specs(cfg, kind, mk) for kind, mk in blocks]
    s["stack"] = _lead({f"b{j}": block_specs(cfg, kind, mk)
                        for j, (kind, mk) in enumerate(pattern)}, "layers")
    s["final_norm"] = ("embed",)
    if not cfg.tie_embeddings:
        s["unembed"] = ("embed", "vocab")
    return s


def _cache(kind: str, mcfg) -> dict:
    if kind == "rec":
        return {"h": ("batch", "rnn"), "conv": ("batch", "none", "rnn")}
    if kind == "ssm":
        return {"ssm": ("batch", "heads", "head_dim", "state"),
                "conv": ("batch", "none", "rnn")}
    if mcfg.kind == "mla":
        return {"ckv": ("batch", "cache_seq", "kv_lora"),
                "k_rope": ("batch", "cache_seq", "none")}
    return {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
            "v": ("batch", "cache_seq", "kv_heads", "head_dim")}


def cache_specs(cfg) -> dict:
    """The logical-axis spec tree of ``init_cache(cfg, ...)``'s buffers."""
    prefix, pattern, suffix = T._block_sequence(cfg)

    def one(kind):
        return _cache(kind, T._mixer_cfg(cfg, kind))

    return {"prefix": [one(kind) for kind, _ in prefix],
            "suffix": [one(kind) for kind, _ in suffix],
            "stack": _lead({f"b{j}": one(kind)
                            for j, (kind, _) in enumerate(pattern)},
                           "layers")}
