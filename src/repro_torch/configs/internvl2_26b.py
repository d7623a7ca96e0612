"""internvl2-26b [vlm]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 -- InternViT + InternLM2  [arXiv:2404.16821]

Only the LANGUAGE backbone (InternLM2-20B) is modelled, as in the
reference; the InternViT-6B vision tower is a stub: ``launch/specs``
supplies precomputed patch embeddings (frontend_dim=3200 = InternViT
hidden) which the trainable projector maps into the LM embedding space and
prepends to the text tokens.
"""
from repro_torch.models.layers import AttnCfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    d_ff=16384,
    vocab=92553,
    attn=AttnCfg(kind="gqa", num_heads=48, num_kv_heads=8, head_dim=128,
                 rope_theta=1_000_000.0),
    block_pattern=("attn",),
    mlp_kind="dense",
    act="swiglu",
    tie_embeddings=False,
    frontend="vision",
    frontend_dim=3200,  # InternViT-6B hidden size
    long_mode="sliding",
    long_window=8192,
    citation="arXiv:2404.16821",
)

SMOKE = CONFIG.with_overrides(
    name="internvl2-smoke", n_layers=2, d_model=128, d_ff=384, vocab=512,
    attn=AttnCfg(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=32),
    frontend_dim=64,
    remat=False,
)
