"""gemma2-9b [dense]  42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000
-- local+global alternating attention, logit softcapping  [arXiv:2408.00118]"""
from repro_torch.models.layers import AttnCfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab=256000,
    attn=AttnCfg(kind="gqa", num_heads=16, num_kv_heads=8, head_dim=256,
                 rope_theta=10000.0, logit_softcap=50.0),
    block_pattern=("local", "attn"),  # alternating sliding-window / global
    window_local=4096,
    mlp_kind="dense",
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    final_softcap=30.0,
    post_norm=True,   # gemma2 post-norms after attention and MLP outputs
    citation="arXiv:2408.00118",
)

SMOKE = CONFIG.with_overrides(
    name="gemma2-smoke", n_layers=2, d_model=128, d_ff=384, vocab=512,
    attn=AttnCfg(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=32,
                 logit_softcap=50.0),
    window_local=64,
    remat=False,
)
