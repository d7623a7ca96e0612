"""stablelm-1.6b [dense]  24L d_model=2048 32H (GQA kv=32) d_ff=5632
vocab=100352  [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.models.layers import AttnCfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    d_ff=5632,
    vocab=100352,
    attn=AttnCfg(kind="gqa", num_heads=32, num_kv_heads=32, head_dim=64,
                 rope_theta=10000.0),
    block_pattern=("attn",),
    mlp_kind="dense",
    act="swiglu",
    tie_embeddings=True,
    citation="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = CONFIG.with_overrides(
    name="stablelm-smoke", n_layers=2, d_model=128, d_ff=352, vocab=512,
    attn=AttnCfg(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=32),
    remat=False,
)
