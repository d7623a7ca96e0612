"""phi3-medium-14b [dense]  40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 -- RoPE SwiGLU GQA  [arXiv:2404.14219]"""
from repro_torch.models.layers import AttnCfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    d_ff=17920,
    vocab=100352,
    attn=AttnCfg(kind="gqa", num_heads=40, num_kv_heads=10, head_dim=128,
                 rope_theta=10000.0),
    block_pattern=("attn",),
    mlp_kind="dense",
    act="swiglu",
    tie_embeddings=False,
    long_mode="sliding",
    long_window=8192,
    citation="arXiv:2404.14219",
)

SMOKE = CONFIG.with_overrides(
    name="phi3-smoke", n_layers=2, d_model=160, d_ff=560, vocab=512,
    attn=AttnCfg(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=40),
    remat=False,
)
