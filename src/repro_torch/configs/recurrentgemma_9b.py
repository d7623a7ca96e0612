"""recurrentgemma-9b [hybrid]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 -- RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427]

38 layers = 12 x (rec, rec, local-attn) + (rec, rec) tail.  The tail is kept
out of the stacked periods (heterogeneous), matching the published block
layout.
"""
from repro_torch.models.layers import AttnCfg, RGLRUCfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    d_ff=12288,
    vocab=256000,
    attn=AttnCfg(kind="gqa", num_heads=16, num_kv_heads=1, head_dim=256,
                 rope_theta=10000.0),
    rglru=RGLRUCfg(width=4096, conv_width=4, c=8.0),
    block_pattern=("rec", "rec", "local"),
    suffix_blocks=("rec", "rec"),
    window_local=2048,   # Griffin local attention window
    mlp_kind="dense",
    prefix_mlp_kind="dense",
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    long_mode="native",  # recurrence + windowed attention: long_500k native
    citation="arXiv:2402.19427",
)

SMOKE = CONFIG.with_overrides(
    name="recurrentgemma-smoke", n_layers=3, d_model=128, d_ff=384, vocab=512,
    attn=AttnCfg(kind="gqa", num_heads=4, num_kv_heads=1, head_dim=32),
    rglru=RGLRUCfg(width=128, conv_width=4, c=8.0),
    suffix_blocks=(),
    window_local=64,
    remat=False,
)
