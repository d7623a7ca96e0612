"""mistral-nemo-12b [dense]  40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 -- 128k ctx  [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.models.layers import AttnCfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab=131072,
    attn=AttnCfg(kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128,
                 rope_theta=1_000_000.0),  # 128k-context rope base
    block_pattern=("attn",),
    mlp_kind="dense",
    act="swiglu",
    tie_embeddings=False,
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
)

SMOKE = CONFIG.with_overrides(
    name="mistral-nemo-smoke", n_layers=2, d_model=160, d_ff=448, vocab=512,
    attn=AttnCfg(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=40,
                 rope_theta=1_000_000.0),
    remat=False,
)
