"""mamba2-130m [ssm]  24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality)  [arXiv:2405.21060]

Mamba2 blocks have no separate MLP (d_ff=0): the block IS the mixer.
expand=2 -> inner width 1536, head_dim 64 -> 24 SSD heads.
"""
from repro_torch.models.layers import SSMCfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab=50280,
    attn=None,
    ssm=SSMCfg(num_heads=24, head_dim=64, state_dim=128, conv_width=4,
               chunk=256, expand=2),
    block_pattern=("ssm",),
    mlp_kind="none",
    tie_embeddings=True,
    long_mode="native",  # constant-size recurrent state: long_500k is native
    citation="arXiv:2405.21060",
)

SMOKE = CONFIG.with_overrides(
    name="mamba2-smoke", n_layers=2, d_model=128, vocab=512,
    ssm=SSMCfg(num_heads=4, head_dim=64, state_dim=32, conv_width=4,
               chunk=32, expand=2),
    remat=False,
)
