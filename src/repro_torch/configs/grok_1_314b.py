"""grok-1-314b [moe]  64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2  [hf:xai-org/grok-1]

Grok-1 applies tanh softcapping to attention logits (30) and final logits
(30).
"""
from repro_torch.models.layers import AttnCfg, MoECfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab=131072,
    attn=AttnCfg(kind="gqa", num_heads=48, num_kv_heads=8, head_dim=128,
                 rope_theta=10000.0, logit_softcap=30.0),
    moe=MoECfg(num_experts=8, top_k=2, d_ff_expert=32768, capacity_factor=1.25),
    block_pattern=("attn",),
    mlp_kind="moe",
    act="gelu",
    tie_embeddings=True,
    final_softcap=30.0,
    long_mode="sliding",
    long_window=8192,
    citation="hf:xai-org/grok-1",
)

SMOKE = CONFIG.with_overrides(
    name="grok-smoke", n_layers=2, d_model=128, d_ff=256, vocab=512,
    attn=AttnCfg(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=32,
                 logit_softcap=30.0),
    moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=256, capacity_factor=1.5),
    remat=False,
)
