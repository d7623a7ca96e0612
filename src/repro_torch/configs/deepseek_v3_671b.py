"""deepseek-v3-671b [moe]  61L d_model=7168 128H d_ff=2048(expert)
vocab=129280 -- MLA latent attention, 1 shared + 256 routed experts top-8
[arXiv:2412.19437]

First 3 layers are dense (d_ff 18432); the remaining 58 are MLA + MoE.
MLA: kv_lora_rank=512, qk_nope=128, qk_rope=64, v=128 -> the decode cache
holds one 576-dim latent per token (not per head): ~24x KV compression,
which is what makes long_500k native for this arch.  Multi-token prediction
(MTP) is a training throughput add-on in the paper and is not reproduced
(nor is it in the reference).
"""
from repro_torch.models.layers import AttnCfg, MoECfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    d_ff=18432,  # dense prefix layers
    vocab=129280,
    attn=AttnCfg(kind="mla", num_heads=128, num_kv_heads=128, head_dim=128,
                 rope_theta=10000.0, kv_lora_rank=512, qk_nope_dim=128,
                 qk_rope_dim=64, v_dim=128),
    moe=MoECfg(num_experts=256, top_k=8, d_ff_expert=2048,
               num_shared=1, d_ff_shared=2048, capacity_factor=1.25),
    prefix_blocks=("attn", "attn", "attn"),
    prefix_mlp_kind="dense",
    block_pattern=("attn",),
    mlp_kind="moe",
    act="swiglu",
    tie_embeddings=False,
    long_mode="native",  # MLA latent cache
    citation="arXiv:2412.19437",
)

SMOKE = CONFIG.with_overrides(
    name="deepseek-smoke", n_layers=2, d_model=128, d_ff=256, vocab=512,
    attn=AttnCfg(kind="mla", num_heads=4, num_kv_heads=4, head_dim=32,
                 kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
    moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=64,
               num_shared=1, d_ff_shared=64, capacity_factor=1.5),
    prefix_blocks=("attn",),
    remat=False,
)
