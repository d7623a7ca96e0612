"""hubert-xlarge [audio]  48L d_model=1280 16H d_ff=5120 vocab=504 --
encoder-only, same backbone as wav2vec2  [arXiv:2106.07447]

The mel-spectrogram + conv feature extractor is a stub, as the
reference's: ``launch/specs`` supplies precomputed frame embeddings
(frontend_dim=512, the conv-extractor output width).  Training objective is
HuBERT-style masked prediction over vocab=504 cluster targets.
Encoder-only: there is no decode step, and the serving engine refuses it.
"""
from repro_torch.models.layers import AttnCfg
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab=504,
    attn=AttnCfg(kind="gqa", num_heads=16, num_kv_heads=16, head_dim=80,
                 causal=False),
    block_pattern=("attn",),
    mlp_kind="dense",
    act="gelu",
    causal=False,
    tie_embeddings=False,  # separate 504-way prediction head
    frontend="audio",
    frontend_dim=512,  # conv feature-extractor output width
    long_mode="skip",
    decode_supported=False,
    citation="arXiv:2106.07447",
)

SMOKE = CONFIG.with_overrides(
    name="hubert-smoke", n_layers=2, d_model=128, d_ff=384, vocab=503,
    attn=AttnCfg(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=32,
                 causal=False),
    frontend_dim=64,
    remat=False,
)
