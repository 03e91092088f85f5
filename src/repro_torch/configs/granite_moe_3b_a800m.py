"""granite-moe-3b-a800m [moe], as ``repro/configs/granite_moe_3b_a800m.py``.
32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8."""
from repro_torch.configs.base import (ATTN, MOE, LSHConfig, ModelConfig,
                                      MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", d_model=1536,
        num_heads=24, num_kv_heads=8, d_ff=512, vocab_size=49155,
        head_dim=64, layout=((ATTN, MOE),), num_super_blocks=32,
        mlp_act="swiglu",
        moe=MoEConfig(num_experts=40, top_k=8, expert_ffn_dim=512,
                      lsh=LSHConfig(enabled=True)),
        pos_emb="rope", remat_policy="dots", kv_chunk=2048)


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=96, num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=515,
        num_super_blocks=2, head_dim=24,
        moe=MoEConfig(num_experts=6, top_k=2, expert_ffn_dim=64,
                      lsh=LSHConfig(enabled=True, num_hashes=3,
                                    rotation_dim=16, compression_rate=0.5)),
        kv_chunk=16)
